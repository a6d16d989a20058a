"""Exact integer products for HEVC's small integer matrices.

The JAX package forms every integer matmul as bf16 products with f32
accumulation, exact because its operands and partial sums are bounded
(kvazaar_tpu/ops/exactmm.py).  PyTorch needs another route:

- ``torch.matmul``/``einsum`` on int32/int64 CUDA tensors is not
  implemented and raises, and on the CPU it has no BLAS kernel, so
  the 32x32 mode searches of variable CU trees crawl;
- float32 is not exact everywhere: the forward DCT's second stage
  reaches about 2^15 * 90 * 16 > 2^24.

So the one helper here contracts in float64 on every device.  float64
holds every integer below 2^53 exactly, far above any HEVC partial sum
(< 2^31), so every product and partial sum is exact in any order and
no TF32 or rounding question arises.
"""

from __future__ import annotations

import torch


def matmul_exact(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ b`` (batch axes broadcast) over integer tensors (or
    float64 tables of integers); returns int32, as every caller's result
    fits (as in the JAX package)."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    if a.dim() == 2 and b.dim() > 2:
        # A matrix times a batch: (b^T a^T)^T folds the batch into the
        # rows of one GEMM, where torch.matmul would expand the matrix
        # into a batched product of many small matrices.
        return torch.matmul(b.mT, a.mT).mT.to(torch.int32)
    return torch.matmul(a, b).to(torch.int32)
