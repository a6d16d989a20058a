"""Exact integer products for HEVC's small integer matrices.

The JAX package forms every integer matmul as bf16 products with f32
accumulation, exact because its operands and partial sums are bounded
(kvazaar_tpu/ops/exactmm.py).  PyTorch needs another route:

- ``torch.matmul``/``einsum`` on int32/int64 CUDA tensors is not
  implemented and raises;
- float32 is not exact everywhere: the forward DCT's second stage
  reaches about 2^15 * 90 * 16 > 2^24.

So the one helper here contracts in int64 on the CPU and in float64 on
CUDA.  float64 holds every integer below 2^53 exactly, far above any
HEVC partial sum (< 2^31), so no TF32 or rounding question arises.
"""

from __future__ import annotations

import torch


def einsum_exact(spec: str, a: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Exact ``torch.einsum(spec, a, b)`` over integer tensors; returns
    int32 (every caller's result fits, as in the JAX package)."""
    if a.device.type == "cuda":
        r = torch.einsum(spec, a.to(torch.float64), b.to(torch.float64))
        return r.to(torch.int32)
    return torch.einsum(spec, a.to(torch.int64),
                        b.to(torch.int64)).to(torch.int32)
