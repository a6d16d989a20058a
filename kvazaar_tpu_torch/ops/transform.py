"""Exact-integer HEVC DCT (H.265 8.6.4.2), batched over (..., N, N).

Counterpart of kvazaar_tpu/ops/transform.py (DCT only; the 4x4 DST
waits for the intra-NxN path).  The transform matrices are the
standard's integer tables, generated from the odd-row magnitudes plus
the DCT-II even/odd recursion exactly as the JAX package does
(``dct_matrix_np`` is a copy; a test pins it against the original).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from kvazaar_tpu_torch.ops.exactmm import matmul_exact

# Odd-row magnitude constants per transform size (H.265 8.6.4.2 tables).
_ODD_MAGS = {
    2: [64],
    4: [83, 36],
    8: [89, 75, 50, 18],
    16: [90, 87, 80, 70, 57, 43, 25, 9],
    32: [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4],
}


@functools.lru_cache(maxsize=None)
def dct_matrix_np(n: int) -> np.ndarray:
    """The NxN integer DCT table of H.265 (rows = frequencies)."""
    if n == 1:
        return np.array([[64]], dtype=np.int32)
    half = dct_matrix_np(n // 2)
    t = np.zeros((n, n), dtype=np.int64)
    t[0::2, : n // 2] = half
    t[0::2, n // 2:] = half[:, ::-1] * (
        np.where(np.arange(0, n, 2) % 2 == 0, 1, -1)[:, None]
    )
    mags = _ODD_MAGS[n]
    for k in range(1, n, 2):
        for x in range(n):
            u = k * (2 * x + 1)  # angle in units of pi/(2N)
            sign = 1 if math.cos(u * math.pi / (2 * n)) >= 0 else -1
            v = u % (4 * n)
            if v >= 2 * n:
                v = 4 * n - v
            w = v if v <= n else 2 * n - v  # odd, in 1..n-1
            t[k, x] = sign * mags[(w - 1) // 2]
    return t.astype(np.int32)


def _round_shift(x, shift):
    return (x + (1 << (shift - 1))) >> shift


def _clip16(x):
    return torch.clamp(x, -32768, 32767)


@functools.lru_cache(maxsize=None)
def _matrix(size: int, device: torch.device) -> torch.Tensor:
    """The DCT table on ``device`` in float64 (matmul_exact's dtype)."""
    return torch.from_numpy(dct_matrix_np(size)).to(device, torch.float64)


def forward_transform(resid: torch.Tensor, size: int,
                      bitdepth: int = 8) -> torch.Tensor:
    """resid: (..., size, size) integer residual -> int32 coefficients.
    Stage 1 transforms columns (T @ X), stage 2 rows (. @ T^T), with
    shift1 = log2N + bd - 9 and shift2 = log2N + 6."""
    log2n = size.bit_length() - 1
    t = _matrix(size, resid.device)
    e = _round_shift(matmul_exact(t, resid), log2n + bitdepth - 9)
    return _round_shift(matmul_exact(e, t.mT), log2n + 6)


def inverse_transform(coeff: torch.Tensor, size: int,
                      bitdepth: int = 8) -> torch.Tensor:
    """Inverse 2D DCT; both stages clipped to int16 (shift1 = 7,
    shift2 = 20 - bitdepth)."""
    t = _matrix(size, coeff.device)
    e = _clip16(_round_shift(matmul_exact(t.mT, coeff), 7))
    return _clip16(_round_shift(matmul_exact(e, t), 20 - bitdepth))
