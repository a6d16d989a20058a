"""Exact-integer HEVC transforms (H.265 8.6.4.2), batched over (..., N, N).

Counterpart of kvazaar_tpu/ops/transform.py: the DCT at every size and
the 4x4 DST-VII of intra luma TBs (the intra-NxN operating point).  The
DCT matrices are the standard's integer tables, generated from the
odd-row magnitudes plus the DCT-II even/odd recursion exactly as the JAX
package does (``dct_matrix_np`` is a copy; a test pins it and the DST
table against the originals).
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


_DST4 = np.array([[29, 55, 74, 84],
                  [74, 74, 0, -74],
                  [84, -29, -74, 55],
                  [55, -84, 74, -29]], dtype=np.int32)


def dst4_matrix_np() -> np.ndarray:
    """The 4x4 integer DST-VII table of H.265 (8.6.4.2, rows =
    frequencies)."""
    return _DST4.copy()


def _round_shift(x, shift):
    return (x + (1 << (shift - 1))) >> shift


def _clip16(x):
    return torch.clamp(x, -32768, 32767)


@functools.lru_cache(maxsize=None)
def _matrix(size: int, device: torch.device, dst: bool = False
            ) -> torch.Tensor:
    """The DCT (or, dst, the 4x4 DST-VII) table on ``device`` in float64
    (matmul_exact's dtype)."""
    t = dst4_matrix_np() if dst else dct_matrix_np(size)
    return torch.from_numpy(t).to(device, torch.float64)


def forward_transform(resid: torch.Tensor, size: int, bitdepth: int = 8,
                      dst: bool = False) -> torch.Tensor:
    """resid: (..., size, size) integer residual -> int32 coefficients.
    Stage 1 transforms columns (T @ X), stage 2 rows (. @ T^T), with
    shift1 = log2N + bd - 9 and shift2 = log2N + 6; dst: the DST-VII
    table (size 4)."""
    log2n = size.bit_length() - 1
    t = _matrix(size, resid.device, dst)
    e = _round_shift(matmul_exact(t, resid), log2n + bitdepth - 9)
    return _round_shift(matmul_exact(e, t.mT), log2n + 6)


def inverse_transform(coeff: torch.Tensor, size: int, bitdepth: int = 8,
                      dst: bool = False) -> torch.Tensor:
    """Inverse 2D DCT (dst: DST-VII); both stages clipped to int16
    (shift1 = 7, shift2 = 20 - bitdepth)."""
    t = _matrix(size, coeff.device, dst)
    e = _clip16(_round_shift(matmul_exact(t.mT, coeff), 7))
    return _clip16(_round_shift(matmul_exact(e, t), 20 - bitdepth))
