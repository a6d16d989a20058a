"""Coefficient scan orders (H.265 6.5.3).

The reference ships these as generated tables (src/tables.c, generated by
tools/generate_tables.c); we generate them at import time.

scan order index: 0 = up-right diagonal, 1 = horizontal, 2 = vertical
(matching the spec's scanIdx used in residual coding).
"""

from __future__ import annotations

import functools

import numpy as np

SCAN_DIAG = 0
SCAN_HOR = 1
SCAN_VER = 2


@functools.lru_cache(maxsize=None)
def scan_order(size: int, scan_idx: int) -> np.ndarray:
    """(size*size, 2) array of (x, y) positions in scan order (DC first)."""
    pos = []
    if scan_idx == SCAN_HOR:
        for y in range(size):
            for x in range(size):
                pos.append((x, y))
    elif scan_idx == SCAN_VER:
        for x in range(size):
            for y in range(size):
                pos.append((x, y))
    else:  # up-right diagonal: within a diagonal x increases, y decreases
        for d in range(2 * size - 1):
            y = min(d, size - 1)
            x = d - y
            while y >= 0 and x < size:
                pos.append((x, y))
                x += 1
                y -= 1
    return np.array(pos, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def coeff_scan(log2_size: int, scan_idx: int) -> np.ndarray:
    """Full-TB coefficient scan as (nCoeff, 2) (x, y), DC first.

    For TBs larger than 4x4 the scan is hierarchical: the (N/4)x(N/4) grid
    of 4x4 subblocks is scanned with `scan_idx`, and coefficients inside
    each subblock use the same `scan_idx` 4x4 pattern.
    """
    size = 1 << log2_size
    if size == 4:
        return scan_order(4, scan_idx)
    sub = scan_order(size // 4, scan_idx)
    inner = scan_order(4, scan_idx)
    out = []
    for sx, sy in sub:
        for ix, iy in inner:
            out.append((sx * 4 + ix, sy * 4 + iy))
    return np.array(out, dtype=np.int32)


def intra_scan_idx(pred_mode: int, log2_size: int, is_chroma: bool) -> int:
    """Mode-dependent scan selection (H.265 7.4.9.11): 4x4 and 8x8 luma
    (4x4 chroma) intra TBs use vertical scan for near-horizontal modes
    6..14 and horizontal scan for near-vertical modes 22..30."""
    if log2_size == 2 or (log2_size == 3 and not is_chroma):
        if 6 <= pred_mode <= 14:
            return SCAN_VER
        if 22 <= pred_mode <= 30:
            return SCAN_HOR
    return SCAN_DIAG
