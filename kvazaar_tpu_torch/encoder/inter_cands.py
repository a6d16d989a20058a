"""Merge and AMVP motion-vector candidate derivation (H.265 8.5.3.2.3 /
8.5.3.2.6), specialized to this build's v1 inter operating point:
2Nx2N PUs on a uniform CU grid, single reference list L0 with one
reference picture, temporal MVP disabled in the SPS.

Reference behavior: get_spatial_merge_candidates (src/inter.c:799),
kvz_inter_get_mv_cand (src/inter.c:1209).  Under a uniform grid the five
spatial neighbor PUs coincide with the five block-level neighbors whose
decode-order availability geometry.py already computes (L, A, AR, BL,
AL), so derivation is frame-wide vectorized numpy over the block grid —
used identically by the encoder's mode decisions and the oracle
decoder's MV reconstruction.
"""

from __future__ import annotations

import numpy as np

MAX_MERGE_CANDS = 5

# geometry.py avail order: L, A, AR, BL, AL.
_L, _A, _AR, _BL, _AL = range(5)


def _neighbor_fields(inter_map: np.ndarray, mv: np.ndarray,
                     avail: np.ndarray):
    """Per-block neighbor MV + validity for the 5 positions.

    inter_map: (By, Bx) bool; mv: (By, Bx, 2) int32; avail: (By, Bx, 5).
    Returns (vals: dict pos -> (By, Bx, 2), ok: dict pos -> (By, Bx)).
    """
    by, bx = inter_map.shape

    def shifted(dy, dx):
        # out[y, x] = mv[y+dy, x+dx] where in bounds.
        v = np.zeros((by, bx, 2), mv.dtype)
        i = np.zeros((by, bx), bool)
        ys0, ys1 = max(0, -dy), min(by, by - dy)
        xs0, xs1 = max(0, -dx), min(bx, bx - dx)
        v[ys0:ys1, xs0:xs1] = mv[ys0 + dy:ys1 + dy, xs0 + dx:xs1 + dx]
        i[ys0:ys1, xs0:xs1] = inter_map[ys0 + dy:ys1 + dy,
                                        xs0 + dx:xs1 + dx]
        return v, i

    deltas = {_L: (0, -1), _A: (-1, 0), _AR: (-1, 1), _BL: (1, -1),
              _AL: (-1, -1)}
    vals, ok = {}, {}
    for pos, (dy, dx) in deltas.items():
        v, i = shifted(dy, dx)
        vals[pos] = v
        ok[pos] = i & avail[:, :, pos]
    return vals, ok


def merge_candidates(inter_map: np.ndarray, mv: np.ndarray,
                     avail: np.ndarray):
    """Frame-wide merge candidate lists.

    Returns (cands: (By, Bx, 5, 2) int32, count is always 5 — the list
    is zero-filled per spec so all 5 indices are codable)."""
    by, bx = inter_map.shape
    vals, ok = _neighbor_fields(inter_map, mv, avail)

    # Spatial order with pruning (each against the MOTION of the listed
    # earlier neighbor, regardless of whether that one was added):
    # A1(L); B1(A) vs A1; B0(AR) vs B1; A0(BL) vs A1; B2(AL) vs A1 and
    # B1, only when the first four didn't all make it.
    a1, a1ok = vals[_L], ok[_L]
    b1, b1ok = vals[_A], ok[_A]
    b0, b0ok = vals[_AR], ok[_AR]
    a0, a0ok = vals[_BL], ok[_BL]
    b2, b2ok = vals[_AL], ok[_AL]

    use = np.zeros((by, bx, 5), bool)
    use[:, :, 0] = a1ok
    use[:, :, 1] = b1ok & (~a1ok | np.any(b1 != a1, axis=-1))
    use[:, :, 2] = b0ok & (~b1ok | np.any(b0 != b1, axis=-1))
    use[:, :, 3] = a0ok & (~a1ok | np.any(a0 != a1, axis=-1))
    n4 = use[:, :, :4].sum(axis=-1)
    use[:, :, 4] = (b2ok & (n4 < 4)
                    & (~a1ok | np.any(b2 != a1, axis=-1))
                    & (~b1ok | np.any(b2 != b1, axis=-1)))

    # Compact the used candidates in order, zero-fill the rest.
    cands = np.zeros((by, bx, MAX_MERGE_CANDS, 2), np.int32)
    src = np.stack([a1, b1, b0, a0, b2], axis=2)   # (By, Bx, 5, 2)
    slot = np.zeros((by, bx), np.int64)
    for k in range(5):
        u = use[:, :, k]
        iy, ix = np.nonzero(u)
        cands[iy, ix, slot[iy, ix]] = src[iy, ix, k]
        slot[iy, ix] += 1
    return cands


def amvp_candidates(inter_map: np.ndarray, mv: np.ndarray,
                    avail: np.ndarray):
    """Frame-wide AMVP (mvp) candidate pairs: (By, Bx, 2, 2) int32.

    Single same-POC-distance reference: candidate A = first inter of
    [A0, A1]; B = first inter of [B0, B1, B2]; prune B == A; zero-fill.
    """
    by, bx = inter_map.shape
    vals, ok = _neighbor_fields(inter_map, mv, avail)

    a_ok = ok[_BL] | ok[_L]
    a = np.where(ok[_BL][..., None], vals[_BL], vals[_L])
    b_ok = ok[_AR] | ok[_A] | ok[_AL]
    b = np.where(ok[_AR][..., None], vals[_AR],
                 np.where(ok[_A][..., None], vals[_A], vals[_AL]))

    out = np.zeros((by, bx, 2, 2), np.int32)
    # slot 0: A if available else B (if != handled below) else zero.
    out[:, :, 0] = np.where(a_ok[..., None], a,
                            np.where(b_ok[..., None], b, 0))
    b_differs = np.any(b != a, axis=-1) | ~a_ok
    second_ok = b_ok & a_ok & b_differs
    out[:, :, 1] = np.where(second_ok[..., None], b, 0)
    # When the first filled slot was B (no A) the second stays zero,
    # and zero-fill is the spec's fallback either way.
    return out


def pu_cell_rects(by8: int, bx8: int, cells: int, part: int):
    """PU rectangles in 8-cells (y, x, h, w), decode order, for a CU
    at (by8, bx8).  part: HEVC PartMode (0, 1=2NxN, 2=Nx2N,
    4=2NxnU, 5=2NxnD, 6=nLx2N, 7=nRx2N)."""
    h = cells // 2
    q = max(cells // 4, 1)
    if part == 1:
        return [(by8, bx8, h, cells), (by8 + h, bx8, cells - h, cells)]
    if part == 2:
        return [(by8, bx8, cells, h), (by8, bx8 + h, cells, cells - h)]
    if part == 4:
        return [(by8, bx8, q, cells), (by8 + q, bx8, cells - q, cells)]
    if part == 5:
        return [(by8, bx8, cells - q, cells),
                (by8 + cells - q, bx8, q, cells)]
    if part == 6:
        return [(by8, bx8, cells, q), (by8, bx8 + q, cells, cells - q)]
    if part == 7:
        return [(by8, bx8, cells, cells - q),
                (by8, bx8 + cells - q, cells, q)]
    return [(by8, bx8, cells, cells)]
