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


_DELTAS = {_L: (0, -1), _A: (-1, 0), _AR: (-1, 1), _BL: (1, -1),
           _AL: (-1, -1)}


def _nbr_mv(inter_map, mv, avail, by, bx, pos):
    """Scalar neighbor MV or None (decode-order availability + inter)."""
    if not avail[by, bx, pos]:
        return None
    dy, dx = _DELTAS[pos]
    ny, nx = by + dy, bx + dx
    if not inter_map[ny, nx]:
        return None
    return (int(mv[ny, nx, 0]), int(mv[ny, nx, 1]))


def merge_list_at(inter_map, mv, avail, by, bx):
    """Scalar merge list for one block (decode-order sequential use by
    the decoder; must match merge_candidates exactly — tested)."""
    a1 = _nbr_mv(inter_map, mv, avail, by, bx, _L)
    b1 = _nbr_mv(inter_map, mv, avail, by, bx, _A)
    b0 = _nbr_mv(inter_map, mv, avail, by, bx, _AR)
    a0 = _nbr_mv(inter_map, mv, avail, by, bx, _BL)
    b2 = _nbr_mv(inter_map, mv, avail, by, bx, _AL)
    out = []
    if a1 is not None:
        out.append(a1)
    if b1 is not None and b1 != a1:
        out.append(b1)
    if b0 is not None and b0 != b1:
        out.append(b0)
    if a0 is not None and a0 != a1:
        out.append(a0)
    if len(out) < 4 and b2 is not None and b2 != a1 and b2 != b1:
        out.append(b2)
    while len(out) < MAX_MERGE_CANDS:
        out.append((0, 0))
    return out


def _mv_scale(mvc, tb: int, td: int):
    """Temporal MV scaling (8.5.3.2.8): scale mvc coded against a ref
    `td` pics away onto a ref `tb` pics away."""
    td = max(-128, min(127, td))
    tb = max(-128, min(127, tb))
    q = 16384 + (abs(td) >> 1)
    tx = (q // abs(td)) * (1 if td > 0 else -1)     # trunc toward zero
    dsf = max(-4096, min(4095, (tb * tx + 32) >> 6))

    def sc(v):
        p = dsf * int(v)
        s = 1 if p >= 0 else -1
        return max(-32768, min(32767, s * ((abs(p) + 127) >> 8)))

    return (sc(mvc[0]), sc(mvc[1]))


def amvp_pair_at(inter_map, mv, avail, by, bx):
    a = _nbr_mv(inter_map, mv, avail, by, bx, _BL)
    if a is None:
        a = _nbr_mv(inter_map, mv, avail, by, bx, _L)
    b = _nbr_mv(inter_map, mv, avail, by, bx, _AR)
    if b is None:
        b = _nbr_mv(inter_map, mv, avail, by, bx, _A)
    if b is None:
        b = _nbr_mv(inter_map, mv, avail, by, bx, _AL)
    out = []
    if a is not None:
        out.append(a)
    if b is not None and (a is None or b != a):
        out.append(b)
    while len(out) < 2:
        out.append((0, 0))
    # Match amvp_candidates: when A is missing, B fills slot 0.
    return out


def temporal_candidate_at(tctx, x0: int, y0: int, s: int,
                          tgt_poc: int):
    """Scaled temporal MV candidate (8.5.3.2.8) or None.

    tctx: dict with the collocated picture's motion — poc, cu (its CU
    grid size), inter (By, Bx), mv (By, Bx, 2), refpoc (By, Bx), plus
    the current picture's poc and coded w/h.  Sampling at 16-aligned
    positions, H (bottom-right, unavailable on a CTU-row boundary)
    with C3 (center) fallback — the reference's
    get_temporal_merge_candidates (src/inter.c:713-780) +
    add_temporal_candidate scaling (src/inter.c:1001-1062)."""
    if tctx is None or tctx.get("inter") is None:
        return None
    cs = tctx["cu"]
    poc = tctx["cur_poc"]

    def sample(x, y):
        if x >= tctx["w"] or y >= tctx["h"]:
            return None
        cyy = ((y >> 4) << 4) // cs
        cxx = ((x >> 4) << 4) // cs
        if not tctx["inter"][cyy, cxx]:
            return None
        v = (int(tctx["mv"][cyy, cxx, 0]),
             int(tctx["mv"][cyy, cxx, 1]))
        td = tctx["poc"] - int(tctx["refpoc"][cyy, cxx])
        tb = poc - tgt_poc
        if td == 0:
            return None
        return v if td == tb else _mv_scale(v, tb, td)

    xbr, ybr = x0 + s, y0 + s
    if xbr < tctx["w"] and ybr < tctx["h"] and ybr % 64 != 0:
        r = sample(xbr, ybr)
        if r is not None:
            return r
    return sample(x0 + s // 2, y0 + s // 2)


def merge_list_p_multiref_at(inter_map, refs, mv, avail, by, bx,
                             nref: int, tctx=None, ref_pocs=None,
                             cu: int = 0):
    """Scalar P merge list with multiple L0 references: 5 tuples
    (ref_idx, (mx, my)).  Spatial candidates carry the neighbor's
    (ref_idx, mv); then the temporal candidate (target refIdx 0,
    8.5.3.2.3 step 10) when TMVP is on; zero candidates cycle
    ref_idx 0..nref-1 (8.5.3.2.5).  Shared by encoder decision and
    oracle decoder."""

    def nbr(pos):
        if not avail[by, bx, pos]:
            return None
        dy, dx = _DELTAS[pos]
        ny, nx = by + dy, bx + dx
        if not inter_map[ny, nx]:
            return None
        return (int(refs[ny, nx]),
                (int(mv[ny, nx, 0]), int(mv[ny, nx, 1])))

    a1 = nbr(_L)
    b1 = nbr(_A)
    b0 = nbr(_AR)
    a0 = nbr(_BL)
    b2 = nbr(_AL)
    out = []
    if a1 is not None:
        out.append(a1)
    if b1 is not None and b1 != a1:
        out.append(b1)
    if b0 is not None and b0 != b1:
        out.append(b0)
    if a0 is not None and a0 != a1:
        out.append(a0)
    if len(out) < 4 and b2 is not None and b2 != a1 and b2 != b1:
        out.append(b2)
    if tctx is not None and len(out) < MAX_MERGE_CANDS:
        t = temporal_candidate_at(tctx, bx * cu, by * cu, cu,
                                  ref_pocs[0])
        if t is not None:
            out.append((0, t))
    zero_idx = 0
    while len(out) < MAX_MERGE_CANDS:
        r = zero_idx if zero_idx < nref else 0
        out.append((r, (0, 0)))
        zero_idx += 1
    return out


def amvp_pair_p_multiref_at(inter_map, refs, mv, avail, by, bx,
                            tgt_ref: int, poc: int, ref_pocs,
                            tctx=None, cu: int = 0):
    """AMVP pair for one PU of a P slice with multiple L0 references
    (8.5.3.2.6/8.5.3.2.7 restricted to one list, TMVP off): same-ref
    neighbors first, then POC-scaled; isScaledFlag re-derivation when
    no left neighbor PU exists."""
    tgt_poc = ref_pocs[tgt_ref]

    def nbr(pos):
        if not avail[by, bx, pos]:
            return None
        dy, dx = _DELTAS[pos]
        ny, nx = by + dy, bx + dx
        if not inter_map[ny, nx]:
            return None
        return (int(refs[ny, nx]),
                (int(mv[ny, nx, 0]), int(mv[ny, nx, 1])))

    def same_ref(positions):
        for pos in positions:
            n = nbr(pos)
            if n is None:
                continue
            r, v = n
            if ref_pocs[r] == tgt_poc:
                return v
        return None

    def scaled(positions):
        for pos in positions:
            n = nbr(pos)
            if n is None:
                continue
            r, v = n
            td = poc - ref_pocs[r]
            tb = poc - tgt_poc
            if td == 0:
                continue
            return v if td == tb else _mv_scale(v, tb, td)
        return None

    a_positions = (_BL, _L)
    b_positions = (_AR, _A, _AL)
    a_pu_present = any(nbr(p) is not None for p in a_positions)
    a = same_ref(a_positions)
    if a is None and a_pu_present:
        a = scaled(a_positions)
    b = same_ref(b_positions)
    if not a_pu_present:
        if a is None:
            a = b
            b = scaled(b_positions)
            if b == a:
                b = None
    out = []
    if a is not None:
        out.append(a)
    if b is not None and (a is None or b != a):
        out.append(b)
    # Temporal candidate when fewer than 2 spatial ones (8.5.3.2.6
    # step 8 — appended without dedup against the spatial entries).
    if tctx is not None and len(out) < 2:
        t = temporal_candidate_at(tctx, bx * cu, by * cu, cu, tgt_poc)
        if t is not None:
            out.append(t)
    while len(out) < 2:
        out.append((0, 0))
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
