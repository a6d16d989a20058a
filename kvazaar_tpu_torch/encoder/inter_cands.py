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


# Table 8-8: combined bi-predictive merge candidate (l0CandIdx,
# l1CandIdx) order.
_COMB_ORDER = ((0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1),
               (0, 3), (3, 0), (1, 3), (3, 1), (2, 3), (3, 2))


def merge_list_b_at(inter_map, dirs, mv0, mv1, avail, by, bx,
                    ref_poc: tuple):
    """Scalar B merge list for one block: 5 tuples (dir, (mx0, my0),
    (mx1, my1)) with unused-list MVs normalized to (0, 0).

    Spatial candidates carry the neighbor's full motion (8.5.3.2.3),
    then combined bi-predictive candidates (8.5.3.2.4, Table 8-8) and
    zero candidates (8.5.3.2.5).  One reference per list, TMVP off.
    Matches the reference's get_spatial_merge_candidates +
    kvz_inter_get_merge_cand (src/inter.c:799,1130) for this operating
    point; shared verbatim by encoder decision and oracle decoder."""

    def nbr(pos):
        if not avail[by, bx, pos]:
            return None
        dy, dx = _DELTAS[pos]
        ny, nx = by + dy, bx + dx
        if not inter_map[ny, nx]:
            return None
        d = int(dirs[ny, nx])
        m0 = ((int(mv0[ny, nx, 0]), int(mv0[ny, nx, 1]))
              if d != 1 else (0, 0))
        m1 = ((int(mv1[ny, nx, 0]), int(mv1[ny, nx, 1]))
              if d != 0 else (0, 0))
        return (d, m0, m1)

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

    # Combined bi-predictive candidates.
    n_orig = len(out)
    if n_orig >= 2:
        for (i0, i1) in _COMB_ORDER[:n_orig * (n_orig - 1)]:
            if len(out) >= MAX_MERGE_CANDS:
                break
            if i0 >= n_orig or i1 >= n_orig:
                continue
            d0, m00, _ = out[i0]
            d1, _, m11 = out[i1]
            if d0 == 1 or d1 == 0:     # need predFlagL0 / predFlagL1
                continue
            if ref_poc[0] != ref_poc[1] or m00 != m11:
                out.append((2, m00, m11))

    while len(out) < MAX_MERGE_CANDS:
        out.append((2, (0, 0), (0, 0)))
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


def amvp_pair_b_at(inter_map, dirs, mv0, mv1, avail, by, bx, lst: int,
                   poc: int, ref_poc: tuple):
    """AMVP pair for one PU of a B slice, target list `lst`
    (8.5.3.2.6/8.5.3.2.7, one reference per list, TMVP off).

    dirs: (By, Bx) 0=L0/1=L1/2=BI; mv0/mv1 per-list MV fields;
    ref_poc = (poc_l0, poc_l1).  Shared verbatim by the encoder's mvd
    derivation and the oracle decoder's MV reconstruction."""
    tgt_poc = ref_poc[lst]
    mvs = (mv0, mv1)

    def nbr(pos):
        if not avail[by, bx, pos]:
            return None
        dy, dx = _DELTAS[pos]
        ny, nx = by + dy, bx + dx
        if not inter_map[ny, nx]:
            return None
        d = int(dirs[ny, nx])
        uses = [l for l in (lst, 1 - lst)
                if (d == 2 or d == l)]
        return [(l, (int(mvs[l][ny, nx, 0]), int(mvs[l][ny, nx, 1])))
                for l in uses]

    def same_ref(positions):
        for pos in positions:
            n = nbr(pos)
            if n is None:
                continue
            for (l, v) in n:
                if ref_poc[l] == tgt_poc:
                    return v
        return None

    def scaled(positions):
        for pos in positions:
            n = nbr(pos)
            if n is None:
                continue
            for (l, v) in n:
                td = poc - ref_poc[l]
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
        # isScaledFlag == 0: B's same-ref result takes A's slot and B
        # is re-derived allowing scaling (8.5.3.2.7).
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
    while len(out) < 2:
        out.append((0, 0))
    return out


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


# ---------------------------------------------------------------------
# PU-level derivation (SMP: PART_2NxN / PART_Nx2N) on the 8x8 cell
# grid — the reference's per-PU neighbor positions
# (get_spatial_merge_candidates, src/inter.c:799) with the prediction-
# block availability rules of 6.4.2 (same-CU neighbors unavailable,
# z-scan decode-order precedence otherwise).
# ---------------------------------------------------------------------

def _cu_decode_key(cy8: int, cx8: int, cu_cells: int):
    """Decode-order key of the CU containing 8-cell (cy8, cx8):
    (CTU raster index, z index within the CTU)."""
    from kvazaar_tpu_torch.encoder.geometry import z_order_index
    ctu_y, ctu_x = cy8 // 8, cx8 // 8
    zy = (cy8 % 8) // cu_cells
    zx = (cx8 % 8) // cu_cells
    return (ctu_y, ctu_x, z_order_index(zx, zy))


def _pu_nbr(inter8, mv8, ny: int, nx: int, cur_key, cu_cells: int,
            ref8=None):
    """Motion of the PU covering cell (ny, nx), or None (availability:
    inside picture, decoded before the current CU, not in the current
    CU — 6.4.2 — and inter-coded)."""
    h8, w8 = inter8.shape
    if ny < 0 or nx < 0 or ny >= h8 or nx >= w8:
        return None
    if _cu_decode_key(ny, nx, cu_cells) >= cur_key:
        return None
    if not inter8[ny, nx]:
        return None
    m = (int(mv8[ny, nx, 0]), int(mv8[ny, nx, 1]))
    if ref8 is None:
        return m
    return (int(ref8[ny, nx]), m)


def merge_list_pu_at(inter8, mv8, by8: int, bx8: int, ph8: int,
                     pw8: int, part: int, pu_idx: int, cu_cells: int,
                     ref8=None, cu_yx=None):
    """Merge candidate list for one PU at 8-cell rect (by8, bx8,
    ph8, pw8).  part: HEVC PartMode (0=2Nx2N, 1=2NxN, 2=Nx2N,
    4..7=AMP); pu_idx 0/1; cu_yx: the CU origin in 8-cells (defaults
    to the symmetric-split derivation for back-compat).  Candidates
    are MV tuples (or (ref, mv) with ref8).  The partIdx==1 merge
    exclusions (e.g. 2NxN PU1/B1) ride the same-CU availability rule
    (those cells are in the current CU)."""
    if cu_yx is None:
        cu_yx = (by8 - ph8 if (part == 1 and pu_idx) else by8,
                 bx8 - pw8 if (part == 2 and pu_idx) else bx8)
    key = _cu_decode_key(cu_yx[0], cu_yx[1], cu_cells)
    a1 = _pu_nbr(inter8, mv8, by8 + ph8 - 1, bx8 - 1, key, cu_cells,
                 ref8)
    b1 = _pu_nbr(inter8, mv8, by8 - 1, bx8 + pw8 - 1, key, cu_cells,
                 ref8)
    b0 = _pu_nbr(inter8, mv8, by8 - 1, bx8 + pw8, key, cu_cells, ref8)
    a0 = _pu_nbr(inter8, mv8, by8 + ph8, bx8 - 1, key, cu_cells, ref8)
    b2 = _pu_nbr(inter8, mv8, by8 - 1, bx8 - 1, key, cu_cells, ref8)
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
    zero = (0, (0, 0)) if ref8 is not None else (0, 0)
    while len(out) < MAX_MERGE_CANDS:
        out.append(zero)
    return out


def amvp_pair_pu_at(inter8, mv8, by8: int, bx8: int, ph8: int,
                    pw8: int, part: int, pu_idx: int, cu_cells: int,
                    cu_yx=None):
    """AMVP pair for one PU (8.5.3.2.6 with one L0 reference: no
    scaling; A = below-left else left, B = above-right else above else
    above-left)."""
    if cu_yx is None:
        cu_yx = (by8 - ph8 if (part == 1 and pu_idx) else by8,
                 bx8 - pw8 if (part == 2 and pu_idx) else bx8)
    key = _cu_decode_key(cu_yx[0], cu_yx[1], cu_cells)
    a = _pu_nbr(inter8, mv8, by8 + ph8, bx8 - 1, key, cu_cells)
    if a is None:
        a = _pu_nbr(inter8, mv8, by8 + ph8 - 1, bx8 - 1, key, cu_cells)
    b = _pu_nbr(inter8, mv8, by8 - 1, bx8 + pw8, key, cu_cells)
    if b is None:
        b = _pu_nbr(inter8, mv8, by8 - 1, bx8 + pw8 - 1, key, cu_cells)
    if b is None:
        b = _pu_nbr(inter8, mv8, by8 - 1, bx8 - 1, key, cu_cells)
    out = []
    if a is not None:
        out.append(a)
    if b is not None and (a is None or b != a):
        out.append(b)
    while len(out) < 2:
        out.append((0, 0))
    return out


def _pu_nbr_b(inter8, dirs8, mv08, mv18, ny: int, nx: int, cur_key):
    """Full motion (dir, mv0, mv1) of the PU covering cell (ny, nx)
    for B-slice candidate derivation at cell granularity (cu_cells=1
    z keys linearize any variable tree), or None."""
    h8, w8 = inter8.shape
    if ny < 0 or nx < 0 or ny >= h8 or nx >= w8:
        return None
    if _cu_decode_key(ny, nx, 1) >= cur_key:
        return None
    if not inter8[ny, nx]:
        return None
    d = int(dirs8[ny, nx])
    m0 = ((int(mv08[ny, nx, 0]), int(mv08[ny, nx, 1]))
          if d != 1 else (0, 0))
    m1 = ((int(mv18[ny, nx, 0]), int(mv18[ny, nx, 1]))
          if d != 0 else (0, 0))
    return (d, m0, m1)


def merge_list_b_pu_at(inter8, dirs8, mv08, mv18, by8: int, bx8: int,
                       cells: int, ref_poc: tuple):
    """B merge list for a 2Nx2N PU at cell rect (by8, bx8, cells) of a
    variable tree — the cell-granularity form of merge_list_b_at
    (8.5.3.2.3/.4/.5, one reference per list, TMVP off).  Shared by the
    encoder's signalling decision and the oracle decoder."""
    key = _cu_decode_key(by8, bx8, 1)
    a1 = _pu_nbr_b(inter8, dirs8, mv08, mv18, by8 + cells - 1,
                   bx8 - 1, key)
    b1 = _pu_nbr_b(inter8, dirs8, mv08, mv18, by8 - 1,
                   bx8 + cells - 1, key)
    b0 = _pu_nbr_b(inter8, dirs8, mv08, mv18, by8 - 1, bx8 + cells,
                   key)
    a0 = _pu_nbr_b(inter8, dirs8, mv08, mv18, by8 + cells, bx8 - 1,
                   key)
    b2 = _pu_nbr_b(inter8, dirs8, mv08, mv18, by8 - 1, bx8 - 1, key)
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
    n_orig = len(out)
    if n_orig >= 2:
        for (i0, i1) in _COMB_ORDER[:n_orig * (n_orig - 1)]:
            if len(out) >= MAX_MERGE_CANDS:
                break
            if i0 >= n_orig or i1 >= n_orig:
                continue
            d0, m00, _ = out[i0]
            d1, _, m11 = out[i1]
            if d0 == 1 or d1 == 0:
                continue
            if ref_poc[0] != ref_poc[1] or m00 != m11:
                out.append((2, m00, m11))
    while len(out) < MAX_MERGE_CANDS:
        out.append((2, (0, 0), (0, 0)))
    return out


def amvp_pair_b_pu_at(inter8, dirs8, mv08, mv18, by8: int, bx8: int,
                      cells: int, lst: int, poc: int, ref_poc: tuple):
    """AMVP pair for one 2Nx2N PU of a B slice in a variable tree,
    target list `lst` — the cell-granularity form of amvp_pair_b_at
    (8.5.3.2.6/.7, one reference per list, TMVP off)."""
    key = _cu_decode_key(by8, bx8, 1)
    tgt_poc = ref_poc[lst]
    mvs = (mv08, mv18)

    def nbr(ny, nx):
        n = _pu_nbr_b(inter8, dirs8, mv08, mv18, ny, nx, key)
        if n is None:
            return None
        d = n[0]
        uses = [l for l in (lst, 1 - lst) if (d == 2 or d == l)]
        return [(l, (int(mvs[l][ny, nx, 0]), int(mvs[l][ny, nx, 1])))
                for l in uses]

    a_positions = ((by8 + cells, bx8 - 1), (by8 + cells - 1, bx8 - 1))
    b_positions = ((by8 - 1, bx8 + cells), (by8 - 1, bx8 + cells - 1),
                   (by8 - 1, bx8 - 1))

    def same_ref(positions):
        for (ny, nx) in positions:
            n = nbr(ny, nx)
            if n is None:
                continue
            for (l, v) in n:
                if ref_poc[l] == tgt_poc:
                    return v
        return None

    def scaled(positions):
        for (ny, nx) in positions:
            n = nbr(ny, nx)
            if n is None:
                continue
            for (l, v) in n:
                td = poc - ref_poc[l]
                tb = poc - tgt_poc
                if td == 0:
                    continue
                return v if td == tb else _mv_scale(v, tb, td)
        return None

    a_pu_present = any(nbr(ny, nx) is not None
                       for (ny, nx) in a_positions)
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
    while len(out) < 2:
        out.append((0, 0))
    return out


# ---------------------------------------------------------------------
# Scalar per-CU reference models of the variable-tree 2Nx2N signalling
# derivation (the decode-order loops the oracle decoder also follows).
# The encoder's hot path uses the vectorized forms below; these stay as
# the equivalence oracle (tests/test_var_vec.py).
# ---------------------------------------------------------------------

def merge_amvp_var_scalar(size8, inter8, mv8):
    """Decode-order merge/AMVP signalling for variable 2Nx2N inter
    CUs (cell-granularity candidate rules, 6.4.2/8.5.3.2; z keys at
    cell granularity linearize any tree)."""
    from kvazaar_tpu_torch.encoder.var_schedule import _enumerate_cus
    h8, w8 = inter8.shape
    merge8 = np.full((h8, w8), -1, np.int32)
    mvp8 = np.zeros((h8, w8), np.uint8)
    mvd8 = np.zeros((h8, w8, 2), np.int32)
    for (x0, y0, s) in _enumerate_cus(size8):
        cy8, cx8 = y0 // 8, x0 // 8
        if not inter8[cy8, cx8]:
            continue
        cells = s // 8
        mine = (int(mv8[cy8, cx8, 0]), int(mv8[cy8, cx8, 1]))
        mlist = merge_list_pu_at(inter8, mv8, cy8, cx8, cells,
                                 cells, 0, 0, 1, cu_yx=(cy8, cx8))
        if mine in mlist:
            merge8[cy8, cx8] = mlist.index(mine)
            continue
        pair = amvp_pair_pu_at(inter8, mv8, cy8, cx8, cells,
                               cells, 0, 0, 1, cu_yx=(cy8, cx8))
        d0 = abs(mine[0] - pair[0][0]) + abs(mine[1] - pair[0][1])
        d1 = abs(mine[0] - pair[1][0]) + abs(mine[1] - pair[1][1])
        i = 1 if d1 < d0 else 0
        mvp8[cy8, cx8] = i
        mvd8[cy8, cx8] = (mine[0] - pair[i][0],
                          mine[1] - pair[i][1])
    return merge8, mvp8, mvd8


def merge_amvp_var_b_scalar(size8, inter8, dirs8, mv08, mv18,
                            poc, ref_poc):
    """B-slice variant: full-motion merge candidates + per-list
    AMVP (8.5.3.2.3/.6) at cell granularity."""
    from kvazaar_tpu_torch.encoder.var_schedule import _enumerate_cus
    h8, w8 = inter8.shape
    merge8 = np.full((h8, w8), -1, np.int32)
    mvp8 = np.zeros((h8, w8), np.uint8)
    mvd8 = np.zeros((h8, w8, 2), np.int32)
    mvp8_l1 = np.zeros((h8, w8), np.uint8)
    mvd8_l1 = np.zeros((h8, w8, 2), np.int32)
    for (x0, y0, s) in _enumerate_cus(size8):
        cy8, cx8 = y0 // 8, x0 // 8
        if not inter8[cy8, cx8]:
            continue
        cells = s // 8
        d = int(dirs8[cy8, cx8])
        m0 = ((int(mv08[cy8, cx8, 0]), int(mv08[cy8, cx8, 1]))
              if d != 1 else (0, 0))
        m1 = ((int(mv18[cy8, cx8, 0]), int(mv18[cy8, cx8, 1]))
              if d != 0 else (0, 0))
        mine = (d, m0, m1)
        mlist = merge_list_b_pu_at(inter8, dirs8, mv08, mv18,
                                   cy8, cx8, cells, ref_poc)
        if mine in mlist:
            merge8[cy8, cx8] = mlist.index(mine)
            continue
        if d != 1:
            pair = amvp_pair_b_pu_at(inter8, dirs8, mv08, mv18,
                                     cy8, cx8, cells, 0, poc,
                                     ref_poc)
            d0_ = sum(abs(m0[k] - pair[0][k]) for k in range(2))
            d1_ = sum(abs(m0[k] - pair[1][k]) for k in range(2))
            i = 1 if d1_ < d0_ else 0
            mvp8[cy8, cx8] = i
            mvd8[cy8, cx8] = (m0[0] - pair[i][0],
                              m0[1] - pair[i][1])
        if d != 0:
            pair = amvp_pair_b_pu_at(inter8, dirs8, mv08, mv18,
                                     cy8, cx8, cells, 1, poc,
                                     ref_poc)
            d0_ = sum(abs(m1[k] - pair[0][k]) for k in range(2))
            d1_ = sum(abs(m1[k] - pair[1][k]) for k in range(2))
            i = 1 if d1_ < d0_ else 0
            mvp8_l1[cy8, cx8] = i
            mvd8_l1[cy8, cx8] = (m1[0] - pair[i][0],
                                 m1[1] - pair[i][1])
    return merge8, mvp8, mvd8, mvp8_l1, mvd8_l1


def var_skip8_scalar(size8, inter8, merge8, coeff_y, coeff_cb=None,
                     coeff_cr=None):
    """cu_skip_flag per CU: 2Nx2N merge CUs with no coded
    coefficients in any plane (cell-filled)."""
    from kvazaar_tpu_torch.encoder.var_schedule import _enumerate_cus
    h8, w8 = inter8.shape
    skip8 = np.zeros((h8, w8), np.uint8)
    for (x0, y0, s) in _enumerate_cus(size8):
        cy8, cx8 = y0 // 8, x0 // 8
        if not inter8[cy8, cx8] or merge8[cy8, cx8] < 0:
            continue
        cz = not coeff_y[y0:y0 + s, x0:x0 + s].any()
        if cz and coeff_cb is not None:
            cz = (not coeff_cb[y0 // 2:(y0 + s) // 2,
                               x0 // 2:(x0 + s) // 2].any()
                  and not coeff_cr[y0 // 2:(y0 + s) // 2,
                                   x0 // 2:(x0 + s) // 2].any())
        if cz:
            c = s // 8
            skip8[cy8:cy8 + c, cx8:cx8 + c] = 1
    return skip8


# ---------------------------------------------------------------------
# Vectorized (frame-wide numpy) forms of the variable-tree 2Nx2N
# signalling derivation — bit-identical to the scalar loops above
# (tested in tests/test_var_vec.py), but one array pass per frame
# instead of thousands of per-CU Python iterations (the host planning
# stage sits on the encode critical path).
# ---------------------------------------------------------------------

def zkey_grid(h8: int, w8: int) -> np.ndarray:
    """Cell-granularity decode-order key: CTU raster index * 64 +
    Morton z within the CTU.  Strictly increasing in decode order, and
    Z[cell] < Z[cu_origin] exactly when the cell's CU is decoded before
    the CU at that origin (matches _cu_decode_key lexicographic
    tuples)."""
    y = np.arange(h8, dtype=np.int64)[:, None]
    x = np.arange(w8, dtype=np.int64)[None, :]
    ctu = (y // 8) * ((w8 + 7) // 8) + (x // 8)
    zy, zx = y % 8, x % 8
    z = np.zeros((h8, w8), np.int64)
    for b in range(3):
        z |= ((zx >> b) & 1) << (2 * b)
        z |= ((zy >> b) & 1) << (2 * b + 1)
    return ctu * 64 + z


def var_origin_maps(size8: np.ndarray):
    """(oy, ox): per-cell origin coordinates of the CU covering it
    (size8 is cell-filled, CUs are size-aligned)."""
    h8, w8 = size8.shape
    cm = size8.astype(np.int64) // 8
    y = np.arange(h8, dtype=np.int64)[:, None]
    x = np.arange(w8, dtype=np.int64)[None, :]
    return (y // cm) * cm, (x // cm) * cm


def _var_cu_arrays(size8: np.ndarray, inter8: np.ndarray):
    """Arrays (cy, cx, cells) of the inter CU origins of a var tree."""
    h8, w8 = size8.shape
    cm = size8.astype(np.int64) // 8
    y = np.arange(h8, dtype=np.int64)[:, None]
    x = np.arange(w8, dtype=np.int64)[None, :]
    sel = ((y % cm) == 0) & ((x % cm) == 0) & (inter8 != 0)
    cy, cx = np.nonzero(sel)
    return cy.astype(np.int64), cx.astype(np.int64), cm[cy, cx]


def _nbr_field(Z, key, inter8, ny, nx, *fields):
    """Vectorized neighbor fetch at cell (ny, nx) per CU: ok mask +
    each requested field's values (zero-filled where not ok)."""
    h8, w8 = inter8.shape
    inb = (ny >= 0) & (nx >= 0) & (ny < h8) & (nx < w8)
    nyc = np.clip(ny, 0, h8 - 1)
    nxc = np.clip(nx, 0, w8 - 1)
    ok = inb & (Z[nyc, nxc] < key) & (inter8[nyc, nxc] != 0)
    out = []
    for f in fields:
        v = f[nyc, nxc].astype(np.int64)
        v[~ok] = 0
        out.append(v)
    return (ok,) + tuple(out)


def _neq2(a, b):
    return (a != b).any(axis=-1)


def var_p_derive(size8: np.ndarray, inter8: np.ndarray,
                 mv8: np.ndarray):
    """Vectorized per-CU derivation for P variable trees: CU arrays,
    the 5-entry merge candidate lists, and the AMVP pair.  Returns a
    dict {cy, cx, cells, mine, cands (n,5,2), p0, p1} (int64)."""
    h8, w8 = inter8.shape
    cy, cx, cells = _var_cu_arrays(size8, inter8)
    n = cy.size
    out = dict(cy=cy, cx=cx, cells=cells)
    if n == 0:
        out.update(mine=np.zeros((0, 2), np.int64),
                   cands=np.zeros((0, 5, 2), np.int64),
                   p0=np.zeros((0, 2), np.int64),
                   p1=np.zeros((0, 2), np.int64))
        return out
    Z = zkey_grid(h8, w8)
    key = Z[cy, cx]
    mine = mv8[cy, cx].astype(np.int64)

    def nbr(dy, dx):
        return _nbr_field(Z, key, inter8, cy + dy, cx + dx, mv8)

    a1ok, a1 = nbr(cells - 1, -1)
    b1ok, b1 = nbr(-1, cells - 1)
    b0ok, b0 = nbr(-1, cells)
    a0ok, a0 = nbr(cells, -1)
    b2ok, b2 = nbr(-1, -1)

    use = np.zeros((n, 5), bool)
    use[:, 0] = a1ok
    use[:, 1] = b1ok & (~a1ok | _neq2(b1, a1))
    use[:, 2] = b0ok & (~b1ok | _neq2(b0, b1))
    use[:, 3] = a0ok & (~a1ok | _neq2(a0, a1))
    n4 = use[:, :4].sum(axis=1)
    use[:, 4] = (b2ok & (n4 < 4) & (~a1ok | _neq2(b2, a1))
                 & (~b1ok | _neq2(b2, b1)))

    cands = np.zeros((n, MAX_MERGE_CANDS, 2), np.int64)
    src = np.stack([a1, b1, b0, a0, b2], axis=1)
    slot = np.zeros(n, np.int64)
    for k in range(5):
        u = use[:, k]
        idx = np.nonzero(u)[0]
        cands[idx, slot[idx]] = src[idx, k]
        slot[idx] += 1

    # AMVP: A = below-left else left; B = above-right else above else
    # above-left; slot1 only when both and different.
    aok = a0ok | a1ok
    a = np.where(a0ok[:, None], a0, a1)
    bok = b0ok | b1ok | b2ok
    b = np.where(b0ok[:, None], b0, np.where(b1ok[:, None], b1, b2))
    p0 = np.where(aok[:, None], a, np.where(bok[:, None], b, 0))
    second = aok & bok & _neq2(b, a)
    p1 = np.where(second[:, None], b, 0)
    out.update(mine=mine, cands=cands, p0=p0, p1=p1)
    return out


def merge_amvp_var_vec(size8: np.ndarray, inter8: np.ndarray,
                       mv8: np.ndarray):
    """Vectorized P-slice variable-tree merge/AMVP signalling:
    per-CU equivalent of merge_list_pu_at + amvp_pair_pu_at at cell
    granularity (cu_cells=1, cu_yx=origin).  Returns (merge8, mvp8,
    mvd8) shaped like the frame cell grid."""
    h8, w8 = inter8.shape
    merge8 = np.full((h8, w8), -1, np.int32)
    mvp8 = np.zeros((h8, w8), np.uint8)
    mvd8 = np.zeros((h8, w8, 2), np.int32)
    d = var_p_derive(size8, inter8, mv8)
    cy, cx = d["cy"], d["cx"]
    n = cy.size
    if n == 0:
        return merge8, mvp8, mvd8
    mine, cands, p0, p1 = d["mine"], d["cands"], d["p0"], d["p1"]

    midx = np.full(n, -1, np.int64)
    for k in range(MAX_MERGE_CANDS - 1, -1, -1):
        eq = (cands[:, k] == mine).all(axis=1)
        midx = np.where(eq, k, midx)
    merged = midx >= 0

    d0 = np.abs(mine - p0).sum(axis=1)
    d1 = np.abs(mine - p1).sum(axis=1)
    pick1 = d1 < d0
    pick = np.where(pick1[:, None], p1, p0)

    merge8[cy[merged], cx[merged]] = midx[merged]
    um = ~merged
    mvp8[cy[um], cx[um]] = pick1[um].astype(np.uint8)
    mvd8[cy[um], cx[um]] = (mine - pick)[um].astype(np.int32)
    return merge8, mvp8, mvd8


def _mv_scale_vec(v: np.ndarray, tb: int, td: int) -> np.ndarray:
    """_mv_scale over (n, 2) arrays with scalar POC distances."""
    td = max(-128, min(127, td))
    tb = max(-128, min(127, tb))
    q = 16384 + (abs(td) >> 1)
    tx = (q // abs(td)) * (1 if td > 0 else -1)
    dsf = max(-4096, min(4095, (tb * tx + 32) >> 6))
    p = dsf * v
    s = np.where(p >= 0, 1, -1)
    return np.clip(s * ((np.abs(p) + 127) >> 8), -32768, 32767)


def var_b_derive(size8, inter8, dirs8, mv08, mv18, poc: int,
                 ref_poc: tuple):
    """Vectorized per-CU derivation for B variable trees: CU arrays,
    full-motion merge candidates (cd/c0/c1), and per-list AMVP pairs.
    Returns {cy, cx, cells, md, mm0, mm1, cd (n,5), c0 (n,5,2),
    c1 (n,5,2), amvp: {0: (p0, p1), 1: (p0, p1)}}."""
    h8, w8 = inter8.shape
    cy, cx, cells = _var_cu_arrays(size8, inter8)
    n = cy.size
    out = dict(cy=cy, cx=cx, cells=cells)
    if n == 0:
        z2 = np.zeros((0, 2), np.int64)
        out.update(md=np.zeros(0, np.int64), mm0=z2, mm1=z2,
                   cd=np.zeros((0, 5), np.int64),
                   c0=np.zeros((0, 5, 2), np.int64),
                   c1=np.zeros((0, 5, 2), np.int64),
                   amvp={0: (z2, z2), 1: (z2, z2)})
        return out
    Z = zkey_grid(h8, w8)
    key = Z[cy, cx]
    md = dirs8[cy, cx].astype(np.int64)
    mm0 = np.where((md != 1)[:, None], mv08[cy, cx].astype(np.int64), 0)
    mm1 = np.where((md != 0)[:, None], mv18[cy, cx].astype(np.int64), 0)

    def nbr(dy, dx):
        ok, d, m0, m1 = _nbr_field(Z, key, inter8, cy + dy, cx + dx,
                                   dirs8, mv08, mv18)
        m0 = np.where((d != 1)[:, None], m0, 0)
        m1 = np.where((d != 0)[:, None], m1, 0)
        return ok, d, m0, m1

    POS = {"a1": (cells - 1, -1), "b1": (-1, cells - 1),
           "b0": (-1, cells), "a0": (cells, -1), "b2": (-1, -1)}
    nb = {k: nbr(dy, dx) for k, (dy, dx) in POS.items()}

    def neq(p, q):
        okp, dp, p0, p1 = nb[p]
        okq, dq, q0, q1 = nb[q]
        return (~okq | (dp != dq) | _neq2(p0, q0) | _neq2(p1, q1))

    use = np.zeros((n, 5), bool)
    use[:, 0] = nb["a1"][0]
    use[:, 1] = nb["b1"][0] & neq("b1", "a1")
    use[:, 2] = nb["b0"][0] & neq("b0", "b1")
    use[:, 3] = nb["a0"][0] & neq("a0", "a1")
    n4 = use[:, :4].sum(axis=1)
    use[:, 4] = (nb["b2"][0] & (n4 < 4) & neq("b2", "a1")
                 & neq("b2", "b1"))

    cd = np.full((n, MAX_MERGE_CANDS), 2, np.int64)
    c0 = np.zeros((n, MAX_MERGE_CANDS, 2), np.int64)
    c1 = np.zeros((n, MAX_MERGE_CANDS, 2), np.int64)
    order = ["a1", "b1", "b0", "a0", "b2"]
    slot = np.zeros(n, np.int64)
    for k, name in enumerate(order):
        u = use[:, k]
        idx = np.nonzero(u)[0]
        _ok, d, m0, m1 = nb[name]
        cd[idx, slot[idx]] = d[idx]
        c0[idx, slot[idx]] = m0[idx]
        c1[idx, slot[idx]] = m1[idx]
        slot[idx] += 1
    ns = slot.copy()

    # Combined bi-predictive candidates (Table 8-8); i0/i1 < ns always
    # holds within the _COMB_ORDER[:ns*(ns-1)] prefix.
    refs_differ = ref_poc[0] != ref_poc[1]
    for t, (i0, i1) in enumerate(_COMB_ORDER):
        can = (t < ns * (ns - 1)) & (slot < MAX_MERGE_CANDS)
        if not can.any():
            continue
        d0 = cd[:, i0]
        d1 = cd[:, i1]
        valid = (can & (d0 != 1) & (d1 != 0)
                 & (refs_differ | _neq2(c0[:, i0], c1[:, i1])))
        idx = np.nonzero(valid)[0]
        cd[idx, slot[idx]] = 2
        c0[idx, slot[idx]] = c0[idx, i0]
        c1[idx, slot[idx]] = c1[idx, i1]
        slot[idx] += 1
    # Zero-fill is the (2, 0, 0) initialization; but slots written by
    # spatial candidates below `slot` are final either way.

    def amvp_list(lst: int):
        """(pair0, pair1, ok-pattern) per CU for target list lst —
        amvp_pair_b_pu_at vectorized."""
        tgt_poc = ref_poc[lst]
        mvs_all = (mv08, mv18)

        def uses(name, lidx):
            ok, d, _m0, _m1 = nb[name]
            return ok & ((d == 2) | (d == lidx))

        def raw(name, lidx):
            dy, dx = POS[name]
            ny = np.clip(cy + dy, 0, h8 - 1)
            nx = np.clip(cx + dx, 0, w8 - 1)
            return mvs_all[lidx][ny, nx].astype(np.int64)

        a_names = ("a0", "a1")
        b_names = ("b0b", "b1b", "b2")
        # AMVP B-position names differ from merge: above-right, above,
        # above-left = b0, b1, b2 in merge naming.
        bmap = {"b0b": "b0", "b1b": "b1", "b2": "b2"}

        def first_same_ref(names):
            val = np.zeros((n, 2), np.int64)
            found = np.zeros(n, bool)
            for nm in names:
                mm = bmap.get(nm, nm)
                for lidx in (lst, 1 - lst):
                    if ref_poc[lidx] != tgt_poc:
                        continue
                    v = uses(mm, lidx) & ~found
                    val[v] = raw(mm, lidx)[v]
                    found |= uses(mm, lidx)
            return val, found

        def first_scaled(names):
            val = np.zeros((n, 2), np.int64)
            found = np.zeros(n, bool)
            for nm in names:
                mm = bmap.get(nm, nm)
                for lidx in (lst, 1 - lst):
                    td = poc - ref_poc[lidx]
                    tb = poc - tgt_poc
                    if td == 0:
                        continue
                    r = raw(mm, lidx)
                    sv = r if td == tb else _mv_scale_vec(r, tb, td)
                    v = uses(mm, lidx) & ~found
                    val[v] = sv[v]
                    found |= uses(mm, lidx)
            return val, found

        a_present = nb["a0"][0] | nb["a1"][0]
        a_val, a_found = first_same_ref(a_names)
        as_val, as_found = first_scaled(a_names)
        a_ok = a_found | (~a_found & a_present & as_found)
        a_val = np.where(a_found[:, None], a_val, as_val)
        b_val, b_found = first_same_ref(b_names)
        bs_val, bs_found = first_scaled(b_names)
        # isScaledFlag == 0 (no A-side PU): B takes A's slot, B is
        # re-derived with scaling, dropped if equal to the new A.
        npres = ~a_present
        b_eq_bs = b_found & bs_found & ~_neq2(bs_val, b_val)
        a_ok2 = np.where(npres, b_found, a_ok)
        a_val2 = np.where(npres[:, None], b_val, a_val)
        b_ok2 = np.where(npres, bs_found & ~b_eq_bs, b_found)
        b_val2 = np.where(npres[:, None], bs_val, b_val)
        p0 = np.where(a_ok2[:, None], a_val2,
                      np.where(b_ok2[:, None], b_val2, 0))
        second = a_ok2 & b_ok2 & _neq2(b_val2, a_val2)
        p1 = np.where(second[:, None], b_val2, 0)
        return p0, p1

    out.update(md=md, mm0=mm0, mm1=mm1, cd=cd, c0=c0, c1=c1,
               amvp={0: amvp_list(0), 1: amvp_list(1)})
    return out


def merge_amvp_var_b_vec(size8, inter8, dirs8, mv08, mv18, poc: int,
                         ref_poc: tuple):
    """Vectorized B-slice variable-tree merge/AMVP signalling:
    per-CU equivalent of merge_list_b_pu_at + amvp_pair_b_pu_at.
    dirs8/mv08/mv18 are the effective (unused-list-zeroed) fields.
    Returns (merge8, mvp8, mvd8, mvp8_l1, mvd8_l1)."""
    h8, w8 = inter8.shape
    merge8 = np.full((h8, w8), -1, np.int32)
    mvp8 = np.zeros((h8, w8), np.uint8)
    mvd8 = np.zeros((h8, w8, 2), np.int32)
    mvp8_l1 = np.zeros((h8, w8), np.uint8)
    mvd8_l1 = np.zeros((h8, w8, 2), np.int32)
    d = var_b_derive(size8, inter8, dirs8, mv08, mv18, poc, ref_poc)
    cy, cx = d["cy"], d["cx"]
    n = cy.size
    if n == 0:
        return merge8, mvp8, mvd8, mvp8_l1, mvd8_l1
    md, mm0, mm1 = d["md"], d["mm0"], d["mm1"]
    cd, c0, c1 = d["cd"], d["c0"], d["c1"]

    midx = np.full(n, -1, np.int64)
    for k in range(MAX_MERGE_CANDS - 1, -1, -1):
        eq = ((cd[:, k] == md) & (c0[:, k] == mm0).all(axis=1)
              & (c1[:, k] == mm1).all(axis=1))
        midx = np.where(eq, k, midx)
    merged = midx >= 0
    merge8[cy[merged], cx[merged]] = midx[merged]

    um = ~merged
    for lst, (mp8, md8, mmv) in ((0, (mvp8, mvd8, mm0)),
                                 (1, (mvp8_l1, mvd8_l1, mm1))):
        use_l = um & ((md != 1) if lst == 0 else (md != 0))
        if not use_l.any():
            continue
        p0, p1 = d["amvp"][lst]
        d0 = np.abs(mmv - p0).sum(axis=1)
        d1 = np.abs(mmv - p1).sum(axis=1)
        pick1 = d1 < d0
        pick = np.where(pick1[:, None], p1, p0)
        sel = use_l
        mp8[cy[sel], cx[sel]] = pick1[sel].astype(np.uint8)
        md8[cy[sel], cx[sel]] = (mmv - pick)[sel].astype(np.int32)
    return merge8, mvp8, mvd8, mvp8_l1, mvd8_l1


def _integral(a: np.ndarray) -> np.ndarray:
    out = np.zeros((a.shape[0] + 1, a.shape[1] + 1), np.int64)
    np.cumsum(np.cumsum(a, 0, dtype=np.int64), 1, out=out[1:, 1:])
    return out


def var_skip8_vec(size8, inter8, merge8, coeff_y, coeff_cb=None,
                  coeff_cr=None):
    """Vectorized cu_skip_flag: 2Nx2N merge CUs whose coefficient
    rects are all-zero in every plane (integral-image rect sums,
    cell-filled via the origin gather)."""
    h8, w8 = size8.shape
    cy, cx, cells = _var_cu_arrays(size8, inter8)
    if cy.size == 0:
        return np.zeros((h8, w8), np.uint8)
    cand = merge8[cy, cx] >= 0
    Iy = _integral(np.asarray(coeff_y) != 0)

    def rect_nz(I, y0, x0, s):
        return (I[y0 + s, x0 + s] - I[y0, x0 + s] - I[y0 + s, x0]
                + I[y0, x0])

    y0, x0, s = cy * 8, cx * 8, cells * 8
    zero = rect_nz(Iy, y0, x0, s) == 0
    if coeff_cb is not None:
        Icb = _integral(np.asarray(coeff_cb) != 0)
        Icr = _integral(np.asarray(coeff_cr) != 0)
        yc, xc, sc = cy * 4, cx * 4, cells * 4
        zero &= (rect_nz(Icb, yc, xc, sc) == 0)
        zero &= (rect_nz(Icr, yc, xc, sc) == 0)
    q = np.zeros((h8, w8), bool)
    q[cy, cx] = cand & zero
    oy, ox = var_origin_maps(size8)
    return q[oy, ox].astype(np.uint8)


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
