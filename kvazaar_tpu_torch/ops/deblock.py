"""HEVC deblocking (8.7.2) for uniform-CU frames.

Counterpart of kvazaar_tpu/ops/deblock.py.  Every
CU-grid line is a TU+PU boundary; its boundary strength is 2 on
all-intra frames (both sides intra, 8.7.2.4) or comes per edge from the
(By, Bx) maps ``bs_v``/``bs_h`` on P frames: bS 0 leaves the edge
unfiltered, luma tC follows bS, chroma filters only bS 2.  The QP is
the frame's or, given a per-block map (LCU rate control, ROI and AQ),
each edge's two-sided average ((QpP + QpQ + 1) >> 1, 8.7.2.5.3), chroma
through Table 8-10.  Intra
prediction reads unfiltered samples, so the filter is a frame-level
post-pass: every vertical edge filters in parallel, then every
horizontal edge on that output.  The beta/tC tables are copies of the
JAX package's (pinned by a test).
"""

from __future__ import annotations

import numpy as np
import torch

from kvazaar_tpu_torch.constants import CHROMA_QP_TAB
from kvazaar_tpu_torch.ops.quant import int32_table

# Spec Table 8-12 constants.
TC_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5,
    6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24], dtype=np.int32)
BETA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9,
    10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32,
    34, 36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64],
    dtype=np.int32)


def luma_params(qp: int, beta_off2: int, tc_off2: int, bitdepth: int):
    """(beta, tc) for an intra edge (bs=2)."""
    scale = 1 << (bitdepth - 8)
    b_idx = min(max(qp + (beta_off2 << 1), 0), 51)
    t_idx = min(max(qp + 2 + (tc_off2 << 1), 0), 53)
    return int(BETA_TABLE[b_idx]) * scale, int(TC_TABLE[t_idx]) * scale


def _filter_luma_stripes(st, beta: int, tc_g, bitdepth: int):
    """Filter across an edge.  st: (..., E, 8, L) int32 — taps
    [p3 p2 p1 p0 q0 q1 q2 q3] on axis -2, edge lines on the last axis
    (decisions per group of 4 lines).  tc_g: (E, L/4) int32 tC per
    group of 4 lines (0 disables the group).  Returns the same shape."""
    p3, p2, p1, p0 = st[..., 0, :], st[..., 1, :], st[..., 2, :], \
        st[..., 3, :]
    q0, q1, q2, q3 = st[..., 4, :], st[..., 5, :], st[..., 6, :], \
        st[..., 7, :]
    maxv = (1 << bitdepth) - 1

    def rep(a):                       # group -> per-line broadcast
        return torch.repeat_interleave(a, 4, dim=-1)

    tc = rep(tc_g)                         # per line
    dp = torch.abs(p2 - 2 * p1 + p0)       # (..., E, L)
    dq = torch.abs(q2 - 2 * q1 + q0)
    dp03 = dp[..., 0::4] + dp[..., 3::4]   # (..., E, G)
    dq03 = dq[..., 0::4] + dq[..., 3::4]
    filter_on = (dp03 + dq03) < beta

    ap = torch.abs(p3 - p0) + torch.abs(q0 - q3)
    apq = torch.abs(p0 - q0)
    thr_tc = (5 * tc_g + 1) >> 1

    def strong_cond(i):
        return ((2 * (dp[..., i::4] + dq[..., i::4]) < (beta >> 2))
                & (ap[..., i::4] < (beta >> 3))
                & (apq[..., i::4] < thr_tc))

    strong = strong_cond(0) & strong_cond(3)     # (..., E, G)

    # Strong filter (clipped to +-2tc around the originals).
    def sclip(v, orig):
        return torch.minimum(torch.maximum(v, orig - 2 * tc),
                             orig + 2 * tc)

    sp0 = sclip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0)
    sp1 = sclip((p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = sclip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = sclip((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0)
    sq1 = sclip((p0 + q0 + q1 + q2 + 2) >> 2, q1)
    sq2 = sclip((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2)

    # Weak filter.
    delta = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    weak_on = torch.abs(delta) < 10 * tc          # per line
    dlt = torch.clamp(delta, -tc, tc)
    wp0 = torch.clamp(p0 + dlt, 0, maxv)
    wq0 = torch.clamp(q0 - dlt, 0, maxv)
    side_thr = (beta + (beta >> 1)) >> 3
    filt_p = rep(dp03 < side_thr)
    filt_q = rep(dq03 < side_thr)
    tc2 = tc >> 1
    dp1 = torch.clamp((((p2 + p0 + 1) >> 1) - p1 + dlt) >> 1, -tc2, tc2)
    dq1 = torch.clamp((((q2 + q0 + 1) >> 1) - q1 - dlt) >> 1, -tc2, tc2)
    wp1 = torch.clamp(p1 + dp1, 0, maxv)
    wq1 = torch.clamp(q1 + dq1, 0, maxv)

    on = rep(filter_on & (tc_g > 0))
    s_l = rep(strong) & on
    wk = ~rep(strong) & on & weak_on

    return torch.stack(
        [p3,
         torch.where(s_l, sp2, p2),
         torch.where(s_l, sp1, torch.where(wk & filt_p, wp1, p1)),
         torch.where(s_l, sp0, torch.where(wk, wp0, p0)),
         torch.where(s_l, sq0, torch.where(wk, wq0, q0)),
         torch.where(s_l, sq1, torch.where(wk & filt_q, wq1, q1)),
         torch.where(s_l, sq2, q2),
         q3], dim=-2)


def _filter_chroma_stripes(st, tc, bitdepth: int):
    """st: (..., E, 4, L) = taps [p1 p0 q0 q1] on axis -2, lines last;
    tc: (E, L) int32 per line (0 pins delta to 0)."""
    p1, p0, q0, q1 = st[..., 0, :], st[..., 1, :], st[..., 2, :], \
        st[..., 3, :]
    maxv = (1 << bitdepth) - 1
    delta = torch.clamp((((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc, tc)
    return torch.stack(
        [p1, torch.clamp(p0 + delta, 0, maxv),
         torch.clamp(q0 - delta, 0, maxv), q1], dim=-2)


def _deblock_plane_vertical(plane, edge_step: int, filt_fn, taps: int):
    """Filter all vertical edges at x = edge_step, 2*edge_step, ...
    plane: (..., H, W).  Stripes never overlap (edge_step >= taps), so
    extraction and write-back are a handful of reshapes/concats over a
    (..., H, W/step, step) block view."""
    w = plane.shape[-1]
    n = w // edge_step
    if n < 2:
        return plane
    half = taps // 2
    blocks = plane.reshape(*plane.shape[:-1], n, edge_step)
    left = blocks[..., :-1, edge_step - half:]     # (..., H, E, half)
    right = blocks[..., 1:, :half]
    stripes = torch.cat([left, right], dim=-1)
    st = torch.movedim(stripes, -3, -1)            # (..., E, taps, H)
    filtered = torch.movedim(filt_fn(st), -1, -3)
    first = torch.cat([blocks[..., :1, :half], filtered[..., half:]],
                      dim=-2)
    last = torch.cat([filtered[..., :half],
                      blocks[..., -1:, edge_step - half:]], dim=-2)
    mid = blocks[..., :, half:edge_step - half]
    out = torch.cat([first, mid, last], dim=-1)
    return out.reshape(plane.shape)


def _tc_lookup(qp_plus: int, bs: torch.Tensor, scale: int):
    """tC per entry of a bS tensor; bS 0 gives tC 0, which disables the
    filter exactly as the spec skips bS 0 edges."""
    idx = torch.clamp(qp_plus + 2 * (bs - 1), 0, 53)
    tc = int32_table(TC_TABLE.tobytes(), bs.device)[idx.long()] * scale
    return torch.where(bs > 0, tc, 0)


def _edge_bs(bs_map: torch.Tensor, n_edges: int, step: int, blk: int,
             transposed: bool) -> torch.Tensor:
    """(E, Brows) bS of edge e (at (e+1)*step) for each block row along
    it, from a (By, Bx) map of each block's left (or, transposed, top)
    edge on a grid of ``blk`` samples."""
    mm = bs_map.T if transposed else bs_map
    cols = (np.arange(n_edges, dtype=np.int32) + 1) * step // blk
    return mm[:, int32_table(cols.tobytes(), bs_map.device).long()].T


def _rows_of(n: int, per: int, blk: int, n_rows: int, device):
    """Block row of each of n groups of ``per`` lines."""
    rows = np.minimum(np.arange(n, dtype=np.int32) * per // blk,
                      n_rows - 1)
    return int32_table(rows.tobytes(), device).long()


def _edge_qp(qp_map: torch.Tensor, n_edges: int, step: int, blk: int,
             transposed: bool) -> torch.Tensor:
    """(E, Brows) QP of edge e: the two-sided average of the blocks
    either side of it, from a (By, Bx) map of per-block luma QPs."""
    mm = (qp_map.T if transposed else qp_map).to(torch.int32)
    cols = (np.arange(n_edges, dtype=np.int32) + 1) * step // blk
    idx = int32_table(cols.tobytes(), qp_map.device).long()
    return ((mm[:, idx - 1] + mm[:, idx] + 1) >> 1).T


def deblock_plane(plane: torch.Tensor, qp: int, edge_step: int,
                  bitdepth: int = 8, beta_off2: int = 0,
                  tc_off2: int = 0, chroma: bool = False, bs_v=None,
                  bs_h=None, blk: int = 0, qp_map=None) -> torch.Tensor:
    """Deblock one plane (..., H, W) int32: vertical edges, then
    horizontal edges on that output.  edge_step: S for luma, S/2 for
    chroma (chroma filters only edges on its own 8-grid).  bs_v/bs_h:
    (By, Bx) int32 bS of each block's left/top edge on the block grid
    of size ``blk`` (default: the edge step); None = all bS 2.  qp_map:
    (By, Bx) int32 per-block luma QP on the same grid, replacing qp."""
    scale = 1 << (bitdepth - 8)
    beta = qp_plus = None           # per edge with a QP map
    if chroma:
        step, taps = max(edge_step, 8), 4
        if qp_map is None:
            qp_plus = int(CHROMA_QP_TAB[min(max(qp, 0), 51)]) + (tc_off2
                                                                  << 1)
    else:
        step, taps = edge_step, 8
        if qp_map is None:
            beta, _ = luma_params(qp, beta_off2, tc_off2, bitdepth)
            if beta == 0:
                return plane
            qp_plus = qp + (tc_off2 << 1)
    blk = blk or step
    h, w = plane.shape[-2], plane.shape[-1]
    if bs_v is None:
        bs_v = bs_h = torch.full((h // blk, w // blk), 2, dtype=torch.int32,
                                 device=plane.device)

    def filt_for(bs_map, transposed, n_lines):
        def filt(st):
            n_e = st.shape[-3]
            bs_e = _edge_bs(bs_map, n_e, step, blk, transposed)
            qe = (None if qp_map is None
                  else _edge_qp(qp_map, n_e, step, blk, transposed))
            if chroma:
                rows = _rows_of(n_lines, 1, blk, bs_e.shape[1], st.device)
                bs_l = bs_e[:, rows]                      # (E, lines)
                qpp = qp_plus
                if qe is not None:
                    cq = int32_table(CHROMA_QP_TAB.astype(np.int32).tobytes(),
                                st.device)[torch.clamp(qe, 0, 51).long()]
                    qpp = cq[:, rows] + (tc_off2 << 1)    # (E, lines)
                tc_l = _tc_lookup(qpp, torch.where(bs_l == 2, 2, 0), scale)
                return _filter_chroma_stripes(st, tc_l, bitdepth)
            rows = _rows_of(n_lines // 4, 4, blk, bs_e.shape[1], st.device)
            beta_g, qpp = (beta, qp_plus) if qe is None else (
                int32_table(BETA_TABLE.tobytes(), st.device)[torch.clamp(
                    qe[:, rows] + (beta_off2 << 1), 0, 51).long()] * scale,
                qe[:, rows] + (tc_off2 << 1))
            tc_g = _tc_lookup(qpp, bs_e[:, rows], scale)   # (E, G)
            return _filter_luma_stripes(st, beta_g, tc_g, bitdepth)
        return filt

    plane = _deblock_plane_vertical(plane, step, filt_for(bs_v, False, h),
                                    taps)
    # Horizontal edges = vertical pass on the transpose.
    plane_t = _deblock_plane_vertical(torch.swapaxes(plane, -1, -2), step,
                                      filt_for(bs_h, True, w), taps)
    return torch.swapaxes(plane_t, -1, -2)


def deblock_frame(y, cb, cr, qp: int, cu_size: int, bitdepth: int = 8,
                  beta_off2: int = 0, tc_off2: int = 0, bs_v=None,
                  bs_h=None, qp_map=None):
    """Deblock a frame (y: (..., H, W); cb/cr half size or None);
    returns int32 planes.  bs_v/bs_h: per-CU-edge boundary strengths on
    the (By, Bx) grid (bs_v[by][bx] = edge at x = bx*S); None = all-intra
    bS 2.  qp_map: (By, Bx) int32 per-block luma QP (else ``qp``)."""
    y = deblock_plane(y.to(torch.int32), qp, cu_size, bitdepth,
                      beta_off2, tc_off2, chroma=False, bs_v=bs_v,
                      bs_h=bs_h, blk=cu_size, qp_map=qp_map)
    if cb is not None:
        cb, cr = (deblock_plane(p.to(torch.int32), qp, cu_size // 2,
                                bitdepth, beta_off2, tc_off2, chroma=True,
                                bs_v=bs_v, bs_h=bs_h, blk=cu_size // 2,
                                qp_map=qp_map) for p in (cb, cr))
    return y, cb, cr
