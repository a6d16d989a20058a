"""Batched inter search for one reference: exhaustive integer-pel ME
with a rate-aware second pass, then dense quarter-pel SATD refinement;
and full-frame motion compensation of the final MVs.

Counterpart of kvazaar_tpu/encoder/inter_search.py: search_inter_frame
with its exhaustive search or the refinement of a hierarchical hint;
the SMP/AMP partition search (search_inter_frame_smp);
mc_planes for one reference or stacked references with a per-block
reference index; the 8x8-cell MC of variable trees (mc_planes_cells)
and the per-cell SATD maps of P merge hypotheses (merge_satd_maps_p);
for B frames the bi-pred check (bi_check), the per-block L0 / L1 / BI
prediction planes of the fixed grid (bi_mc_planes) and of a variable
tree's cells (bi_mc_planes_cells) and the SATD maps of B merge
hypotheses (merge_satd_maps_b).
Costs are formed in float32 exactly as the JAX package forms them (the
Python lambda rounded to float32 first), and every argmin takes the
first index of a tie, as JAX does.
"""

from __future__ import annotations

import numpy as np
import torch

from kvazaar_tpu_torch.encoder import plan_cached
from kvazaar_tpu_torch.encoder.geometry import IntraFramePlan
from kvazaar_tpu_torch.encoder.intra_search import _f32, satd8_batch
from kvazaar_tpu_torch.ops.inter import (bi_average, device_table,
                                         gather_windows, mc_chroma,
                                         mc_chroma_hp, mc_luma, mc_luma_hp,
                                         refine_qpel_dense, sad_surfaces,
                                         uni_round)
from kvazaar_tpu_torch.ops.quant import _fma_f32


def _mv_bits_est(dv: torch.Tensor) -> torch.Tensor:
    """Approximate signalling bits of one mvd component (EG1-shaped):
    1 bin for zero, else 2 * bit_length(|v|) + 1, as float32."""
    a = torch.abs(dv)
    # Exact bit length: frexp of the (exact) float64 value returns the
    # exponent e with 2^(e-1) <= a < 2^e.
    nbits = torch.frexp(torch.clamp(a, min=1).to(torch.float64))[1]
    return torch.where(a == 0, 1, 2 * nbits + 1).to(torch.float32)


def _median3(a, b, c):
    return a + b + c - torch.maximum(a, torch.maximum(b, c)) \
        - torch.minimum(a, torch.minimum(b, c))


def _mv_pred_grid(mv_grid: torch.Tensor) -> torch.Tensor:
    """Median MV predictor from the left/top/top-right pass-1 decisions
    (only used for rate estimation)."""
    zero_col = torch.zeros_like(mv_grid[:, :1])
    left = torch.cat([zero_col, mv_grid[:, :-1]], dim=1)
    top = torch.cat([torch.zeros_like(mv_grid[:1]), mv_grid[:-1]], dim=0)
    topright = torch.cat([top[:, 1:], zero_col], dim=1)
    return _median3(left, top, topright)


@plan_cached
def _block_origins(plan: IntraFramePlan, device: torch.device):
    """(x0s, y0s) of the plan's blocks in raster order, on ``device``."""
    s = plan.cu_size
    ys, xs = np.mgrid[0:plan.blocks_y, 0:plan.blocks_x]
    return (torch.from_numpy((xs * s).reshape(-1)).to(device),
            torch.from_numpy((ys * s).reshape(-1)).to(device))


def _int_refine_sads(cur_blocks, ref, x0s, y0s, centers_px, rng: int,
                     size: int) -> torch.Tensor:
    """(N, (2rng+1)^2) integer-pel SADs around per-block centers, offsets
    row-major over dy then dx in -rng..rng: one (S+2rng)^2 window per
    block, then shifted slices of it."""
    win = gather_windows(ref, x0s + centers_px[:, 0] - rng,
                         y0s + centers_px[:, 1] - rng, size + 2 * rng)
    d = 2 * rng + 1
    out = []
    for dy in range(d):
        rows = win[:, dy:dy + size]                    # (N, S, S + 2rng)
        sl = torch.stack([rows[..., dx:dx + size] for dx in range(d)],
                         dim=1)                         # (N, D, S, S)
        out.append(torch.abs(sl - cur_blocks[:, None]).sum(
            dim=(-2, -1), dtype=torch.int32))
    return torch.cat(out, dim=1)


def _refine_offsets(rng: int) -> np.ndarray:
    return np.array([(dx, dy) for dy in range(-rng, rng + 1)
                     for dx in range(-rng, rng + 1)], np.int32)


def _hint_search(cur_blocks, ref, x0s, y0s, mv_hint, by: int, bx: int,
                 s: int, lam: float):
    """Hierarchical stage 2: +-4 full-resolution SADs around the coarse
    hint and around zero, pass 1 the SAD argmin over both candidate sets
    (hint first), pass 2 the rate-aware re-rank.  Returns (mv_int (N, 2)
    quarter-pel, multiples of 4; the (N, 2) median predictor)."""
    n = by * bx
    rng = 4
    dev = cur_blocks.device
    offs = torch.from_numpy(_refine_offsets(rng)).to(dev)      # (K, 2)
    centers = mv_hint.reshape(n, 2).to(torch.int32) >> 2
    zero = torch.zeros_like(centers)
    sads = torch.cat([
        _int_refine_sads(cur_blocks, ref, x0s, y0s, centers, rng, s),
        _int_refine_sads(cur_blocks, ref, x0s, y0s, zero, rng, s)], dim=1)
    cands = torch.cat([centers[:, None] + offs, zero[:, None] + offs],
                      dim=1)                                   # (N, 2K, 2)
    ar = torch.arange(n, device=dev)
    mv1 = cands[ar, torch.argmin(sads, dim=1)] * 4
    pred = _mv_pred_grid(mv1.reshape(by, bx, 2)).reshape(n, 1, 2)
    q = cands * 4
    bits = (_mv_bits_est(q[..., 0] - pred[..., 0])
            + _mv_bits_est(q[..., 1] - pred[..., 1]))
    cost = sads.to(torch.float32) + bits * lam
    return q[ar, torch.argmin(cost, dim=1)], pred.reshape(n, 2)


def _surface_mv(idx, r: int) -> torch.Tensor:
    """Quarter-pel MVs (N, 2) of flat indices into (2r+1)^2 surfaces."""
    d = 2 * r + 1
    return (torch.stack([idx % d - r, idx // d - r], dim=-1)
            * 4).to(torch.int32)


def _pass1_pred(sads, by: int, bx: int, r: int) -> torch.Tensor:
    """(N, 2) median predictor of the field of each block's pure-SAD
    winner on its (N, (2r+1)^2) surface (the rate reference)."""
    mv1 = _surface_mv(torch.argmin(sads, dim=-1), r)
    return _mv_pred_grid(mv1.reshape(by, bx, 2)).reshape(by * bx, 2)


def _surface_bits(pred, r: int) -> torch.Tensor:
    """(N, (2r+1)^2) float32 mv bits of every integer displacement
    against each block's predictor, row-major over dy then dx."""
    steps = torch.arange(-r, r + 1, device=pred.device) * 4
    bits = (_mv_bits_est(steps[None, None, :] - pred[:, None, None, 0])
            + _mv_bits_est(steps[None, :, None] - pred[:, None, None, 1]))
    return bits.reshape(pred.shape[0], -1)


def _qpel_pick(satd49, mv_int, pred, lam: float):
    """Each block's quarter-pel winner among the 49 candidates around
    its integer MV: SATD + lambda * mv bits against pred in float32,
    the first index on ties.  Returns (mv (N, 2), cost (N,))."""
    cands = mv_int[:, None, :] + device_table("QPEL_OFFSETS",
                                              mv_int.device)
    rate = (_mv_bits_est(cands[..., 0] - pred[:, None, 0])
            + _mv_bits_est(cands[..., 1] - pred[:, None, 1]))
    c = satd49.to(torch.float32) + rate * lam
    k = torch.argmin(c, dim=-1)
    return (cands[torch.arange(c.shape[0], device=c.device), k],
            torch.min(c, dim=-1).values)


def _full_search(cur, ref, by: int, bx: int, s: int, r: int,
                 bitdepth: int, lam: float):
    """Exhaustive +-r integer search: pass 1 the pure-SAD winner, pass 2
    the re-rank with the mv rate against the median predictor of the
    pass-1 field.  Returns (mv_int (N, 2), predictor (N, 2))."""
    sads = sad_surfaces(cur, ref, r, s, bitdepth).reshape(by * bx, -1)
    pred = _pass1_pred(sads, by, bx, r)
    cost = sads.to(torch.float32) + _surface_bits(pred, r) * lam
    return _surface_mv(torch.argmin(cost, dim=-1), r), pred


def search_inter_frame(cur, ref, plan: IntraFramePlan, lambda_satd: float,
                       me_range: int, bitdepth: int = 8,
                       subpel: bool = True, mv_hint=None):
    """cur/ref: (H, W) integer planes (ref is the deblocked previous
    reconstruction).  With mv_hint ((By, Bx, 2) quarter-pel, from
    ops.inter.coarse_mv_grids) the integer search refines around the
    hint and around zero instead of the exhaustive +-me_range search.
    Returns (mv (By, Bx, 2) int32 quarter-pel, cost (By, Bx) float32:
    SATD + lambda * mv bits of the winner)."""
    s = plan.cu_size
    by, bx = plan.blocks_y, plan.blocks_x
    n = by * bx
    dev = cur.device
    lam = _f32(lambda_satd)
    x0s, y0s = _block_origins(plan, dev)
    cur = cur.to(torch.int32)
    ref = ref.to(torch.int32)
    cur_blocks = cur.reshape(by, s, bx, s).permute(0, 2, 1, 3)
    cur_blocks = cur_blocks.reshape(n, s, s)

    if mv_hint is not None:
        mv_int, pred_n = _hint_search(cur_blocks, ref, x0s, y0s, mv_hint,
                                      by, bx, s, lam)
    else:
        mv_int, pred_n = _full_search(cur, ref, by, bx, s, me_range,
                                      bitdepth, lam)

    if not subpel:
        preds = mc_luma(ref, x0s, y0s, mv_int, s, bitdepth)
        satd = satd8_batch(preds - cur_blocks)
        rate = (_mv_bits_est(mv_int[:, 0] - pred_n[:, 0])
                + _mv_bits_est(mv_int[:, 1] - pred_n[:, 1]))
        cost_i = satd.to(torch.float32) + rate * lam
        return mv_int.reshape(by, bx, 2), cost_i.reshape(by, bx)

    satd49 = refine_qpel_dense(cur_blocks, ref, x0s, y0s, mv_int, s,
                               bitdepth)                  # (N, 49)
    mv_q, cost_q = _qpel_pick(satd49, mv_int, pred_n, lam)
    return mv_q.reshape(by, bx, 2).to(torch.int32), cost_q.reshape(by, bx)


def search_inter_frame_smp(cur, ref, plan: IntraFramePlan,
                           lambda_satd: float, me_range: int,
                           bitdepth: int = 8, subpel: bool = True,
                           amp: bool = False):
    """Motion search and partition decision over {2Nx2N, 2NxN, Nx2N}
    and, with ``amp`` (cu 32), the four asymmetric quarter splits: one
    dense SAD surface at sub-block size s/2 (8 with AMP) summed per PU
    shape, the pass-1 predictor of the full shape, an integer and a
    quarter-pel winner per shape, and the first-index argmin over the
    partitions, each non-square one paying ``lambda * 3`` (``* 4`` for
    AMP) for its extra bins.

    Returns (part (By, Bx) int32 HEVC PartMode, mv_pu (By, Bx, 2, 2)
    int32 quarter-pel [PU0, PU1], cost (By, Bx) float32)."""
    s = plan.cu_size
    sub = 8 if amp else s // 2
    g = s // sub
    by, bx = plan.blocks_y, plan.blocks_x
    n = by * bx
    r = me_range
    d = 2 * r + 1
    dev = cur.device
    lam = _f32(lambda_satd)
    cur = cur.to(torch.int32)
    ref = ref.to(torch.int32)
    q = sad_surfaces(cur, ref, r, sub, bitdepth).reshape(by, g, bx, g, d, d)

    def agg(axis, lo, hi):
        sl = q[:, lo:hi] if axis == "r" else q[:, :, :, lo:hi]
        return sl.sum(dim=(1, 3), dtype=torch.int32)

    h = g // 2
    qt = max(g // 4, 1)
    spans = {"full": ("r", 0, g), "top": ("r", 0, h),
             "bottom": ("r", h, g), "left": ("c", 0, h),
             "right": ("c", h, g)}
    pu_of_part = {1: ("top", "bottom"), 2: ("left", "right")}
    with_amp = amp and g >= 4
    if with_amp:
        spans.update({
            "u0": ("r", 0, qt), "u1": ("r", qt, g),
            "d0": ("r", 0, g - qt), "d1": ("r", g - qt, g),
            "l0": ("c", 0, qt), "l1": ("c", qt, g),
            "r0": ("c", 0, g - qt), "r1": ("c", g - qt, g)})
        pu_of_part.update({4: ("u0", "u1"), 5: ("d0", "d1"),
                           6: ("l0", "l1"), 7: ("r0", "r1")})
    surf = {k: agg(*v) for k, v in spans.items()}

    # The full shape's pass-1 predictor is the rate reference of every
    # shape.
    pred = _pass1_pred(surf["full"].reshape(n, -1), by, bx, r)
    bits_grid = _surface_bits(pred, r)

    def int_cost(sads):
        return sads.reshape(n, d * d).to(torch.float32) + bits_grid * lam

    mv_int = {k: _surface_mv(torch.argmin(int_cost(v), dim=-1), r)
              for k, v in surf.items()}

    # Sub-blocks in raster order over the sub-block grid.
    sby, sbx = by * g, bx * g
    qys, qxs = np.mgrid[0:sby, 0:sbx]
    qx0 = torch.from_numpy((qxs * sub).reshape(-1)).to(dev)
    qy0 = torch.from_numpy((qys * sub).reshape(-1)).to(dev)
    cq = cur.reshape(sby, sub, sbx, sub).permute(0, 2, 1, 3).reshape(
        sby * sbx, sub, sub)
    byi, bxi = np.mgrid[0:by, 0:bx]

    def shape_sub_ids(name):
        axis, lo, hi = spans[name]
        rows = range(lo, hi) if axis == "r" else range(g)
        cols = range(g) if axis == "r" else range(lo, hi)
        ids = [((byi * g + rr) * sbx + bxi * g + cc)
               for rr in rows for cc in cols]
        return np.stack([a.reshape(-1) for a in ids], axis=-1)

    def refine_shape(name):
        mvc = mv_int[name]
        sub_ids = shape_sub_ids(name)
        k = sub_ids.shape[1]
        qi = torch.from_numpy(sub_ids.reshape(-1)).to(dev)
        satd = refine_qpel_dense(cq[qi], ref, qx0[qi], qy0[qi],
                                 torch.repeat_interleave(mvc, k, dim=0),
                                 sub, bitdepth)
        return _qpel_pick(satd.reshape(n, k, 49).sum(dim=1,
                                                     dtype=torch.int32),
                          mvc, pred, lam)

    if subpel:
        res = {name: refine_shape(name) for name in surf}
    else:
        res = {name: (mv_int[name], torch.min(int_cost(surf[name]),
                                              dim=-1).values)
               for name in surf}

    # Partition decision: a non-square partition pays its extra
    # part_mode bins and second merge flag (its mv rate is in its PUs'
    # costs).  The extra is the Python product rounded once, as JAX adds
    # a constant.
    parts = [0, 1, 2] + ([4, 5, 6, 7] if with_amp else [])
    costs = [res["full"][1]]
    for p_ in parts[1:]:
        a, b = pu_of_part[p_]
        extra = _f32(lambda_satd * (3.0 if p_ in (1, 2) else 4.0))
        costs.append(res[a][1] + res[b][1] + extra)
    costs = torch.stack(costs)                      # (P, N)
    sel = torch.argmin(costs, dim=0)
    best = torch.min(costs, dim=0).values
    part = torch.tensor(parts, dtype=torch.int32, device=dev)[sel]
    mv0 = res["full"][0]
    mv1_ = res["full"][0]
    for i, p_ in enumerate(parts[1:], start=1):
        a, b = pu_of_part[p_]
        m = (sel == i)[:, None]
        mv0 = torch.where(m, res[a][0], mv0)
        mv1_ = torch.where(m, res[b][0], mv1_)
    mv_pu = torch.stack([mv0, mv1_], dim=1).reshape(by, bx, 2, 2)
    return (part.reshape(by, bx), mv_pu.to(torch.int32),
            best.reshape(by, bx))


def _blocks_to_plane(blocks, by: int, bx: int, size: int):
    return blocks.reshape(by, bx, size, size).permute(0, 2, 1, 3).reshape(
        by * size, bx * size)


def mc_planes(ref_y, ref_cb, ref_cr, mv, plan: IntraFramePlan,
              bitdepth: int = 8, ref_grid=None):
    """Full-frame MC prediction planes of the final MVs.

    mv: (By, Bx, 2) quarter-pel.  With stacked references ((R, H, W)
    planes) pass ref_grid (By, Bx) int32 L0 ref indices: each block
    gathers from its selected reference.  Returns (pred_y (H, W),
    pred_cb, pred_cr) int32.  Each block is interpolated from its own clamped
    window; the JAX package reaches the same samples through
    whole-plane phase planes on a 72-pixel edge extension, which is
    exact while an MV reaches at most 72 pixels outside the frame
    (config.validate caps me_range at 64)."""
    s = plan.cu_size
    by, bx = plan.blocks_y, plan.blocks_x
    x0s, y0s = _block_origins(plan, mv.device)
    mvs = mv.reshape(by * bx, 2).to(torch.int32)
    ridx = None if ref_grid is None else ref_grid.reshape(by * bx)
    py = mc_luma(ref_y.to(torch.int32), x0s, y0s, mvs, s, bitdepth, ridx)
    out_y = _blocks_to_plane(py, by, bx, s)
    if ref_cb is None:
        return out_y, None, None
    s2 = s // 2
    pcb = mc_chroma(ref_cb.to(torch.int32), x0s // 2, y0s // 2, mvs, s2,
                    bitdepth, ridx)
    pcr = mc_chroma(ref_cr.to(torch.int32), x0s // 2, y0s // 2, mvs, s2,
                    bitdepth, ridx)
    return (out_y, _blocks_to_plane(pcb, by, bx, s2),
            _blocks_to_plane(pcr, by, bx, s2))


def _cell_origins(h8: int, w8: int, device: torch.device):
    ys, xs = np.mgrid[0:h8, 0:w8]
    return (torch.from_numpy((xs * 8).reshape(-1)).to(device),
            torch.from_numpy((ys * 8).reshape(-1)).to(device))


def mc_planes_cells(ref_y, ref_cb, ref_cr, mv_cells, bitdepth: int = 8):
    """Full-frame MC driven by an 8x8-cell motion field (h8, w8, 2): the
    MC of every CU size of a variable tree at once (interpolation does
    not depend on where the block starts, so MC per 8x8 cell equals MC
    per CU).  Returns (pred_y (H, W), pred_cb, pred_cr) int32."""
    h8, w8 = mv_cells.shape[:2]
    x0s, y0s = _cell_origins(h8, w8, mv_cells.device)
    mvs = mv_cells.reshape(h8 * w8, 2).to(torch.int32)
    out_y = _blocks_to_plane(mc_luma(ref_y.to(torch.int32), x0s, y0s, mvs,
                                     8, bitdepth), h8, w8, 8)
    if ref_cb is None:
        return out_y, None, None
    return (out_y,) + tuple(
        _blocks_to_plane(mc_chroma(p.to(torch.int32), x0s // 2, y0s // 2,
                                   mvs, 4, bitdepth), h8, w8, 4)
        for p in (ref_cb, ref_cr))


def merge_satd_maps_p(yp, ref_y, cand_cells, cur_cells,
                      bitdepth: int = 8) -> torch.Tensor:
    """Per-cell 8x8 SATD of each P merge-candidate motion field and of
    the searched one.  yp: (H, W) source luma; cand_cells: (K, h8, w8,
    2) quarter-pel; cur_cells: (h8, w8, 2).  Returns (K+1, h8, w8)
    int32, the searched field last."""
    h8, w8 = cur_cells.shape[:2]
    yp = yp.to(torch.int32)
    outs = []
    for mv in list(cand_cells) + [cur_cells]:
        py, _, _ = mc_planes_cells(ref_y, None, None, mv, bitdepth)
        d = (py - yp).reshape(h8, 8, w8, 8).permute(0, 2, 1, 3)
        outs.append(satd8_batch(d))
    return torch.stack(outs)


def mc_planes_hp(ref_y, ref_cb, ref_cr, mv, plan: IntraFramePlan,
                 bitdepth: int = 8):
    """Full-frame MC at the 14-bit intermediate precision (the bi-pred
    averaging input, 8.5.3.3.4.2).  Returns (hp_y (H, W), hp_cb, hp_cr)
    int32."""
    s = plan.cu_size
    by, bx = plan.blocks_y, plan.blocks_x
    x0s, y0s = _block_origins(plan, mv.device)
    mvs = mv.reshape(by * bx, 2).to(torch.int32)
    py = _blocks_to_plane(mc_luma_hp(ref_y.to(torch.int32), x0s, y0s, mvs,
                                     s, bitdepth), by, bx, s)
    if ref_cb is None:
        return py, None, None
    s2 = s // 2
    return (py,) + tuple(
        _blocks_to_plane(mc_chroma_hp(p.to(torch.int32), x0s // 2,
                                      y0s // 2, mvs, s2, bitdepth),
                         by, bx, s2) for p in (ref_cb, ref_cr))


def bi_check(cur, r0, r1, mv0, mv1, plan: IntraFramePlan,
             lambda_satd: float, bitdepth: int = 8):
    """The bi-pred hypothesis of each CU of plan: the 14-bit L0 and L1
    predictions (N, S, S), their bi average, and its cost ``satd + lambda
    * (both lists' mv rate)``, one multiply-add as XLA's CPU backend
    fuses it.  cur / r0 / r1: (H, W) int32 planes; mv0 / mv1: (By, Bx,
    2).  Returns (cost (By, Bx) float32, hp0, hp1, bi)."""
    s = plan.cu_size
    by, bx = plan.blocks_y, plan.blocks_x
    n = by * bx
    x0s, y0s = _block_origins(plan, cur.device)
    hp0 = mc_luma_hp(r0, x0s, y0s, mv0.reshape(n, 2), s, bitdepth)
    hp1 = mc_luma_hp(r1, x0s, y0s, mv1.reshape(n, 2), s, bitdepth)
    bi = bi_average(hp0, hp1, bitdepth)
    blocks = cur.reshape(by, s, bx, s).permute(0, 2, 1, 3).reshape(n, s, s)
    satd = satd8_batch(bi - blocks).reshape(by, bx)
    p0, p1 = _mv_pred_grid(mv0), _mv_pred_grid(mv1)
    rate = (_mv_bits_est(mv0[..., 0] - p0[..., 0])
            + _mv_bits_est(mv0[..., 1] - p0[..., 1])
            + _mv_bits_est(mv1[..., 0] - p1[..., 0])
            + _mv_bits_est(mv1[..., 1] - p1[..., 1]))
    return (_fma_f32(satd.to(torch.float32), lambda_satd, rate), hp0, hp1,
            bi)


def _select_dirs(h0, h1, dirs, size: int, bitdepth: int):
    """Final prediction samples of 14-bit L0 / L1 planes under a per-block
    direction grid (0 = L0, 1 = L1, 2 = BI) of ``size``-pixel blocks."""
    if h0 is None:
        return None
    d = torch.repeat_interleave(torch.repeat_interleave(dirs, size, dim=0),
                                size, dim=1)
    return torch.where(d == 0, uni_round(h0, bitdepth),
                       torch.where(d == 1, uni_round(h1, bitdepth),
                                   bi_average(h0, h1, bitdepth)))


def bi_mc_planes(ref0, ref1, mv0, mv1, dirs, plan: IntraFramePlan,
                 bitdepth: int = 8):
    """Prediction planes of a fixed-grid B frame: each CU's L0, L1 or BI
    prediction with the spec's rounding.  ref0/ref1: (y, cb, cr) planes;
    mv0/mv1: (By, Bx, 2) quarter-pel; dirs: (By, Bx) 0/1/2."""
    s = plan.cu_size
    hp0 = mc_planes_hp(*ref0, mv0, plan, bitdepth)
    hp1 = mc_planes_hp(*ref1, mv1, plan, bitdepth)
    return tuple(_select_dirs(a, b, dirs, n, bitdepth)
                 for a, b, n in zip(hp0, hp1, (s, s // 2, s // 2)))


def bi_mc_planes_cells(ref0, ref1, mv0_cells, mv1_cells, dirs8,
                       bitdepth: int = 8):
    """Prediction planes of a variable B tree from its 8x8-cell motion
    fields: ref0/ref1 (y, cb, cr) planes (cb/cr None for luma only),
    mv0/mv1_cells (h8, w8, 2) quarter-pel, dirs8 (h8, w8) 0 = L0, 1 = L1,
    2 = BI.  Returns (pred_y, pred_cb, pred_cr) int32."""
    h8, w8 = dirs8.shape
    x0s, y0s = _cell_origins(h8, w8, dirs8.device)
    mv0 = mv0_cells.reshape(h8 * w8, 2).to(torch.int32)
    mv1 = mv1_cells.reshape(h8 * w8, 2).to(torch.int32)

    def hp(plane, mvs, luma):
        if luma:
            return _blocks_to_plane(mc_luma_hp(plane.to(torch.int32), x0s,
                                               y0s, mvs, 8, bitdepth),
                                    h8, w8, 8)
        return _blocks_to_plane(mc_chroma_hp(plane.to(torch.int32),
                                             x0s // 2, y0s // 2, mvs, 4,
                                             bitdepth), h8, w8, 4)

    out_y = _select_dirs(hp(ref0[0], mv0, True), hp(ref1[0], mv1, True),
                         dirs8, 8, bitdepth)
    if ref0[1] is None:
        return out_y, None, None
    return (out_y,) + tuple(
        _select_dirs(hp(ref0[k], mv0, False), hp(ref1[k], mv1, False),
                     dirs8, 4, bitdepth) for k in (1, 2))


def merge_satd_maps_b(yp, ref0_y, ref1_y, cand_d, cand_m0, cand_m1,
                      cur_d, cur_m0, cur_m1,
                      bitdepth: int = 8) -> torch.Tensor:
    """B form of merge_satd_maps_p: each hypothesis carries full motion
    (dir, mv0, mv1).  cand_d: (K, h8, w8); cand_m0/m1: (K, h8, w8, 2).
    Returns (K+1, h8, w8) int32 per-cell SATD, the searched field last."""
    h8, w8 = cur_d.shape
    yp = yp.to(torch.int32)
    triples = [(cand_d[i], cand_m0[i], cand_m1[i])
               for i in range(cand_d.shape[0])]
    outs = []
    for dd, m0, m1 in triples + [(cur_d, cur_m0, cur_m1)]:
        py, _, _ = bi_mc_planes_cells((ref0_y, None, None),
                                      (ref1_y, None, None), m0, m1, dd,
                                      bitdepth)
        d = (py - yp).reshape(h8, 8, w8, 8).permute(0, 2, 1, 3)
        outs.append(satd8_batch(d))
    return torch.stack(outs)
