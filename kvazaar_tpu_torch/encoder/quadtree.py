"""Variable-CU quadtree search + data-driven wavefront reconstruction,
for I frames, P frames with one reference and B frames with one
reference per list.

Counterpart of kvazaar_tpu/encoder/quadtree.py.  The search evaluates
every candidate CU size over the whole frame (open-loop mode searches at
8, 16 and 32, the 64 level as four same-mode 32x32 TBs; in P frames also
the hinted motion search at every inter size and 64, in B frames that
search against each list and a bi-pred check), costs each candidate in
RD units (luma roundtrip SSD + lambda * modelled bits + per-CU syntax
bins; an inter size keeps the better of its intra and inter candidate)
and the host picks the tree by
a bottom-up argmin (``choose_tree``, numpy).  encoder/var_schedule.py
plans the tree's wavefront on the host, and ``reconstruct_frame_var``
runs it on the encoder's device as plain tensor code: one step at a
time, each CU-size class of the step gathering its reference samples
from flat edge buffers, predicting its coded mode, running the TU
roundtrip (with RDOQ and sign hiding when the config sets them) and
writing back its bottom row and right column.

Edge state as in the JAX package: every reference sample of any CU sits
on a row y % 8 == 7 (a CU bottom row, the h buffer) or a column
x % 8 == 7 (a CU right column, the v buffer), at 4-pixel granularity
for chroma.  Here the h and v buffers of a component share one flat
tensor with a trailing mid-grey sample, so each slot's 4S+1 reference
samples (8.4.4.2.2 substitution and the no-neighbour case resolved into
the indices once per frame) are one gather; Cb and Cr ride one merged
class pass per size, as in the JAX package (which runs them apart under a
scaling list; here each block then takes its component's tables, with
the same result).  A step runs only the
classes and slots it holds, so padded schedule slots cost nothing.  In
a P tree the inter CUs take no wavefront step: they reconstruct first,
in one batch per size (the direct pass), and fill the edge buffers the
intra CUs read; a B tree's prediction planes carry each cell's L0, L1
or bi-averaged MC.
"""

from __future__ import annotations

import functools
import types

import numpy as np
import torch

from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
from kvazaar_tpu_torch.encoder.inter_search import (_mv_bits_est,
                                                    _mv_pred_grid, bi_check,
                                                    search_inter_frame)
from kvazaar_tpu_torch.encoder.intra_recon import _scan_sel, _tu_roundtrip
from kvazaar_tpu_torch.encoder.intra_search import (_f32, _ssd_f32,
                                                    modes64_from_satd32,
                                                    rd_cost_given_modes,
                                                    search_frame_modes)
from kvazaar_tpu_torch.ops.inter import coarse_mv_grids, mc_luma, uni_round
from kvazaar_tpu_torch.ops.intra import predict_modes
from kvazaar_tpu_torch.ops.quant import (_fma_f32, dequantize, quantize,
                                         scaling_tables)
from kvazaar_tpu_torch.ops.rate import tb_rate_bits
from kvazaar_tpu_torch.ops.transform import (forward_transform,
                                             inverse_transform)

SIZES = (8, 16, 32)

# Context-bin counts of the CU-level syntax not carried by the TB rate
# model (the JAX package's constants): intra = part/pred flags (~1) +
# intra_chroma_pred_mode (~1.5) + chroma cbfs (2); inter = merge_flag
# (1) + rqt_root_cbf (1) + chroma cbfs (2).
OVERHEAD_BINS_INTRA = 4.5
OVERHEAD_BINS_INTER = 4.0
INTRA_MODE_BINS = 2.5      # MPM-weighted average of mpm_idx/rem coding
SPLIT_FLAG_BINS = 1.0
# Extra structure bins a one-level TU split (--tr-depth-intra) pays over
# a single TB: 3 extra cbf_luma + ~2 chroma-cbf re-codings.
TU_SPLIT_EXTRA_BINS = 5.0


def _plus_bins(cost: torch.Tensor, lam_rd: float, bins: float):
    """float32 ``cost + lam_rd * bins`` as the JAX package forms it: the
    scalar product is rounded to float32 first (XLA computes it once,
    outside the elementwise loop, so it is not fused into the add)."""
    return cost + _f32(_f32(lam_rd) * _f32(bins))


def intra_rd_recost(y, plan, modes_grid, qp, lam_rd, bitdepth,
                    p_slice: bool = False):
    """Intra RD-unit cost grid for the winner modes: luma roundtrip +
    mode bins + CU overhead bins (+ pred_mode_flag in P slices)."""
    return _plus_bins(rd_cost_given_modes(y, plan, modes_grid, qp, lam_rd,
                                          bitdepth),
                      lam_rd, INTRA_MODE_BINS + OVERHEAD_BINS_INTRA
                      + (1.0 if p_slice else 0.0))


def _sum4_64(cg: torch.Tensor, by64: int, bx64: int) -> torch.Tensor:
    """float32 sum of each CU's four half-size grid entries, left to
    right in z order, over the (by64, bx64) CUs (the full 64 CUs of a 32
    grid, or the 16 / 32 CUs of a TU split)."""
    return (cg[0::2, 0::2][:by64, :bx64] + cg[0::2, 1::2][:by64, :bx64]
            + cg[1::2, 0::2][:by64, :bx64] + cg[1::2, 1::2][:by64, :bx64])


def _intra64_cost(y, width, height, modes64, qp, lam_rd, bitdepth,
                  p_slice: bool):
    """RD-unit cost of each full 64 CU coded intra with its 64 mode: the
    four 32x32 TBs (a forced TU split, 7.3.8.8) roundtripped with that
    mode, plus the CU's bins."""
    plan32 = make_intra_plan(width, height, 32, chroma=False)
    by64, bx64 = modes64.shape
    pad = torch.zeros((plan32.blocks_y, plan32.blocks_x),
                      dtype=torch.int32, device=y.device)
    pad[:2 * by64, :2 * bx64] = torch.repeat_interleave(
        torch.repeat_interleave(modes64, 2, dim=0), 2, dim=1)
    cg = rd_cost_given_modes(y, plan32, pad, qp, lam_rd, bitdepth)
    return _plus_bins(_sum4_64(cg, by64, bx64), lam_rd,
                      INTRA_MODE_BINS + OVERHEAD_BINS_INTRA
                      + (1.0 if p_slice else 0.0))


def search_quadtree(y, width: int, height: int, lambda_satd: float,
                    bitdepth: int = 8, min_cu: int = 8, max_cu: int = 32,
                    two_pass: bool = True, rdo: bool = False,
                    qp: int = 30, lam_rd: float | None = None,
                    tu_split: bool = False):
    """Open-loop mode search at every candidate CU size (device part).

    y: (H, W) int32 coded-size luma.  Returns (costs, modes): dicts
    size -> (H/s, W/s) float32 cost / int32 mode grids on y's device, in
    RD units (SATD-searched modes re-costed by a roundtrip at rd <= 1;
    the rd 2 search's roundtrip costs as they are).  The 64 level (full
    CTUs only) is the best single mode over the four 32x32 TBs' SATDs,
    costed by roundtripping those TBs with it.  tu_split
    (--tr-depth-intra 1) adds a third dict, tucosts: each 16 and 32 CU
    (whose half size is in the tree) costed as four half-size TBs that
    share its mode, on the half size's plan, plus the CU's bins and
    TU_SPLIT_EXTRA_BINS (the JAX package's ``search_quadtree``)."""
    if lam_rd is None:
        lam_rd = lambda_satd * lambda_satd
    costs, modes = {}, {}
    for s in SIZES:
        if s < min_cu or s > max_cu:
            continue
        plan = make_intra_plan(width, height, s, chroma=False)
        if s == 32 and max_cu >= 64:
            m, c, satd32 = search_frame_modes(
                y, plan, lambda_satd, bitdepth, two_pass,
                return_satd=True, rdo=rdo, qp=qp, lam_rd=lam_rd)
            m64, _c64 = modes64_from_satd32(satd32, lambda_satd, two_pass)
            modes[64] = m64
            costs[64] = _intra64_cost(y, width, height, m64, qp, lam_rd,
                                      bitdepth, p_slice=False)
        else:
            m, c = search_frame_modes(y, plan, lambda_satd, bitdepth,
                                      two_pass, rdo=rdo, qp=qp,
                                      lam_rd=lam_rd)
        modes[s] = m
        if rdo:
            costs[s] = _plus_bins(c, lam_rd, OVERHEAD_BINS_INTRA)
        else:
            costs[s] = intra_rd_recost(y, plan, m, qp, lam_rd, bitdepth)
    if not tu_split:
        return costs, modes
    tucosts = {}
    for s in (16, 32):
        if s not in modes or s // 2 < min_cu:
            continue
        plan_h = make_intra_plan(width, height, s // 2, chroma=False)
        by, bx = modes[s].shape
        pad = torch.zeros((plan_h.blocks_y, plan_h.blocks_x),
                          dtype=torch.int32, device=y.device)
        pad[:2 * by, :2 * bx] = torch.repeat_interleave(
            torch.repeat_interleave(modes[s], 2, dim=0), 2, dim=1)
        cg = rd_cost_given_modes(y, plan_h, pad, qp, lam_rd, bitdepth)
        tucosts[s] = _plus_bins(_sum4_64(cg, by, bx), lam_rd,
                                INTRA_MODE_BINS + OVERHEAD_BINS_INTRA
                                + TU_SPLIT_EXTRA_BINS)
    return costs, modes, tucosts


def choose_tree(costs: dict, width: int, height: int,
                lambda_satd: float, percu_bits: float = 0.0,
                split_bits: float = 1.0,
                tucosts: dict | None = None) -> np.ndarray:
    """Bottom-up tree argmin (host numpy).  Per-CU costs arrive in RD
    units with their own syntax-overhead bins included (roundtrip
    recost in the searches — the TPU form of the reference comparing
    kvz_cu_rd_cost at every depth, src/search.c:236,424); the argmin
    adds only the split-flag bins per split.  Returns size8
    (H/8, W/8) uint8 — or (size8, trsplit8) when tucosts is given
    (--tr-depth-intra: each 16/32 candidate enters the argmin at
    min(whole-TB, four-half-TB) cost and the winner's TU choice is
    recorded)."""
    percu = lambda_satd * percu_bits
    split = lambda_satd * split_bits
    c = {s: np.asarray(v).astype(np.float64) for s, v in costs.items()}
    tr_pick = {}
    if tucosts:
        for s, tc in tucosts.items():
            if s not in c:
                continue
            tc = np.asarray(tc).astype(np.float64)
            pick = tc < c[s]
            c[s] = np.where(pick, tc, c[s])
            tr_pick[s] = pick
    use8 = None
    if 8 in c and 16 in c:
        c8sum = (c[8][0::2, 0::2] + c[8][0::2, 1::2]
                 + c[8][1::2, 0::2] + c[8][1::2, 1::2] + 3 * percu)
        use8 = c8sum + split < c[16]
        c16 = np.where(use8, c8sum + split, c[16])
    elif 16 in c:
        c16 = c[16]
        use8 = np.zeros_like(c16, bool)
    use16 = None
    c32 = None
    if 32 in c and 16 in c:
        c16sum = (c16[0::2, 0::2] + c16[0::2, 1::2]
                  + c16[1::2, 0::2] + c16[1::2, 1::2] + 3 * percu)
        use16 = c16sum + split < c[32]
        c32 = np.where(use16, c16sum + split, c[32])
    elif 32 in c:
        c32 = c[32]
    elif 16 in c:
        use16 = np.ones((c16.shape[0] // 2, c16.shape[1] // 2), bool)

    # 64x64 level: full CTUs only (boundary CTUs take inferred splits).
    use32 = None
    if 64 in c and c32 is not None:
        by64, bx64 = c[64].shape
        c32sum = (c32[0::2, 0::2][:by64, :bx64]
                  + c32[0::2, 1::2][:by64, :bx64]
                  + c32[1::2, 0::2][:by64, :bx64]
                  + c32[1::2, 1::2][:by64, :bx64] + 3 * percu)
        use32 = c32sum + split < c[64]

    h8, w8 = height // 8, width // 8
    top = 32 if 32 in c else 16
    size8 = np.full((h8, w8), top, np.int32)
    eff32 = np.ones((h8, w8), bool)
    if use32 is not None:
        u64 = np.zeros((h8, w8), bool)
        full = np.kron(~use32, np.ones((8, 8), bool))
        u64[:full.shape[0], :full.shape[1]] = full
        size8 = np.where(u64, 64, size8)
        eff32 = ~u64
    if use16 is not None and 32 in c:
        u16 = np.kron(use16, np.ones((4, 4), bool))[:h8, :w8]
        size8 = np.where(eff32 & u16, 16, size8)
        eff16 = eff32 & u16
    else:
        eff16 = eff32
    if use8 is not None:
        u8 = np.kron(use8, np.ones((2, 2), bool))[:h8, :w8]
        size8 = np.where(eff16 & u8, 8, size8)
    size8 = size8.astype(np.uint8)
    if tucosts is None:
        return size8
    trsplit8 = np.zeros((h8, w8), np.uint8)
    for s, pick in tr_pick.items():
        cell = s // 8
        up = np.kron(pick, np.ones((cell, cell), bool))[:h8, :w8]
        trsplit8 = np.where((size8 == s) & up, 1, trsplit8
                            ).astype(np.uint8)
    return size8, trsplit8


# ---------------------------------------------------------------------
# P-frame search: dense motion search at every candidate CU size and a
# per-size intra-vs-inter argmin in RD units; choose_tree then picks the
# tree over the combined costs.
# ---------------------------------------------------------------------

def tb_rd_cost(resid, s: int, qp, lam_rd, bitdepth: int, intra: bool):
    """(N,) float32 luma roundtrip RD cost of (N, S, S) int32 residuals:
    SSD + lam_rd * modelled TB bits (S <= 32)."""
    levels = quantize(forward_transform(resid, s, bitdepth), qp, s,
                      bitdepth, intra=intra)
    rrec = inverse_transform(dequantize(levels, qp, s, bitdepth), s,
                             bitdepth)
    return _fma_f32(_ssd_f32(rrec - resid), lam_rd, tb_rate_bits(levels))


def inter_rd_grid(y, pred_blocks, s: int, by: int, bx: int, qp, lam_rd,
                  bitdepth: int):
    """(By, Bx) inter RD cost grid of MC prediction blocks (N, S, S); a
    64 CU is four 32x32 TBs (the largest transform)."""
    n = by * bx
    orig = y[:by * s, :bx * s].to(torch.int32).reshape(
        by, s, bx, s).permute(0, 2, 1, 3).reshape(n, s, s)
    resid = orig - pred_blocks
    if s <= 32:
        return tb_rd_cost(resid, s, qp, lam_rd, bitdepth,
                          intra=False).reshape(by, bx)
    r4 = resid.reshape(n, 2, 32, 2, 32).permute(0, 1, 3, 2, 4)
    c4 = tb_rd_cost(r4.reshape(n * 4, 32, 32), 32, qp, lam_rd, bitdepth,
                    intra=False).reshape(by, bx, 4)
    return ((c4[..., 0] + c4[..., 1]) + c4[..., 2]) + c4[..., 3]


def _mc_blocks_at(ref, mvs_grid, s: int, bitdepth: int):
    """Uni-pred MC luma blocks (N, S, S) at a per-CU MV grid."""
    by, bx = mvs_grid.shape[:2]
    ys, xs = np.mgrid[0:by, 0:bx]
    dev = mvs_grid.device
    return mc_luma(ref.to(torch.int32),
                   torch.from_numpy((xs * s).reshape(-1)).to(dev),
                   torch.from_numpy((ys * s).reshape(-1)).to(dev),
                   mvs_grid.reshape(by * bx, 2), s, bitdepth)


def _mv_rate_grid(mvs_grid):
    p = _mv_pred_grid(mvs_grid)
    return (_mv_bits_est(mvs_grid[..., 0] - p[..., 0])
            + _mv_bits_est(mvs_grid[..., 1] - p[..., 1]))


def _inf_grid(width, height, s, dev):
    return torch.full((height // s, width // s), float("inf"),
                      dtype=torch.float32, device=dev)


@functools.lru_cache(maxsize=None)
def _plan64(width: int, height: int):
    """The 64 grid over the 64-aligned crop (CTUs at the picture's
    border take inferred splits, so no 64 CU reaches them)."""
    w64, h64 = (width // 64) * 64, (height // 64) * 64
    return types.SimpleNamespace(cu_size=64, blocks_y=h64 // 64,
                                 blocks_x=w64 // 64, width=w64,
                                 height=h64), w64, h64


def _inter_cost(y, ref_y, plan, hint, lambda_satd, me_range, bitdepth,
                subpel, qp, lam_rd):
    """(mv grid, RD-unit cost grid) of the inter candidate at one size:
    the hinted search, the MC blocks' roundtrip, the mv rate, merge_flag
    and the CU's bins."""
    s = plan.cu_size
    mv, _ = search_inter_frame(y, ref_y, plan, lambda_satd, me_range,
                               bitdepth, subpel=subpel, mv_hint=hint)
    er = inter_rd_grid(y, _mc_blocks_at(ref_y, mv, s, bitdepth), s,
                       plan.blocks_y, plan.blocks_x, qp, lam_rd, bitdepth)
    return mv, _fma_f32(er, lam_rd,
                        _mv_rate_grid(mv) + 1.0 + OVERHEAD_BINS_INTER)


def _intra_candidates(y, width: int, height: int, sizes, intra_rng,
                      want64: bool, lambda_satd: float, bitdepth: int,
                      two_pass: bool, qp, lam_rd) -> dict:
    """The intra candidate of a P or B frame at each CU size in sizes,
    and at 64 where want64 and the frame holds a full 64 CU: size ->
    (modes, RD-unit cost grid), the cost +inf outside the intra range
    (the 64 modes are the best single mode over four 32x32 TBs)."""
    dev = y.device
    out = {}
    modes64 = None
    for s in sizes:
        plan = make_intra_plan(width, height, s, chroma=False)
        if not intra_rng[0] <= s <= intra_rng[1]:
            out[s] = (torch.zeros((height // s, width // s),
                                  dtype=torch.int32, device=dev),
                      _inf_grid(width, height, s, dev))
            continue
        if s == 32 and want64 and intra_rng[1] >= 64:
            m, _ic, satd32 = search_frame_modes(
                y, plan, lambda_satd, bitdepth, two_pass, return_satd=True)
            modes64, _c64 = modes64_from_satd32(satd32, lambda_satd,
                                                two_pass)
        else:
            m, _ic = search_frame_modes(y, plan, lambda_satd, bitdepth,
                                        two_pass)
        out[s] = (m, intra_rd_recost(y, plan, m, qp, lam_rd, bitdepth,
                                     p_slice=True))
    if want64 and width // 64 and height // 64:
        plan64, w64, h64 = _plan64(width, height)
        if modes64 is not None and intra_rng[1] >= 64:
            out[64] = (modes64, _intra64_cost(y, width, height, modes64, qp,
                                              lam_rd, bitdepth, p_slice=True))
        else:
            out[64] = (torch.zeros((plan64.blocks_y, plan64.blocks_x),
                                   dtype=torch.int32, device=dev),
                       _inf_grid(w64, h64, 64, dev))
    return out


def _inter_sizes(sizes, inter_rng, width: int, height: int):
    """The CU sizes an inter frame searches motion at: the inter range's
    of sizes, and 64 where the range reaches it and the frame holds a
    full 64 CU."""
    out = [s for s in sizes if inter_rng[0] <= s <= inter_rng[1]]
    if inter_rng[1] >= 64 and width // 64 and height // 64:
        out.append(64)
    return out


def search_quadtree_p(y, ref_y, width: int, height: int,
                      lambda_satd: float, me_range: int, bitdepth: int = 8,
                      intra_rng=(8, 32), inter_rng=(8, 32),
                      two_pass: bool = True, subpel: bool = True, qp=30,
                      lam_rd=None):
    """Device search of a P variable tree.  Returns per-size dicts (64
    included where a range reaches it and the frame holds a full 64
    CU): costs (RD units, the better of the intra and the inter
    candidate; ties go to inter), modes (intra winners), mvs (quarter-
    pel, zero where intra wins), inter_maps.  A size outside a tool's
    range costs +inf for that tool."""
    if lam_rd is None:
        lam_rd = lambda_satd * lambda_satd
    dev = y.device
    y = y.to(torch.int32)
    ref_y = ref_y.to(torch.int32)
    sizes = [s for s in SIZES if (intra_rng[0] <= s <= intra_rng[1]
                                  or inter_rng[0] <= s <= inter_rng[1])]
    intra = _intra_candidates(y, width, height, sizes, intra_rng,
                              intra_rng[1] >= 64 or inter_rng[1] >= 64,
                              lambda_satd, bitdepth, two_pass, qp, lam_rd)
    # Hierarchical motion search: one pooled pass for the whole size
    # ladder, refined at full resolution in search_inter_frame.
    inter_sizes = _inter_sizes(sizes, inter_rng, width, height)
    hints = (coarse_mv_grids(y, ref_y, me_range, tuple(inter_sizes),
                             bitdepth) if inter_sizes else {})
    costs, modes, mvs, imaps = {}, {}, {}, {}
    for s, (m, ir) in intra.items():
        if s in inter_sizes and s < 64:
            plan = make_intra_plan(width, height, s, chroma=False)
            mv, er = _inter_cost(y, ref_y, plan, hints[s], lambda_satd,
                                 me_range, bitdepth, subpel, qp, lam_rd)
        elif s in inter_sizes:
            plan64, w64, h64 = _plan64(width, height)
            mv, _ = search_inter_frame(
                y[:h64, :w64], ref_y[:h64, :w64], plan64, lambda_satd,
                me_range, bitdepth, subpel=subpel, mv_hint=hints[64])
            er = _fma_f32(
                inter_rd_grid(y[:h64, :w64],
                              _mc_blocks_at(ref_y, mv, 64, bitdepth), 64,
                              plan64.blocks_y, plan64.blocks_x, qp, lam_rd,
                              bitdepth),
                lam_rd, _mv_rate_grid(mv) + 1.0 + OVERHEAD_BINS_INTER)
        else:
            mv = torch.zeros(m.shape + (2,), dtype=torch.int32, device=dev)
            er = torch.full_like(ir, float("inf"))
        imap = er <= ir
        costs[s] = torch.where(imap, er, ir)
        modes[s] = m
        mvs[s] = torch.where(imap[..., None], mv, 0).to(torch.int32)
        imaps[s] = imap
    return costs, modes, mvs, imaps


def _bi_inter_at(cur, r0, r1, plan, hints, lambda_satd, me_range, bitdepth,
                 subpel, bipred, qp, lam_rd):
    """The B inter candidate at one size: the hinted search against each
    list, the bi-pred SATD check (``satd + lambda * (both lists' mv
    rate)``, one multiply-add; +inf with bipred off), the first-index
    argmin over (L0, L1, BI), and the RD-unit cost of the chosen
    prediction (roundtrip + the chosen lists' mv rate + inter_pred_idc
    (2) + merge_flag (1) + the CU's bins).  Returns (mv0, mv1, dirs,
    cost) grids."""
    s = plan.cu_size
    by, bx = plan.blocks_y, plan.blocks_x
    mv0, c0 = search_inter_frame(cur, r0, plan, lambda_satd, me_range,
                                 bitdepth, subpel=subpel, mv_hint=hints[0])
    mv1, c1 = search_inter_frame(cur, r1, plan, lambda_satd, me_range,
                                 bitdepth, subpel=subpel, mv_hint=hints[1])
    cbi, hp0, hp1, bi = bi_check(cur, r0, r1, mv0, mv1, plan, lambda_satd,
                                 bitdepth)
    if not bipred:
        cbi = torch.full_like(c0, float("inf"))
    dirs = torch.argmin(torch.stack([c0, c1, cbi]), dim=0).to(torch.int32)
    r0b, r1b = _mv_rate_grid(mv0), _mv_rate_grid(mv1)
    dn = dirs.reshape(by * bx, 1, 1)
    pred = torch.where(dn == 0, uni_round(hp0, bitdepth),
                       torch.where(dn == 1, uni_round(hp1, bitdepth), bi))
    rate = torch.where(dirs == 0, r0b, torch.where(dirs == 1, r1b,
                                                   r0b + r1b))
    er = inter_rd_grid(cur, pred, s, by, bx, qp, lam_rd, bitdepth)
    return mv0, mv1, dirs, _fma_f32(er, lam_rd, rate + 2.0 + 1.0
                                    + OVERHEAD_BINS_INTER)


def search_quadtree_b(y, r0_y, r1_y, width: int, height: int,
                      lambda_satd: float, me_range: int, bitdepth: int = 8,
                      intra_rng=(8, 32), inter_rng=(8, 32),
                      two_pass: bool = True, subpel: bool = True,
                      bipred: bool = True, qp=30, lam_rd=None):
    """Device search of a B variable tree: per size (64 included as in
    search_quadtree_p) the intra candidate and the B inter candidate of
    ``_bi_inter_at`` (a hinted L0 and L1 search, one pooled hint pass per
    list for the whole size ladder); ties go to inter.  Returns per-size
    dicts (costs, modes, mv0s, mv1s, dirs, inter maps), the MVs and dirs
    zero where intra wins."""
    if lam_rd is None:
        lam_rd = lambda_satd * lambda_satd
    dev = y.device
    y = y.to(torch.int32)
    r0_y = r0_y.to(torch.int32)
    r1_y = r1_y.to(torch.int32)
    sizes = [s for s in SIZES if (intra_rng[0] <= s <= intra_rng[1]
                                  or inter_rng[0] <= s <= inter_rng[1])]
    intra = _intra_candidates(y, width, height, sizes, intra_rng,
                              intra_rng[1] >= 64 or inter_rng[1] >= 64,
                              lambda_satd, bitdepth, two_pass, qp, lam_rd)
    inter_sizes = _inter_sizes(sizes, inter_rng, width, height)
    hints = [coarse_mv_grids(y, r, me_range, tuple(inter_sizes), bitdepth)
             if inter_sizes else {} for r in (r0_y, r1_y)]
    out = ({}, {}, {}, {}, {}, {})
    for s, (m, ir) in intra.items():
        if s in inter_sizes:
            if s < 64:
                plan, cur, r0, r1 = (make_intra_plan(width, height, s,
                                                     chroma=False),
                                     y, r0_y, r1_y)
            else:
                plan, w64, h64 = _plan64(width, height)
                cur, r0, r1 = (p[:h64, :w64] for p in (y, r0_y, r1_y))
            mv0, mv1, dirs, er = _bi_inter_at(
                cur, r0, r1, plan, (hints[0][s], hints[1][s]), lambda_satd,
                me_range, bitdepth, subpel, bipred, qp, lam_rd)
        else:
            mv0 = mv1 = torch.zeros(m.shape + (2,), dtype=torch.int32,
                                    device=dev)
            dirs = torch.zeros_like(m)
            er = torch.full_like(ir, float("inf"))
        imap = er <= ir
        for d, v in zip(out, (torch.where(imap, er, ir), m,
                              torch.where(imap[..., None], mv0, 0),
                              torch.where(imap[..., None], mv1, 0),
                              torch.where(imap, dirs, 0), imap)):
            d[s] = v
    return out


def build_cell_fields(size8: np.ndarray, imaps: dict, mv_grids: dict,
                      extra_grids: tuple = ()):
    """Expand per-size CU decisions onto the 8x8-cell grid following
    the chosen tree: inter8 (h8, w8) bool, mv_cells (h8, w8, 2) int32,
    plus one expanded grid per entry of extra_grids (each a dict
    size -> (H/s, W/s[, 2]) array).  Owner lookups are at CU origins
    (cells are z-aligned)."""
    h8, w8 = size8.shape
    inter8 = np.zeros((h8, w8), bool)
    mv_cells = np.zeros((h8, w8, 2), np.int32)
    extras = []
    for g in extra_grids:
        sample = next(iter(g.values()))
        shape = (h8, w8) + sample.shape[2:]
        extras.append(np.zeros(shape, sample.dtype))
    for s in sorted(imaps.keys()):
        c = s // 8
        sel = size8 == s                      # cell-filled owner mask
        if not sel.any():
            continue
        oy = (np.arange(h8) // c)
        ox = (np.arange(w8) // c)

        # Per-size grids may be cropped (64 level): pad with zeros.
        def up(grid):
            g = np.asarray(grid)
            gy, gx = g.shape[0], g.shape[1]
            out = np.zeros((h8,) + (w8,) + g.shape[2:], g.dtype)
            yy = np.minimum(oy, gy - 1)
            xx = np.minimum(ox, gx - 1)
            filled = g[np.ix_(yy, xx)]
            valid = ((oy < gy)[:, None] & (ox < gx)[None, :])
            out[valid] = filled[valid]
            return out
        im = up(imaps[s]).astype(bool)
        inter8 = np.where(sel, im, inter8)
        mvu = up(mv_grids[s])
        mv_cells = np.where(sel[..., None] & im[..., None], mvu,
                            mv_cells)
        for i, g in enumerate(extra_grids):
            gu = up(g[s])
            if gu.ndim == 3:
                extras[i] = np.where(sel[..., None] & im[..., None],
                                     gu, extras[i])
            else:
                extras[i] = np.where(sel & im, gu, extras[i])
    return (inter8, mv_cells) + tuple(extras)


def var_edge_masks(size8: np.ndarray):
    """TU-boundary masks on the 8-cell grid for a variable tree:
    edge_v[y, x] = the LEFT edge of cell (y, x) is a TU boundary
    (64 CUs count their forced 32x32 TB edges, 8.7.2)."""
    c = np.minimum((size8 // 8).astype(np.int32), 4)
    x8 = np.arange(size8.shape[1])[None, :]
    y8 = np.arange(size8.shape[0])[:, None]
    return (x8 % c == 0), (y8 % c == 0)


def var_bs_maps(inter8, cbf8, mv_cells, edge_v, edge_h, mv1_cells=None,
                dirs8=None):
    """Deblocking boundary strengths of a variable P or B tree on the 8x8
    cell grid (8.7.2.4): bS 2 where either side is intra, else 1 on a
    coded luma TB or an MV difference of a sample or more (in a B tree:
    or different directions, the MV rule on each list the first side
    uses), at TU boundaries only (PU edges are CU edges: 2Nx2N).
    Tensors on one device: inter8 / cbf8 / edge masks (h8, w8) bool,
    mv_cells / mv1_cells (h8, w8, 2), dirs8 (h8, w8) 0/1/2."""
    intra8 = ~inter8

    def edge(sl_a, sl_b, mask):
        cbf = cbf8[sl_a] | cbf8[sl_b]
        mvd = torch.any(torch.abs(mv_cells[sl_a] - mv_cells[sl_b]) >= 4,
                        dim=-1)
        if mv1_cells is not None:
            d_a = dirs8[sl_a]
            d1 = torch.any(torch.abs(mv1_cells[sl_a] - mv1_cells[sl_b])
                           >= 4, dim=-1)
            mvd = ((d_a != dirs8[sl_b]) | ((d_a != 1) & mvd)
                   | ((d_a != 0) & d1))
        bs = torch.where(intra8[sl_a] | intra8[sl_b], 2,
                         torch.where(cbf | mvd, 1, 0)).to(torch.int32)
        return torch.where(mask, bs, 0)

    h8, w8 = inter8.shape
    all_ = slice(None)
    bs_v = torch.zeros((h8, w8), dtype=torch.int32, device=inter8.device)
    bs_h = torch.zeros((h8, w8), dtype=torch.int32, device=inter8.device)
    bs_v[:, 1:] = edge((all_, slice(0, w8 - 1)), (all_, slice(1, w8)),
                       edge_v[:, 1:])
    bs_h[1:, :] = edge((slice(0, h8 - 1), all_), (slice(1, h8), all_),
                       edge_h[1:, :])
    return bs_v, bs_h


# ---------------------------------------------------------------------
# Data-driven reconstruction.
# ---------------------------------------------------------------------

def _derive(cs: dict, s: int, plane_w: int, plane_h: int, gran: int,
            base: int, comps: int) -> dict:
    """Per-frame index tensors of one class from its compact schedule
    (x0, y0, avail, corner_h: (T, K[, R]) on the device), for ``comps``
    components whose edge buffers follow one another, each
    [h (Lh) | v (Lv) | mid-grey], ``base`` elements apart:

    - ref (T, K, comps, 4S+1): each reference sample's edge-buffer
      index, substitution resolved (8.4.4.2.2), the grey sample for a
      slot with no available neighbour;
    - wr (T, K, comps, 2S): edge-buffer indices of the slot's bottom row
      then right column;
    - pix (T, K, S*S): the slot's sample positions in its plane."""
    dev = cs["x0"].device
    x0 = cs["x0"].to(torch.int64)[..., None]
    y0 = cs["y0"].to(torch.int64)[..., None]
    r = 4 * s + 1
    i_r = torch.arange(r, device=dev)
    xs_r = torch.where(i_r <= 2 * s, x0 - 1, x0 + (i_r - (2 * s + 1)))
    ys_r = torch.where(i_r <= 2 * s, y0 + 2 * s - 1 - i_r, y0 - 1)
    av = cs["avail"] != 0
    noref = ~torch.any(av, dim=-1, keepdim=True)
    # Each sample takes the nearest available one at or before it in
    # spec order; leading unavailable samples take the first available.
    sub = torch.cummax(torch.where(av, i_r, -1), dim=-1).values
    first = torch.argmax(av.to(torch.uint8), dim=-1, keepdim=True)
    sub = torch.where(sub < 0, first, sub)
    sxs = torch.gather(xs_r, -1, sub)
    sys_ = torch.gather(ys_r, -1, sub)
    # Top-arm samples live on their owner's bottom row (h), left-arm
    # samples on its right column (v); the above-left corner routes by
    # the per-CU owner check (corner_h).
    on_h = (sys_ == y0 - 1) & ((sxs >= x0) | cs["corner_h"][..., None])
    lh = (plane_h // gran) * plane_w
    lv = (plane_w // gran) * plane_h
    ref = torch.where(on_h, (sys_ // gran) * plane_w + sxs,
                      lh + (sxs // gran) * plane_h + sys_)
    ref = torch.where(noref, lh + lv, ref)
    ar = torch.arange(s, device=dev)
    wr = torch.cat([((y0 + s - 1) // gran) * plane_w + x0 + ar,
                    lh + ((x0 + s - 1) // gran) * plane_h + y0 + ar],
                   dim=-1)
    comp = torch.arange(comps, device=dev)[:, None] * base
    yy, xx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    off = torch.from_numpy((yy * plane_w + xx).ravel()).to(dev)
    return {"ref": ref[..., None, :] + comp, "wr": wr[..., None, :] + comp,
            "pix": (y0 * plane_w + x0) + off}


def _edge_buffers(width, height, gran, comps, grey, dev):
    """Zeroed flat edge buffers of ``comps`` components, each
    [h | v | grey]; returns (buffer, per-component length)."""
    lh = (height // gran) * width
    lv = (width // gran) * height
    base = lh + lv + 1
    buf = torch.zeros(comps * base, dtype=torch.int32, device=dev)
    buf[base - 1::base] = grey
    return buf, base


def _edge_positions(s: int, dev) -> torch.Tensor:
    """Positions of a block's bottom row then right column in its
    flattened S*S samples."""
    return torch.from_numpy(np.concatenate(
        [(s - 1) * s + np.arange(s), np.arange(s) * s + s - 1])).to(dev)


def _class_pass(d, t, n, s, bitdepth, luma, signhide=False, rdoq=False,
                lam=0.0, lossless=False, program="var"):
    """One wavefront step of one CU-size class: its first n slots (the
    plan fills a step's slots from 0).  Writes the slots' edges into the
    class's edge buffer and returns (levels (n*comps, S, S) int16, rec
    (n*comps, S*S) int32); lossless: transquant bypass; d["sl"]: the
    class's scaling-list tables per component ((comps, S, S) each) or
    None; program: RDOQ's float32 order (ops.quant.quantize_rdoq)."""
    comps = d["ref"].shape[2]
    refs = d["ebuf"][d["ref"][t, :n]].reshape(n * comps, -1)
    modes = d["modes"][t, :n * comps]
    pred = predict_modes(refs, modes, s, luma=luma, bitdepth=bitdepth)
    tab = (None if d["sl"] is None
           else tuple(x.repeat(n, 1, 1) for x in d["sl"]))
    levels, rec = _tu_roundtrip(
        d["origs"][t, :n].reshape(n * comps, s, s), pred, s, d["qp"],
        bitdepth, scan_sel=_scan_sel(modes, s, luma) if signhide else None,
        rdoq=rdoq, lam=lam, lossless=lossless, program=program,
        scaling_tab=tab)
    rec = rec.reshape(n * comps, s * s)
    d["ebuf"][d["wr"][t, :n].reshape(-1)] = rec[:, d["edge"]].reshape(-1)
    return levels, rec


def _block_pix(x0, y0, s: int, plane_w: int):
    """(N, S*S) flat sample positions of blocks at (x0, y0)."""
    dev = x0.device
    yy, xx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    off = torch.from_numpy((yy * plane_w + xx).ravel()).to(dev)
    return (y0.to(torch.int64) * plane_w + x0.to(torch.int64))[:, None] + off


def _mark_cells(cbf8, x0, y0, s: int, cbf):
    """Write each TB's coded flag (N,) over its 8x8 cells of the flat
    (h8 * w8) grid cbf8, w8 = cbf8's row length."""
    c = s // 8
    w8 = cbf8.shape[1]
    cy, cx = np.meshgrid(np.arange(c), np.arange(c), indexing="ij")
    off = torch.from_numpy((cy * w8 + cx).ravel()).to(x0.device)
    cells = ((y0.to(torch.int64) // 8) * w8
             + x0.to(torch.int64) // 8)[:, None] + off
    cbf8.view(-1)[cells.reshape(-1)] = cbf.repeat_interleave(c * c)


def _direct_pass(batches, planes, mcs, pw: int, ph: int, qp: int,
                 bitdepth: int, signhide: bool, rdoq: bool, lam: float,
                 rec, lv, cbf8=None, lossless: bool = False, sl=None,
                 program: str = "var"):
    """Reconstruct the inter CUs of a variable P tree outside the
    wavefront: their prediction is motion-compensated, so each size's
    CUs (batches: size -> (x0, y0) on this plane) run one batched TU
    roundtrip with the inter quantizer.  Writes the flat recon and level
    outputs (components plane after plane) and, for luma (cbf8 given),
    the TBs' coded flags.  lossless: transquant bypass; sl: size ->
    the scaling-list tables per component ((comps, S, S) each) or None;
    program: RDOQ's float32 order."""
    comps = len(planes)
    for s, (x0, y0) in sorted(batches.items()):
        n = x0.numel()
        if n == 0:
            continue
        pix = _block_pix(x0, y0, s, pw)
        out = (pix[None] + torch.arange(comps, device=pix.device)[
            :, None, None] * (pw * ph)).reshape(-1)
        origs = torch.cat([p.reshape(-1)[pix] for p in planes])
        pred = torch.cat([m.reshape(-1)[pix] for m in mcs])
        scan_sel = (torch.zeros(comps * n, dtype=torch.int32,
                                device=pix.device) if signhide else None)
        tab = (None if sl is None
               else tuple(x.repeat_interleave(n, dim=0) for x in sl[s]))
        levels, r = _tu_roundtrip(origs.reshape(comps * n, s, s),
                                  pred.reshape(comps * n, s, s), s, qp,
                                  bitdepth, intra=False, scan_sel=scan_sel,
                                  rdoq=rdoq, lam=lam, lossless=lossless,
                                  program=program, scaling_tab=tab)
        rec[out] = r.reshape(-1)
        lv[out] = levels.reshape(-1)
        if cbf8 is not None:
            _mark_cells(cbf8, x0, y0, s, torch.any(
                levels.reshape(n, -1) != 0, dim=1))


def _prefill_edges(ebuf, base: int, rec, comps: int, pw: int, ph: int,
                   gran: int):
    """Copy every component's bottom rows and right columns of the
    direct pass's recon into the edge buffers, so intra CUs read their
    inter neighbours from step 0."""
    for c in range(comps):
        plane = rec[c * pw * ph:(c + 1) * pw * ph].reshape(ph, pw)
        hrow = plane[gran - 1::gran, :].reshape(-1)
        vcol = plane[:, gran - 1::gran].t().reshape(-1)
        ebuf[c * base:c * base + hrow.numel()] = hrow
        ebuf[c * base + hrow.numel():c * base + base - 1] = vcol


def reconstruct_frame_var(sched: dict, qp: int, qp_c: int, width: int,
                          height: int, chroma: bool, bitdepth: int = 8,
                          signhide: bool = False, rdoq: bool = False,
                          lam: float = 0.0, mc_planes=None,
                          lossless: bool = False, scaling=None):
    """sched: the frame's schedule on the device (see the frame
    encoder's ``var_sched_arrays``): 'luma' / 'chroma': size -> {x0,
    y0, avail, corner_h, modes} (T, K[, R]) over the real steps,
    'counts': (kind, size) -> the host's (T,) numpy slot counts,
    'n_real': T, and the source planes 'plane_y', 'plane_cb', 'plane_cr'
    (int32).  signhide / rdoq: sign-data hiding and RDOQ at lambda lam
    (the same lambda for luma and chroma, as the JAX package passes);
    lossless: transquant bypass (the levels are the residual and the
    reconstruction the source; the trees code no implicit RDPCM, which
    the config refuses with them).  scaling: a scaling list
    (ops.scaling.ScalingLists), each TB quantized with the tables of its
    size, component and intra / inter at its plane's QP; the JAX
    package's variable-tree programs then bake QP and lambda in as
    constants, which gives RDOQ the fixed grid's float32 order
    (``program="grid"``; ROADMAP §3).

    P trees (mc_planes: the (H, W) MC prediction planes (y, cb, cr) of
    the frame's motion field) add 'iluma' / 'ichroma': size -> (x0, y0)
    of the inter CUs, which the plan leaves out of the wavefront (their
    64 CUs as 32x32 TBs).  They reconstruct first, in one batch per
    size, and pre-fill the edge buffers the intra CUs read.

    Returns (rec_y, rec_cb, rec_cr) int32 planes and their levels
    (lv_y, lv_cb, lv_cr) int16 planes (pixel layout); chroma entries are
    None without chroma.  With mc_planes also cbf8, the (H/8, W/8) bool
    grid of each cell's luma TB coded flag (the deblocking bS input)."""
    grey = 1 << (bitdepth - 1)
    dev = sched["plane_y"].device
    wc, hc = width // 2, height // 2
    inter = mc_planes is not None
    # Per plane kind: (plane width, height, edge granularity, components,
    # QP, source planes, MC planes, direct batches); a kind's components
    # share its flat buffers, the edge buffer [h | v | grey] per
    # component and the outputs plane after plane.
    kinds = {"luma": (width, height, 8, 1, qp, [sched["plane_y"]],
                      mc_planes[:1] if inter else None,
                      sched.get("iluma"))}
    if chroma:
        kinds["chroma"] = (wc, hc, 4, 2, qp_c,
                           [sched["plane_cb"], sched["plane_cr"]],
                           mc_planes[1:] if inter else None,
                           sched.get("ichroma"))
    cbf8 = (torch.zeros((height // 8, width // 8), dtype=torch.bool,
                        device=dev) if inter else None)
    program = "var" if scaling is None else "grid"
    outs, classes = {}, []
    for kind, (pw, ph, gran, comps, kqp, planes, mcs,
               direct) in kinds.items():
        sizes = set(sched[kind]) | set(direct or ())
        # size -> the kind's scaling-list tables, stacked over its
        # components: (qc_intra, qc_inter, dqc_intra, dqc_inter), each
        # (comps, S, S).
        sl = None if scaling is None else {
            s: tuple(torch.stack(t) for t in zip(*(
                scaling_tables(scaling, s, c, kqp, dev)
                for c in ((0,) if comps == 1 else (1, 2)))))
            for s in sizes}
        ebuf, base = _edge_buffers(pw, ph, gran, comps, grey, dev)
        rec = torch.zeros(comps * pw * ph, dtype=torch.int32, device=dev)
        lv = torch.zeros(comps * pw * ph, dtype=torch.int16, device=dev)
        outs[kind] = (rec, lv)
        if inter:
            _direct_pass(direct, planes, mcs, pw, ph, kqp, bitdepth,
                         signhide, rdoq, lam, rec, lv,
                         cbf8 if kind == "luma" else None, lossless, sl,
                         program)
            _prefill_edges(ebuf, base, rec, comps, pw, ph, gran)
        for s in sorted(sched[kind]):
            cs = sched[kind][s]
            d = _derive(cs, s, pw, ph, gran, base, comps)
            d.update(ebuf=ebuf, qp=kqp, edge=_edge_positions(s, dev),
                     sl=None if sl is None else sl[s],
                     out=(d["pix"][:, :, None, :] + torch.arange(
                         comps, device=dev)[:, None] * (pw * ph)),
                     # (T, K * comps): each slot's mode per component.
                     modes=cs["modes"].repeat_interleave(comps, dim=1))
            d["origs"] = torch.stack([p.reshape(-1)[d["pix"]]
                                      for p in planes], dim=2)
            classes.append((sched["counts"][(kind, s)], s, d,
                            kind == "luma", rec, lv))

    for t in range(sched["n_real"]):
        for counts, s, d, luma, rec_out, lv_out in classes:
            n = int(counts[t])
            if n == 0:
                continue
            lv, rec = _class_pass(d, t, n, s, bitdepth, luma, signhide,
                                  rdoq, lam, lossless, program)
            out = d["out"][t, :n].reshape(-1)
            rec_out[out] = rec.reshape(-1)
            lv_out[out] = lv.reshape(-1)

    ry, ly = (b.reshape(height, width) for b in outs["luma"])
    if inter:
        # The intra CUs' coded flags, from their level blocks.
        for counts, s, d, luma, _rec, lv_out in classes:
            if not luma:
                continue
            real = torch.from_numpy(np.arange(d["pix"].shape[1])[None]
                                    < counts[:, None]).to(dev)
            _mark_cells(cbf8, sched["luma"][s]["x0"][real],
                        sched["luma"][s]["y0"][real], s, torch.any(
                            lv_out[d["pix"][real]] != 0, dim=1))
    if not chroma:
        recs, levels = (ry, None, None), (ly, None, None)
    else:
        (rcb, rcr), (lcb, lcr) = (b.reshape(2, hc, wc)
                                  for b in outs["chroma"])
        recs, levels = (ry, rcb, rcr), (ly, lcb, lcr)
    return (recs, levels, cbf8) if inter else (recs, levels)
