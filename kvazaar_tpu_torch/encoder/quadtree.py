"""Variable-CU quadtree search + data-driven wavefront reconstruction,
all-intra.

Counterpart of the intra part of kvazaar_tpu/encoder/quadtree.py.  The
search evaluates every candidate CU size over the whole frame (open-loop
mode searches at 8, 16 and 32, the 64 level as four same-mode 32x32
TBs), costs each candidate in RD units (luma roundtrip SSD + lambda *
modelled bits + per-CU syntax bins) and the host picks the tree by a
bottom-up argmin (``choose_tree``, numpy).  encoder/var_schedule.py
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
class pass per size, as in the JAX package.  A step runs only the
classes and slots it holds, so padded schedule slots cost nothing.

Left out (they raise in the frame encoder): the TU-split costs of
--tr-depth-intra, the P/B trees and their direct inter pass, scaling
lists.
"""

from __future__ import annotations

import numpy as np
import torch

from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
from kvazaar_tpu_torch.encoder.intra_recon import _scan_sel, _tu_roundtrip
from kvazaar_tpu_torch.encoder.intra_search import (_f32,
                                                    modes64_from_satd32,
                                                    rd_cost_given_modes,
                                                    search_frame_modes)
from kvazaar_tpu_torch.ops.intra import predict_modes

SIZES = (8, 16, 32)

# Context-bin counts of the CU-level syntax not carried by the TB rate
# model (the JAX package's constants): intra = part/pred flags (~1) +
# intra_chroma_pred_mode (~1.5) + chroma cbfs (2).
OVERHEAD_BINS_INTRA = 4.5
INTRA_MODE_BINS = 2.5      # MPM-weighted average of mpm_idx/rem coding
SPLIT_FLAG_BINS = 1.0


def _plus_bins(cost: torch.Tensor, lam_rd: float, bins: float):
    """float32 ``cost + lam_rd * bins`` as the JAX package forms it: the
    scalar product is rounded to float32 first (XLA computes it once,
    outside the elementwise loop, so it is not fused into the add)."""
    return cost + _f32(_f32(lam_rd) * _f32(bins))


def intra_rd_recost(y, plan, modes_grid, qp, lam_rd, bitdepth):
    """Intra RD-unit cost grid (I slices) for the winner modes: luma
    roundtrip + mode bins + CU overhead bins."""
    return _plus_bins(rd_cost_given_modes(y, plan, modes_grid, qp, lam_rd,
                                          bitdepth),
                      lam_rd, INTRA_MODE_BINS + OVERHEAD_BINS_INTRA)


def search_quadtree(y, width: int, height: int, lambda_satd: float,
                    bitdepth: int = 8, min_cu: int = 8, max_cu: int = 32,
                    two_pass: bool = True, rdo: bool = False,
                    qp: int = 30, lam_rd: float | None = None):
    """Open-loop mode search at every candidate CU size (device part).

    y: (H, W) int32 coded-size luma.  Returns (costs, modes): dicts
    size -> (H/s, W/s) float32 cost / int32 mode grids on y's device, in
    RD units (SATD-searched modes re-costed by a roundtrip at rd <= 1;
    the rd 2 search's roundtrip costs as they are).  The 64 level (full
    CTUs only) is the best single mode over the four 32x32 TBs' SATDs,
    costed by roundtripping those TBs with it."""
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
            by64, bx64 = m64.shape
            pad = torch.zeros((plan.blocks_y, plan.blocks_x),
                              dtype=torch.int32, device=y.device)
            pad[:2 * by64, :2 * bx64] = torch.repeat_interleave(
                torch.repeat_interleave(m64, 2, dim=0), 2, dim=1)
            cg = rd_cost_given_modes(y, plan, pad, qp, lam_rd, bitdepth)
            c64 = _plus_bins(cg[0::2, 0::2][:by64, :bx64]
                             + cg[0::2, 1::2][:by64, :bx64]
                             + cg[1::2, 0::2][:by64, :bx64]
                             + cg[1::2, 1::2][:by64, :bx64], lam_rd,
                             INTRA_MODE_BINS + OVERHEAD_BINS_INTRA)
            modes[64], costs[64] = m64, c64
        else:
            m, c = search_frame_modes(y, plan, lambda_satd, bitdepth,
                                      two_pass, rdo=rdo, qp=qp,
                                      lam_rd=lam_rd)
        modes[s] = m
        if rdo:
            costs[s] = _plus_bins(c, lam_rd, OVERHEAD_BINS_INTRA)
        else:
            costs[s] = intra_rd_recost(y, plan, m, qp, lam_rd, bitdepth)
    return costs, modes


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
                lam=0.0):
    """One wavefront step of one CU-size class: its first n slots (the
    plan fills a step's slots from 0).  Writes the slots' edges into the
    class's edge buffer and returns (levels (n*comps, S, S) int16, rec
    (n*comps, S*S) int32)."""
    comps = d["ref"].shape[2]
    refs = d["ebuf"][d["ref"][t, :n]].reshape(n * comps, -1)
    modes = d["modes"][t, :n * comps]
    pred = predict_modes(refs, modes, s, luma=luma, bitdepth=bitdepth)
    levels, rec = _tu_roundtrip(
        d["origs"][t, :n].reshape(n * comps, s, s), pred, s, d["qp"],
        bitdepth, scan_sel=_scan_sel(modes, s, luma) if signhide else None,
        rdoq=rdoq, lam=lam)
    rec = rec.reshape(n * comps, s * s)
    d["ebuf"][d["wr"][t, :n].reshape(-1)] = rec[:, d["edge"]].reshape(-1)
    return levels, rec


def reconstruct_frame_var(sched: dict, qp: int, qp_c: int, width: int,
                          height: int, chroma: bool, bitdepth: int = 8,
                          signhide: bool = False, rdoq: bool = False,
                          lam: float = 0.0):
    """sched: the frame's schedule on the device (see the frame
    encoder's ``var_sched_arrays``): 'luma' / 'chroma': size -> {x0,
    y0, avail, corner_h, modes} (T, K[, R]) over the real steps,
    'counts': (kind, size) -> the host's (T,) numpy slot counts,
    'n_real': T, and the source planes 'plane_y', 'plane_cb', 'plane_cr'
    (int32).  signhide / rdoq: sign-data hiding and RDOQ at lambda lam
    (the same lambda for luma and chroma, as the JAX package passes).

    Returns (rec_y, rec_cb, rec_cr) int32 planes and their levels
    (lv_y, lv_cb, lv_cr) int16 planes (pixel layout); chroma entries are
    None without chroma."""
    grey = 1 << (bitdepth - 1)
    dev = sched["plane_y"].device
    wc, hc = width // 2, height // 2
    # Per plane kind: (plane width, height, edge granularity, components,
    # QP, source planes); a kind's components share its flat buffers,
    # the edge buffer [h | v | grey] per component and the outputs
    # plane after plane.
    kinds = {"luma": (width, height, 8, 1, qp, [sched["plane_y"]])}
    if chroma:
        kinds["chroma"] = (wc, hc, 4, 2, qp_c,
                           [sched["plane_cb"], sched["plane_cr"]])
    outs, classes = {}, []
    for kind, (pw, ph, gran, comps, kqp, planes) in kinds.items():
        ebuf, base = _edge_buffers(pw, ph, gran, comps, grey, dev)
        rec = torch.zeros(comps * pw * ph, dtype=torch.int32, device=dev)
        lv = torch.zeros(comps * pw * ph, dtype=torch.int16, device=dev)
        outs[kind] = (rec, lv)
        for s in sorted(sched[kind]):
            cs = sched[kind][s]
            d = _derive(cs, s, pw, ph, gran, base, comps)
            d.update(ebuf=ebuf, qp=kqp, edge=_edge_positions(s, dev),
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
                                  rdoq, lam)
            out = d["out"][t, :n].reshape(-1)
            rec_out[out] = rec.reshape(-1)
            lv_out[out] = lv.reshape(-1)

    ry, ly = (b.reshape(height, width) for b in outs["luma"])
    if not chroma:
        return (ry, None, None), (ly, None, None)
    (rcb, rcr), (lcb, lcr) = (b.reshape(2, hc, wc) for b in outs["chroma"])
    return (ry, rcb, rcr), (ly, lcb, lcr)
