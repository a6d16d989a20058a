"""Exact wavefront reconstruction of the fixed-grid planes.

Counterpart of kvazaar_tpu/encoder/intra_recon.py for intra and P
frames at one QP or with a per-block QP map (LCU rate control, ROI and
AQ: each block quantizes at its own QP, chroma at the QP that Table 8-10
maps it to), with RDOQ and sign-data hiding where the config sets them,
with explicit chroma modes (--rd 3) or DM, or lossless (transquant
bypass: the levels are the residual, or with implicit RDPCM its DPCM
along a horizontal or vertical intra mode, and the reconstruction is
the source), with or without a scaling list (per-position quantizer
tables per block size, component, intra / inter and QP % 6, at one QP);
at the intra-NxN point (luma on a
plan of 4x4 blocks with the DST-VII and the transform-skip decision,
chroma on a cu 8 plan) all-intra.  On P frames
an inter block takes its motion-compensated
prediction (computed for the whole frame beforehand: it has no
wavefront dependency) and the inter quantizer rounding 85/512, and
still feeds its intra neighbours' references through the wavefront.
``reconstruct_frames`` hands all planes to
ops.wavefront.wavefront_recon_planes: on CUDA tensors that is one
launch of the hand-written kernel for luma and chroma together, on CPU
tensors the plain per-step loop below (``wavefront_recon_plain``) once
per plane kind, which is also what the kernel is checked against on the
card.

The plain loop keeps the reconstructed plane itself as the wavefront
state.  Each step gathers every slot's 4S+1 reference samples through
the plan's static gather map (geometry.PlaneMaps: 8.4.4.2.2
substitution is resolved into the indices at plan time, because
availability is static on a fixed CU grid), predicts the coded mode,
runs the TU roundtrip and scatters the block back into the plane.
"""

from __future__ import annotations

import numpy as np
import torch

from kvazaar_tpu_torch.encoder.geometry import IntraFramePlan
from kvazaar_tpu_torch.encoder import pix_dtype, plan_cached
from kvazaar_tpu_torch.ops.intra import predict_modes
from kvazaar_tpu_torch.ops.quant import (_fma_f32, _group_sum, _tskip_bits,
                                         dequantize, quantize,
                                         quantize_rdoq, sign_hide)
from kvazaar_tpu_torch.ops.transform import (forward_transform,
                                             inverse_transform)


def blocks_to_plane(blocks: np.ndarray, plan: IntraFramePlan,
                    size: int, width: int, height: int) -> np.ndarray:
    """(N_blocks, S, S) raster block order -> (H, W) plane."""
    g = blocks.reshape(plan.blocks_y, plan.blocks_x, size, size)
    return np.ascontiguousarray(
        g.transpose(0, 2, 1, 3).reshape(height, width))


@plan_cached
def step_schedule(plan: IntraFramePlan, luma: bool, device: torch.device):
    """Static per-(step, slot) tensors of one plane kind: ref gather
    indices (steps, slots, 4S+1), all-refs-unavailable mask (steps,
    slots), sample scatter indices (steps, slots, S*S) — all into the
    flat plane extended by one trash element that pad slots use — and
    block ids (steps, slots) with pads mapped to N_blocks."""
    maps = plan.luma if luma else plan.chroma
    nblk = plan.blocks_y * plan.blocks_x
    bos = np.where(plan.block_of_slot >= 0, plan.block_of_slot, nblk)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (t(maps.gather_idx.astype(np.int64)), t(maps.no_refs),
            t(maps.scatter_idx.astype(np.int64)), t(bos.astype(np.int64)))


def build_refs(rec_flat: torch.Tensor, gidx: torch.Tensor,
               noref: torch.Tensor, bitdepth: int) -> torch.Tensor:
    """(NB, slots, 4S+1) substituted reference vectors of one step from
    the flat reconstructed planes (NB, H*W + 1); blocks with no
    available neighbour read mid-grey (the counterpart of
    build_refs_edges)."""
    refs = rec_flat[:, gidx]
    return torch.where(noref[None, :, None],
                       torch.full_like(refs, 1 << (bitdepth - 1)), refs)


def _tu_roundtrip(orig, pred, s, qp, bitdepth, intra=True, scan_sel=None,
                  rdoq=False, lam=0.0, lossless=False, rdpcm_modes=None,
                  program="var", dst=False, tskip=False, scaling_tab=None):
    """Flat TU roundtrip: (levels int16, reconstruction int32), and with
    tskip a third entry.  qp: an int or a per-block int tensor (N,);
    intra: bool, or a per-block bool tensor (N,); scan_sel: the (N,)
    scanIdx of each block when sign hiding is on, else None; rdoq: RDOQ
    at lambda lam instead of the scalar quantizer, its float32 costs in
    the order of the JAX package's ``program`` (ops.quant.quantize_rdoq:
    "grid" for the fixed grid's wavefront, "var" for the variable
    trees').  lossless: transquant bypass, the residual is the level
    array and the reconstruction the source; rdpcm_modes: (N,) modes
    under implicit RDPCM, where a block of mode 10 codes its residual's
    horizontal differences and one of mode 26 its vertical ones (-1 for
    blocks without DPCM).  dst: the 4x4 DST-VII (intra luma 4x4 TBs).
    tskip: also code every block with transform skip and keep, per
    block, the cheaper by ``tskip_cost`` (ties keep the transform); the
    third entry is then the (N,) int32 skip decisions.  scaling_tab: a
    scaling list's (qc_intra, qc_inter, dqc_intra, dqc_inter) tables,
    each (S, S) or one per block (N, S, S), selected per block by
    ``intra`` (ops.quant.scaling_tables; an int qp only)."""
    resid = orig.to(torch.int32) - pred
    qc = dqc = None
    if scaling_tab is not None:
        qc, dqc = tuple(scaling_tab[:2]), tuple(scaling_tab[2:])
    if lossless:
        levels = resid
        if rdpcm_modes is not None:
            dx = torch.cat([resid[..., :, :1],
                            resid[..., :, 1:] - resid[..., :, :-1]], dim=-1)
            dy = torch.cat([resid[..., :1, :],
                            resid[..., 1:, :] - resid[..., :-1, :]], dim=-2)
            m = rdpcm_modes[:, None, None]
            levels = torch.where(m == 10, dx, torch.where(m == 26, dy,
                                                          resid))
        return levels.to(torch.int16), orig.to(torch.int32)

    def roundtrip(coeff, inverse):
        if rdoq:
            levels = quantize_rdoq(coeff, qp, s, bitdepth, intra=intra,
                                   lam=lam, program=program, qc=qc, dqc=dqc)
        else:
            levels = quantize(coeff, qp, s, bitdepth, intra=intra, qc=qc)
        if scan_sel is not None:
            levels = sign_hide(levels, scan_sel)
        dq = dequantize(levels, qp, s, bitdepth, dqc=dqc, intra=intra)
        rec = torch.clamp(pred + inverse(dq), 0, (1 << bitdepth) - 1)
        return levels, rec

    levels, rec = roundtrip(
        forward_transform(resid, s, bitdepth, dst),
        lambda dq: inverse_transform(dq, s, bitdepth, dst))
    if not tskip:
        return levels.to(torch.int16), rec
    # Transform skip (8.6.4.2): coefficients resid << (15 - bd - log2 S),
    # reconstruction ((dq << 7) + rnd) >> (20 - bd).
    sh_f = 15 - bitdepth - (s.bit_length() - 1)
    sh_i = 20 - bitdepth
    lv_s, rec_s = roundtrip(resid << sh_f,
                            lambda dq: ((dq << 7) + (1 << (sh_i - 1))) >> sh_i)
    sel = (tskip_cost(lv_s, rec_s, orig, lam)
           < tskip_cost(levels, rec, orig, lam))
    levels = torch.where(sel[:, None, None], lv_s, levels)
    rec = torch.where(sel[:, None, None], rec_s, rec)
    return levels.to(torch.int16), rec, sel.to(torch.int32)


def tskip_cost(levels, rec, orig, lam):
    """(N,) float32 cost ``ssd + lam * bits`` of N 4x4 TBs in the JAX
    package's transform-skip decision, rounded as its CPU program rounds
    it: the SSD exactly (16 x 1023^2 < 2^24), bits = the 16 per-level
    terms ``2 + 2 log2(|l| + 1)`` (0 for l = 0, ops.quant.tskip_bits_np)
    summed in XLA's order, plus 1, and the cost as one fused
    multiply-add."""
    d = (rec - orig.to(torch.int32)).to(torch.int64)
    ssd = torch.sum(d * d, dim=(-2, -1)).to(torch.float32)
    a = torch.abs(levels.to(torch.int32)).long()
    terms = _tskip_bits(levels.device)[a]
    bits = _group_sum(terms.reshape(-1, 1, 4, 1, 4))[:, 0, 0] + 1.0
    return _fma_f32(ssd, lam, bits)


def _scan_sel(modes: torch.Tensor, s: int, luma: bool,
              is_inter=None) -> torch.Tensor:
    """scanIdx per block (7.4.9.11): mode-dependent only for the intra
    blocks of 4x4 and 8x8 luma TBs and 4x4 chroma TBs (``modes`` the
    plane's own: a chroma plane's come from its chroma modes), diagonal
    otherwise; is_inter: a bool tensor of modes' shape, whose inter
    blocks take the diagonal scan."""
    if (luma and s > 8) or (not luma and s > 4):
        return torch.zeros_like(modes, dtype=torch.int32)
    sel = torch.where((modes >= 6) & (modes <= 14), 2,
                      torch.where((modes >= 22) & (modes <= 30), 1, 0))
    if is_inter is not None:
        sel = torch.where(is_inter, 0, sel)
    return sel.to(torch.int32)


def _plane_pass(rec_flat, orig_flat, modes_items, tables, step, s, qp,
                bitdepth, luma, inter_items=None, mc_flat=None,
                qp_items=None, lossless=False, rdpcm=False, rdoq=False,
                lam=0.0, signhide=False, tskip=False, scaling_tab=None):
    """One wavefront step for every slot of every item (qp_items: the
    items' per-block QPs, else every block at qp; lossless / rdpcm:
    transquant bypass, with implicit RDPCM on the intra blocks, which
    also turns the luma boundary fixups off; rdoq: RDOQ at lambda lam;
    signhide: sign-data hiding by each block's scanIdx; luma S=4 blocks
    are intra NxN TBs and take the DST, and tskip their transform-skip
    decision; scaling_tab: a scaling list's tables of the plane, as
    ``_tu_roundtrip`` takes them).  Returns the step's (levels (NB,
    slots, S, S), rec (NB, slots, S*S), skip decisions (NB, slots) int32
    or None)."""
    gidx, noref, sidx, bids = tables
    nb = rec_flat.shape[0]
    refs = build_refs(rec_flat, gidx[step], noref[step], bitdepth)
    k = refs.shape[1]
    modes = modes_items[:, bids[step]].reshape(-1)        # (NB*slots,)
    orig = orig_flat[:, sidx[step]].reshape(nb * k, s, s)
    pred = predict_modes(refs.reshape(nb * k, -1), modes, s, luma=luma,
                         bitdepth=bitdepth, fixups=not (rdpcm and luma))
    intra = True
    inter = None
    rdpcm_modes = modes if rdpcm else None
    if inter_items is not None:
        inter = inter_items[:, bids[step]].reshape(-1)    # (NB*slots,)
        mc = mc_flat[:, sidx[step]].reshape(nb * k, s, s)
        pred = torch.where(inter[:, None, None], mc, pred)
        intra = ~inter
        if rdpcm:
            rdpcm_modes = torch.where(inter, -1, modes)
    if qp_items is not None:
        qp = qp_items[:, bids[step]].reshape(-1)          # (NB*slots,)
    scan_sel = _scan_sel(modes, s, luma, inter) if signhide else None
    nxn = luma and s == 4 and inter is None
    out = _tu_roundtrip(orig, pred, s, qp, bitdepth, intra,
                        scan_sel=scan_sel, rdoq=rdoq, lam=lam,
                        lossless=lossless, rdpcm_modes=rdpcm_modes,
                        program="grid", dst=nxn, tskip=tskip and nxn,
                        scaling_tab=scaling_tab)
    ts = out[2].reshape(nb, k) if len(out) == 3 else None
    return out[0].reshape(nb, k, s, s), out[1].reshape(nb, k, s * s), ts


def _items(a: torch.Tensor, nb: int, nblk: int) -> torch.Tensor:
    """(Bm, By, Bx) per-block values -> (NB, N_blocks + 1) int32 rows,
    item i taking row i % Bm, with a zero entry for pad slots."""
    bm = a.shape[0]
    ext = torch.cat([a.reshape(bm, nblk).to(torch.int32),
                     a.new_zeros((bm, 1), dtype=torch.int32)], dim=1)
    return ext[torch.arange(nb, device=a.device) % bm]


def _flat(planes: torch.Tensor) -> torch.Tensor:
    """(NB, H, W) -> (NB, H*W + 1) int32 with a trailing trash entry."""
    nb = planes.shape[0]
    return torch.cat([planes.reshape(nb, -1).to(torch.int32),
                      planes.new_zeros((nb, 1), dtype=torch.int32)], dim=1)


def wavefront_recon_plain(orig: torch.Tensor, modes: torch.Tensor,
                          plan: IntraFramePlan, s: int, luma: bool,
                          qp: int, bitdepth: int = 8, is_inter=None,
                          mc=None, qp_map=None, lossless=False,
                          rdpcm=False, rdoq=False, lam=0.0,
                          signhide=False, tskip=False, scaling_tab=None):
    """Plain PyTorch version of the wavefront kernel, on any device;
    same contract as ops.wavefront.wavefront_recon (with tskip, a third
    output: the (NB, N_blocks) int32 transform-skip decisions;
    scaling_tab: the plane kind's scaling-list tables at qp,
    ops.quant.scaling_tables)."""
    nb, h, w = orig.shape
    dev = orig.device
    nblk = plan.blocks_y * plan.blocks_x
    tables = step_schedule(plan, luma, dev)
    sidx, bids = tables[2], tables[3]
    modes_items = _items(modes, nb, nblk)
    inter_items = mc_flat = None
    if is_inter is not None:
        inter_items = _items(is_inter, nb, nblk) != 0
        mc_flat = _flat(mc)
    qp_items = None if qp_map is None else _items(qp_map, nb, nblk)
    orig_flat = _flat(orig)
    rec_flat = torch.zeros((nb, h * w + 1), dtype=torch.int32, device=dev)
    levels = torch.zeros((nb, nblk + 1, s, s), dtype=torch.int16,
                         device=dev)
    skip = torch.zeros((nb, nblk + 1), dtype=torch.int32, device=dev)
    for step in range(plan.n_steps):
        lv, rec, ts = _plane_pass(rec_flat, orig_flat, modes_items, tables,
                                  step, s, qp, bitdepth, luma, inter_items,
                                  mc_flat, qp_items, lossless, rdpcm, rdoq,
                                  lam, signhide, tskip, scaling_tab)
        rec_flat[:, sidx[step]] = rec        # pads land on the trash slot
        levels[:, bids[step]] = lv
        if ts is not None:
            skip[:, bids[step]] = ts
    out = (rec_flat[:, :h * w].reshape(nb, h, w).to(pix_dtype(bitdepth)),
           levels[:, :nblk])
    return out + (skip[:, :nblk],) if tskip else out


def reconstruct_frames(ys, cbs, crs, modes, plan: IntraFramePlan, qp: int,
                       qp_c: int, bitdepth: int = 8, is_inter=None,
                       mc_y=None, mc_cb=None, mc_cr=None, qp_map=None,
                       lossless=False, rdpcm=False, signhide=False,
                       rdoq=False, lam=0.0, cmodes=None, tskip=False,
                       scaling=None):
    """Batched wavefront over all planes.

    ys: (B, H, W) integer; cbs/crs: (B, H/2, W/2) or None; modes:
    (B, By, Bx) int32.  P frames also pass is_inter (B, By, Bx) bool and
    the motion-compensated prediction planes mc_y (B, H, W) (+ chroma).
    qp_map: (B, By, Bx) int per-block luma QP (clipped to 0..51, chroma
    through Table 8-10), replacing qp and qp_c.  lossless: transquant
    bypass; rdpcm: implicit RDPCM on the intra blocks of lossless planes
    (chroma through its own mode), the luma boundary fixups off.
    signhide: sign-data hiding; rdoq: RDOQ at lambda lam (every block,
    whatever its QP); cmodes: (B, By, Bx) int32 explicit chroma
    prediction modes (--rd 3), else chroma takes the luma modes (DM).
    A plan of 4x4 blocks (the intra-NxN point) reconstructs luma alone
    (cbs None; chroma: ``reconstruct_chroma_frames``) with the DST-VII;
    tskip adds each block's transform-skip decision.  scaling: a
    scaling list (ops.scaling.ScalingLists; no qp_map, lossless or
    tskip), its tables at qp for luma and qp_c for Cb and Cr.  Returns
    (recon_y, levels_y, recon_cb, levels_cb, recon_cr, levels_cr): recon
    (B, H, W) uint8 at 8-bit, int16 above (``pix_dtype``), levels (B,
    N_blocks, S, S) int16 in raster block order; with tskip a seventh
    entry, the (B, N_blocks) int32 skip decisions."""
    from kvazaar_tpu_torch.ops.wavefront import wavefront_recon_planes
    return wavefront_recon_planes(ys, cbs, crs, modes, plan, qp, qp_c,
                                  bitdepth, is_inter, mc_y, mc_cb, mc_cr,
                                  qp_map, lossless, rdpcm, rdoq=rdoq,
                                  signhide=signhide, lam=lam, cmodes=cmodes,
                                  tskip=tskip, scaling=scaling)


def reconstruct_chroma_frames(cbs, crs, dm_modes, plan: IntraFramePlan,
                              qp_c: int, bitdepth: int = 8, lossless=False,
                              signhide=False, rdoq=False, lam=0.0,
                              scaling=None):
    """Chroma of the intra-NxN point over a cu 8 plan: each 8x8 CU keeps
    one 4x4 TB per chroma plane, predicted with the DM mode of its first
    PU (the JAX package's ``reconstruct_chroma_frames``).  cbs/crs (B,
    H/2, W/2); dm_modes (B, By8, Bx8) int32; scaling: a scaling list, its
    4x4 Cb and Cr tables at qp_c.  Returns (rec_cb, lv_cb, rec_cr,
    lv_cr), levels in raster block order."""
    from kvazaar_tpu_torch.ops.wavefront import wavefront_recon_chroma
    return wavefront_recon_chroma(cbs, crs, dm_modes, plan, qp_c, bitdepth,
                                  lossless=lossless, rdoq=rdoq,
                                  signhide=signhide, lam=lam, scaling=scaling)
