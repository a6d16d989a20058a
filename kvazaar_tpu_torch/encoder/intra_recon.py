"""Exact wavefront reconstruction of the fixed-grid planes.

Counterpart of kvazaar_tpu/encoder/intra_recon.py for intra and P
frames without QP maps, scaling lists, RDOQ, transform skip or explicit
chroma modes.  On P frames an inter block takes its motion-compensated
prediction (computed for the whole frame beforehand: it has no
wavefront dependency) and the inter quantizer rounding 85/512, and
still feeds its intra neighbours' references through the wavefront.  ``reconstruct_frames`` hands each plane kind to
ops.wavefront.wavefront_recon: on a CUDA tensor that is the
hand-written kernel, on a CPU tensor the plain per-step loop below
(``wavefront_recon_plain``), which is also what the kernel is checked
against on the card.

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
from kvazaar_tpu_torch.encoder import plan_cached
from kvazaar_tpu_torch.ops.intra import predict_modes
from kvazaar_tpu_torch.ops.quant import dequantize, quantize
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


def _tu_roundtrip(orig, pred, s, qp, bitdepth, intra=True):
    """Flat TU roundtrip: (levels int16, reconstruction int32).  intra:
    bool, or a per-block bool tensor (N,)."""
    levels = quantize(forward_transform(orig - pred, s, bitdepth), qp, s,
                      bitdepth, intra=intra)
    dq = dequantize(levels, qp, s, bitdepth)
    rec = torch.clamp(pred + inverse_transform(dq, s, bitdepth), 0,
                      (1 << bitdepth) - 1)
    return levels.to(torch.int16), rec


def _plane_pass(rec_flat, orig_flat, modes_items, tables, step, s, qp,
                bitdepth, luma, inter_items=None, mc_flat=None):
    """One wavefront step for every slot of every item.  Returns the
    step's (levels (NB, slots, S, S), rec (NB, slots, S*S))."""
    gidx, noref, sidx, bids = tables
    nb = rec_flat.shape[0]
    refs = build_refs(rec_flat, gidx[step], noref[step], bitdepth)
    k = refs.shape[1]
    modes = modes_items[:, bids[step]]                    # (NB, slots)
    orig = orig_flat[:, sidx[step]].reshape(nb * k, s, s)
    pred = predict_modes(refs.reshape(nb * k, -1), modes.reshape(-1), s,
                         luma=luma, bitdepth=bitdepth)
    intra = True
    if inter_items is not None:
        inter = inter_items[:, bids[step]].reshape(-1)    # (NB*slots,)
        mc = mc_flat[:, sidx[step]].reshape(nb * k, s, s)
        pred = torch.where(inter[:, None, None], mc, pred)
        intra = ~inter
    levels, rec = _tu_roundtrip(orig, pred, s, qp, bitdepth, intra)
    return levels.reshape(nb, k, s, s), rec.reshape(nb, k, s * s)


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
                          mc=None):
    """Plain PyTorch version of the wavefront kernel, on any device;
    same contract as ops.wavefront.wavefront_recon."""
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
    orig_flat = _flat(orig)
    rec_flat = torch.zeros((nb, h * w + 1), dtype=torch.int32, device=dev)
    levels = torch.zeros((nb, nblk + 1, s, s), dtype=torch.int16,
                         device=dev)
    for step in range(plan.n_steps):
        lv, rec = _plane_pass(rec_flat, orig_flat, modes_items, tables,
                              step, s, qp, bitdepth, luma, inter_items,
                              mc_flat)
        rec_flat[:, sidx[step]] = rec        # pads land on the trash slot
        levels[:, bids[step]] = lv
    return (rec_flat[:, :h * w].reshape(nb, h, w).to(torch.uint8),
            levels[:, :nblk])


def reconstruct_frames(ys, cbs, crs, modes, plan: IntraFramePlan, qp: int,
                       qp_c: int, bitdepth: int = 8, is_inter=None,
                       mc_y=None, mc_cb=None, mc_cr=None):
    """Batched wavefront over all planes.

    ys: (B, H, W) integer; cbs/crs: (B, H/2, W/2) or None; modes:
    (B, By, Bx) int32.  P frames also pass is_inter (B, By, Bx) bool and
    the motion-compensated prediction planes mc_y (B, H, W) (+ chroma).
    Returns (recon_y, levels_y, recon_cb, levels_cb, recon_cr,
    levels_cr): recon (B, H, W) uint8, levels (B, N_blocks, S, S) int16
    in raster block order."""
    from kvazaar_tpu_torch.ops.wavefront import wavefront_recon
    s = plan.cu_size
    b = ys.shape[0]
    rec_y, lv_y = wavefront_recon(ys, modes, plan, s, True, qp, bitdepth,
                                  is_inter, mc_y)
    if cbs is None:
        return rec_y, lv_y, None, None, None, None
    # Cb and Cr share geometry, modes, inter map and QP: one 2B batch.
    mc_c = None if is_inter is None else torch.cat([mc_cb, mc_cr])
    rec_c, lv_c = wavefront_recon(torch.cat([cbs, crs]), modes, plan,
                                  s // 2, False, qp_c, bitdepth, is_inter,
                                  mc_c)
    return rec_y, lv_y, rec_c[:b], lv_c[:b], rec_c[b:], lv_c[b:]
