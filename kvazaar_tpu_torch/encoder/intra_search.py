"""Batched intra mode decision — all blocks, all 35 modes at once.

Counterpart of kvazaar_tpu/encoder/intra_search.py for --rd 0/1: every
mode of every block is predicted from *original* neighbour pixels
(open loop, so the search has no sequential dependency), Hadamard-SATD
costed, then (rd 1) re-ranked with MPM-aware signalling bits implied by
the pass-1 neighbour decisions.  The wavefront reconstruction then
honours the exact spec dependencies.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from kvazaar_tpu_torch.constants import INTRA_DC, INTRA_PLANAR
from kvazaar_tpu_torch.encoder.geometry import (IntraFramePlan, plan_flat_gather,
                                          plan_flat_noref)
from kvazaar_tpu_torch.encoder import plan_cached
from kvazaar_tpu_torch.ops.exactmm import einsum_exact
from kvazaar_tpu_torch.ops.intra import predict_all_modes


@functools.lru_cache(maxsize=None)
def _hadamard(n: int, device: torch.device) -> torch.Tensor:
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return torch.from_numpy(h).to(device)


def satd8_batch(diff: torch.Tensor) -> torch.Tensor:
    """SATD over (..., S, S) int32 diffs as a sum of 8x8 Hadamard costs,
    normalized like the reference's satd_8x8 ((sum + 2) >> 2); 4x4
    blocks use the 4x4 Hadamard with (sum + 1) >> 1."""
    s = diff.shape[-1]
    if s == 4:
        h = _hadamard(4, diff.device)
        t1 = einsum_exact("ij,...jk->...ik", h, diff)
        t = einsum_exact("lk,...ik->...il", h, t1)
        return (torch.sum(torch.abs(t), dim=(-2, -1),
                          dtype=torch.int32) + 1) >> 1
    h = _hadamard(8, diff.device)
    d = diff.reshape(*diff.shape[:-2], s // 8, 8, s // 8, 8)
    d = torch.swapaxes(d, -3, -2)            # (..., s/8, s/8, 8, 8)
    t1 = einsum_exact("ij,...jk->...ik", h, d)
    t = einsum_exact("lk,...ik->...il", h, t1)
    per_tile = (torch.sum(torch.abs(t), dim=(-2, -1),
                          dtype=torch.int32) + 2) >> 2
    return torch.sum(per_tile, dim=(-2, -1), dtype=torch.int32)


def _mpm_triplet(cand_l, cand_a):
    """Vectorized H.265 8.4.2 MPM derivation over int32 tensors."""
    eq = cand_l == cand_a
    small = cand_l < 2
    m = cand_l
    e0, e1, e2 = m, 2 + torch.remainder(m + 29, 32), \
        2 + torch.remainder(m - 1, 32)
    p0 = torch.full_like(m, INTRA_PLANAR)
    p1 = torch.full_like(m, INTRA_DC)
    p2 = torch.full_like(m, 26)
    d0, d1 = cand_l, cand_a
    has_planar = (cand_l == INTRA_PLANAR) | (cand_a == INTRA_PLANAR)
    has_dc = (cand_l == INTRA_DC) | (cand_a == INTRA_DC)
    d2 = torch.where(~has_planar, torch.full_like(m, INTRA_PLANAR),
                     torch.where(~has_dc, torch.full_like(m, INTRA_DC),
                                 torch.full_like(m, 26)))
    mpm0 = torch.where(eq, torch.where(small, p0, e0), d0)
    mpm1 = torch.where(eq, torch.where(small, p1, e1), d1)
    mpm2 = torch.where(eq, torch.where(small, p2, e2), d2)
    return mpm0, mpm1, mpm2


def mode_bits_table(modes_grid: torch.Tensor, cu_size: int,
                    ctu_size: int = 64) -> torch.Tensor:
    """(By, Bx, 35) float32 approximate signalling bits for each
    candidate mode given neighbour decisions (MPM flag + idx vs the
    5-bit remainder)."""
    by, bx = modes_grid.shape
    dev = modes_grid.device
    cand_l = torch.cat(
        [torch.full((by, 1), INTRA_DC, dtype=modes_grid.dtype, device=dev),
         modes_grid[:, :-1]], dim=1)
    cand_a = torch.cat(
        [torch.full((1, bx), INTRA_DC, dtype=modes_grid.dtype, device=dev),
         modes_grid[:-1, :]], dim=0)
    # Above neighbour outside the CTU row reverts to DC (8.4.2).
    outside_ctu = (torch.arange(by, device=dev) * cu_size) % ctu_size == 0
    cand_a = torch.where(outside_ctu[:, None],
                         torch.full_like(cand_a, INTRA_DC), cand_a)
    m0, m1, m2 = _mpm_triplet(cand_l, cand_a)
    all_modes = torch.arange(35, dtype=modes_grid.dtype, device=dev)
    is0 = all_modes[None, None, :] == m0[..., None]
    is12 = ((all_modes[None, None, :] == m1[..., None])
            | (all_modes[None, None, :] == m2[..., None]))
    return torch.where(is0, 2.0, torch.where(is12, 3.0, 6.0))


@plan_cached
def _gather_maps(plan: IntraFramePlan, device: torch.device):
    """(N, 4S+1) int64 luma ref gather indices + (N,) no-ref mask."""
    return (torch.from_numpy(plan_flat_gather(plan, True).astype(np.int64))
            .to(device),
            torch.from_numpy(plan_flat_noref(plan, True)).to(device))


def search_frame_modes(frame: torch.Tensor, plan: IntraFramePlan,
                       lambda_satd: float, bitdepth: int = 8,
                       two_pass: bool = True, rdo: bool = False):
    """frame: (H, W) integer coded-size luma.  Returns ((By, Bx) int32
    modes, (By, Bx) float32 winning costs).

    two_pass: re-rank with MPM-aware signalling bits (--rd >= 1; rd 0 is
    the pure-SATD argmin).  rdo (--rd >= 2) is not ported."""
    if rdo:
        raise NotImplementedError("--rd >= 2 mode search is not ported")
    s = plan.cu_size
    by, bx = plan.blocks_y, plan.blocks_x
    n = by * bx
    frame = frame.to(torch.int32)
    flat_ext = torch.cat([frame.reshape(-1),
                          frame.new_zeros(1)])
    gidx, noref = _gather_maps(plan, frame.device)
    refs = torch.where(noref[:, None],
                       torch.full_like(gidx, 1 << (bitdepth - 1),
                                       dtype=torch.int32),
                       flat_ext[gidx])
    preds = predict_all_modes(refs, s, luma=True,
                              bitdepth=bitdepth)         # (N,35,S,S)
    orig = frame.reshape(by, s, bx, s).permute(0, 2, 1, 3)
    orig = orig.reshape(n, 1, s, s)
    satd = satd8_batch(preds - orig)                     # (N, 35)

    modes1 = torch.argmin(satd, dim=-1).to(torch.int32).reshape(by, bx)
    if not two_pass:
        best1 = torch.min(satd, dim=-1).values.to(torch.float32)
        return modes1, best1.reshape(by, bx)
    bits = mode_bits_table(modes1, s).reshape(n, 35)
    # float32 exactly as JAX forms it: the weak-typed Python lambda is
    # rounded to float32 first, then the product, then the sum.
    cost = satd.to(torch.float32) + bits * float(np.float32(lambda_satd))
    modes = torch.argmin(cost, dim=-1).to(torch.int32).reshape(by, bx)
    best = torch.min(cost, dim=-1).values.reshape(by, bx)
    return modes, best
