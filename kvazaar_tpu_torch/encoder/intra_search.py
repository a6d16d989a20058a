"""Batched intra mode decision — all blocks, all 35 modes at once.

Counterpart of kvazaar_tpu/encoder/intra_search.py for --rd 0..3: every
mode of every block is predicted
from *original* neighbour pixels (open loop, so the search has no
sequential dependency), Hadamard-SATD costed, then (rd 1) re-ranked
with MPM-aware signalling bits implied by the pass-1 neighbour
decisions, or (rd 2) the top four re-ranked by a true transform +
quantization roundtrip and the modelled coefficient rate; (rd 3)
``search_chroma_modes`` then picks each CU's chroma mode among the five
of Table 8-3 by a roundtrip on both chroma planes.  The wavefront
reconstruction then honours the exact spec dependencies.

Float32 costs are formed as the JAX package forms them on its CPU
backend, where XLA contracts an elementwise ``a + l * b`` into one
fused multiply-add: ``_fma_f32`` computes it in float64 (the float32
product is exact there) and rounds once.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from kvazaar_tpu_torch.constants import INTRA_DC, INTRA_PLANAR
from kvazaar_tpu_torch.encoder.geometry import (IntraFramePlan, plan_flat_gather,
                                          plan_flat_noref)
from kvazaar_tpu_torch.encoder import plan_cached
from kvazaar_tpu_torch.ops.exactmm import matmul_exact
from kvazaar_tpu_torch.ops.intra import predict_all_modes, predict_modes
from kvazaar_tpu_torch.ops.quant import _f32, _fma_f32, dequantize, quantize
from kvazaar_tpu_torch.ops.rate import tb_rate_bits
from kvazaar_tpu_torch.ops.transform import (forward_transform,
                                             inverse_transform)


@functools.lru_cache(maxsize=None)
def _hadamard(n: int, device: torch.device) -> torch.Tensor:
    h = np.array([[1]], dtype=np.int32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return torch.from_numpy(h).to(device, torch.float64)


def satd8_batch(diff: torch.Tensor) -> torch.Tensor:
    """SATD over (..., S, S) int32 diffs as a sum of 8x8 Hadamard costs,
    normalized like the reference's satd_8x8 ((sum + 2) >> 2); 4x4
    blocks use the 4x4 Hadamard with (sum + 1) >> 1."""
    s = diff.shape[-1]
    if s == 4:
        h = _hadamard(4, diff.device)
        t = matmul_exact(matmul_exact(h, diff), h.mT)
        return (torch.sum(torch.abs(t), dim=(-2, -1),
                          dtype=torch.int32) + 1) >> 1
    h = _hadamard(8, diff.device)
    d = diff.reshape(*diff.shape[:-2], s // 8, 8, s // 8, 8)
    d = torch.swapaxes(d, -3, -2)            # (..., s/8, s/8, 8, 8)
    t = matmul_exact(matmul_exact(h, d), h.mT)
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
def _gather_maps(plan: IntraFramePlan, device: torch.device,
                 luma: bool = True):
    """(N, 4S+1) int64 ref gather indices + (N,) no-ref mask of the luma
    or the chroma plane."""
    return (torch.from_numpy(plan_flat_gather(plan, luma).astype(np.int64))
            .to(device),
            torch.from_numpy(plan_flat_noref(plan, luma)).to(device))


def _ssd_f32(err: torch.Tensor) -> torch.Tensor:
    """float32 sum of squares over the last two axes, summed in int64:
    equal to JAX's float32 sum while the total stays below 2^24 (every
    partial sum is then exact in any order)."""
    e = err.to(torch.int64)
    return torch.sum(e * e, dim=(-2, -1)).to(torch.float32)


def _roundtrip_levels(resid, s, qp, bitdepth):
    """Intra flat-quant roundtrip of (N, S, S) residuals: (levels, ssd
    float32 (N,))."""
    levels = quantize(forward_transform(resid, s, bitdepth), qp, s,
                      bitdepth, intra=True)
    rrec = inverse_transform(dequantize(levels, qp, s, bitdepth), s,
                             bitdepth)
    return levels, _ssd_f32(rrec - resid)


def _open_loop_refs(frame: torch.Tensor, plan: IntraFramePlan,
                    bitdepth: int, luma: bool = True) -> torch.Tensor:
    """(N, 4S+1) reference vectors from the source plane (luma, or a
    chroma plane of the plan)."""
    flat_ext = torch.cat([frame.reshape(-1), frame.new_zeros(1)])
    gidx, noref = _gather_maps(plan, frame.device, luma)
    return torch.where(noref[:, None],
                       torch.full_like(gidx, 1 << (bitdepth - 1),
                                       dtype=torch.int32),
                       flat_ext[gidx])


def _blocks(frame: torch.Tensor, plan: IntraFramePlan,
            s: int | None = None) -> torch.Tensor:
    """(H, W) -> (N, S, S) raster blocks (S the plan's CU size, or s)."""
    s = s or plan.cu_size
    by, bx = plan.blocks_y, plan.blocks_x
    return frame.reshape(by, s, bx, s).permute(0, 2, 1, 3).reshape(
        by * bx, s, s)


def _rd_rerank(preds, orig, satd, modes1, lambda_satd, s, qp, lam_rd,
               bitdepth, k: int = 4):
    """--rd 2 stage: re-rank each block's top-K candidates by SATD +
    lambda * mode bits with the true roundtrip cost SSD + lam_rd *
    (modelled TB rate + mode bits).

    preds: (N, 35, S, S); orig: (N, 1, S, S); satd: (N, 35).  Returns
    ((By, Bx) modes, (By, Bx) float32 rd costs)."""
    n = preds.shape[0]
    by_bx = modes1.shape
    bits = mode_bits_table(modes1, s).reshape(n, 35)
    cost1 = _fma_f32(satd.to(torch.float32), lambda_satd, bits)
    # jax.lax.top_k breaks ties toward the lower index: a stable sort.
    topk = torch.sort(cost1, dim=-1, stable=True).indices[:, :k]
    cand = torch.take_along_dim(preds, topk[..., None, None], dim=1)
    resid = (orig - cand).reshape(n * k, s, s)
    levels, ssd = _roundtrip_levels(resid, s, qp, bitdepth)
    rate = tb_rate_bits(levels).reshape(n, k)
    mbits = torch.take_along_dim(bits, topk, dim=1)
    cost = _fma_f32(ssd.reshape(n, k), lam_rd, rate + mbits)
    sel = torch.argmin(cost, dim=-1)
    modes = torch.take_along_dim(topk, sel[:, None], dim=1)[:, 0]
    best = torch.min(cost, dim=-1).values
    return (modes.to(torch.int32).reshape(by_bx),
            best.reshape(by_bx))


def search_frame_modes(frame: torch.Tensor, plan: IntraFramePlan,
                       lambda_satd: float, bitdepth: int = 8,
                       two_pass: bool = True, return_satd: bool = False,
                       rdo: bool = False, qp: int = 30,
                       lam_rd: float | None = None):
    """frame: (H, W) integer coded-size luma.  Returns ((By, Bx) int32
    modes, (By, Bx) float32 winning costs), plus the (By, Bx, 35) int32
    SATDs when return_satd (they feed the 64x64 CU level).

    two_pass: re-rank with MPM-aware signalling bits (--rd >= 1; rd 0 is
    the pure-SATD argmin).  rdo (--rd 2): re-rank the top four by the
    roundtrip RD cost at ``qp`` with ``lam_rd`` (default lambda_satd
    squared)."""
    s = plan.cu_size
    by, bx = plan.blocks_y, plan.blocks_x
    n = by * bx
    frame = frame.to(torch.int32)
    refs = _open_loop_refs(frame, plan, bitdepth)
    preds = predict_all_modes(refs, s, luma=True,
                              bitdepth=bitdepth)         # (N,35,S,S)
    orig = _blocks(frame, plan).reshape(n, 1, s, s)
    satd = satd8_batch(preds - orig)                     # (N, 35)

    modes1 = torch.argmin(satd, dim=-1).to(torch.int32).reshape(by, bx)
    extra = (satd.reshape(by, bx, 35),) if return_satd else ()
    if rdo:
        if lam_rd is None:
            lam_rd = lambda_satd * lambda_satd
        return _rd_rerank(preds, orig, satd, modes1, lambda_satd, s, qp,
                          lam_rd, bitdepth) + extra
    if not two_pass:
        best1 = torch.min(satd, dim=-1).values.to(torch.float32)
        return (modes1, best1.reshape(by, bx)) + extra
    bits = mode_bits_table(modes1, s).reshape(n, 35)
    cost = _fma_f32(satd.to(torch.float32), lambda_satd, bits)
    modes = torch.argmin(cost, dim=-1).to(torch.int32).reshape(by, bx)
    best = torch.min(cost, dim=-1).values.reshape(by, bx)
    return (modes, best) + extra


def rd_cost_given_modes(frame: torch.Tensor, plan: IntraFramePlan,
                        modes: torch.Tensor, qp: int, lam_rd: float,
                        bitdepth: int = 8) -> torch.Tensor:
    """(By, Bx) float32 roundtrip RD cost (SSD + lam_rd * coefficient
    rate) of coding each block with the GIVEN mode (open-loop refs)."""
    s = plan.cu_size
    frame = frame.to(torch.int32)
    pred = predict_modes(_open_loop_refs(frame, plan, bitdepth),
                         modes.reshape(-1), s, luma=True,
                         bitdepth=bitdepth)
    levels, ssd = _roundtrip_levels(_blocks(frame, plan) - pred, s, qp,
                                    bitdepth)
    return _fma_f32(ssd, lam_rd, tb_rate_bits(levels)).reshape(
        plan.blocks_y, plan.blocks_x)


def modes64_from_satd32(satd32: torch.Tensor, lambda_satd: float,
                        two_pass: bool = True):
    """Best single-mode 64x64 CU from the four 32x32 TBs' per-mode
    SATDs (a 64 intra CU is four same-mode 32x32 TBs, 7.3.8.8).

    satd32: (By, Bx, 35).  Returns ((By//2, Bx//2) int32 modes, float32
    cost grid); partial CTUs are left out."""
    by, bx = satd32.shape[0] // 2, satd32.shape[1] // 2
    s4 = (satd32[0::2, 0::2][:by, :bx] + satd32[0::2, 1::2][:by, :bx]
          + satd32[1::2, 0::2][:by, :bx]
          + satd32[1::2, 1::2][:by, :bx]).to(torch.float32)
    modes1 = torch.argmin(s4, dim=-1).to(torch.int32)
    if not two_pass:
        return modes1, torch.min(s4, dim=-1).values
    cost = _fma_f32(s4, lambda_satd, mode_bits_table(modes1, 64))
    return (torch.argmin(cost, dim=-1).to(torch.int32),
            torch.min(cost, dim=-1).values)


CHROMA_CAND_BASE = (0, 26, 10, 1)   # Table 8-3 modeList order


def chroma_cand_table(luma_modes: torch.Tensor) -> torch.Tensor:
    """(...,) luma modes -> (..., 4) the chroma modes that
    intra_chroma_pred_mode 0..3 select (8.4.3 Table 8-3: the list entry
    equal to the luma mode becomes angular 34); DM (index 4) is the
    luma mode itself."""
    base = torch.tensor(CHROMA_CAND_BASE, dtype=torch.int32,
                        device=luma_modes.device)
    cand = base.expand(*luma_modes.shape, 4)
    return torch.where(cand == luma_modes[..., None].to(torch.int32), 34,
                       cand)


def search_chroma_modes(cbp: torch.Tensor, crp: torch.Tensor,
                        luma_modes: torch.Tensor, plan: IntraFramePlan,
                        qp_c: int, lam_rd: float,
                        bitdepth: int = 8) -> torch.Tensor:
    """--rd 3 chroma-mode RDO: every CU's four Table 8-3 candidates and
    DM, each costed by a transform + flat-quant roundtrip of both chroma
    planes from open-loop source references: SSD + lam_rd * (coefficient
    rate + intra_chroma_pred_mode bins), first-index argmin.

    cbp / crp: (H/2, W/2) integer source chroma planes (coded size);
    luma_modes: (By, Bx) int32.  Returns (By, Bx) int32 chroma
    prediction modes."""
    s2 = plan.chroma.size
    by, bx = plan.blocks_y, plan.blocks_x
    n = by * bx
    lm = luma_modes.reshape(-1).to(torch.int32)
    cand = torch.cat([chroma_cand_table(lm), lm[:, None]], dim=1)  # (N, 5)

    def plane_costs(plane):
        plane = plane.to(torch.int32)
        refs = _open_loop_refs(plane, plan, bitdepth, luma=False)
        preds = predict_all_modes(refs, s2, luma=False, bitdepth=bitdepth)
        sel = torch.take_along_dim(preds, cand[:, :, None, None].long(),
                                   dim=1)                      # (N,5,S,S)
        orig = _blocks(plane, plan, s2).reshape(n, 1, s2, s2)
        levels, ssd = _roundtrip_levels((orig - sel).reshape(n * 5, s2, s2),
                                        s2, qp_c, bitdepth)
        return _fma_f32(ssd.reshape(n, 5), lam_rd,
                        tb_rate_bits(levels).reshape(n, 5))

    # intra_chroma_pred_mode bins (9.3.3.8): DM one context bin, an
    # explicit mode one context bin and two bypass bins.
    sig = torch.tensor([3.0, 3.0, 3.0, 3.0, 1.0], dtype=torch.float32,
                       device=cbp.device)
    cost = _fma_f32(plane_costs(cbp) + plane_costs(crp), lam_rd,
                    sig.expand(n, 5))
    pick = torch.argmin(cost, dim=1)
    return torch.take_along_dim(cand, pick[:, None], dim=1)[:, 0].reshape(
        by, bx).to(torch.int32)
