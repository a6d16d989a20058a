"""Batched inter search for one reference: exhaustive integer-pel ME
with a rate-aware second pass, then dense quarter-pel SATD refinement;
and full-frame motion compensation of the final MVs.

Counterpart of kvazaar_tpu/encoder/inter_search.py (search_inter_frame
without the hierarchical hint, mc_planes for one reference).  Costs are
formed in float32 exactly as the JAX package forms them (the Python
lambda rounded to float32 first), and every argmin takes the first
index of a tie, as JAX does.
"""

from __future__ import annotations

import numpy as np
import torch

from kvazaar_tpu_torch.encoder import plan_cached
from kvazaar_tpu_torch.encoder.geometry import IntraFramePlan
from kvazaar_tpu_torch.encoder.intra_search import satd8_batch
from kvazaar_tpu_torch.ops.inter import (device_table, mc_chroma, mc_luma,
                                         refine_qpel_dense, sad_surfaces)


def _f32(x: float) -> float:
    """A Python float rounded to float32, as JAX's weak typing rounds a
    Python scalar that multiplies a float32 array."""
    return float(np.float32(x))


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


def search_inter_frame(cur, ref, plan: IntraFramePlan, lambda_satd: float,
                       me_range: int, bitdepth: int = 8,
                       subpel: bool = True, mv_hint=None):
    """cur/ref: (H, W) integer planes (ref is the deblocked previous
    reconstruction).  Returns (mv (By, Bx, 2) int32 quarter-pel, cost
    (By, Bx) float32: SATD + lambda * mv bits of the winner)."""
    if mv_hint is not None:
        raise NotImplementedError("hierarchical ME (mv_hint) is not "
                                  "ported")
    s = plan.cu_size
    by, bx = plan.blocks_y, plan.blocks_x
    n = by * bx
    r = me_range
    d = 2 * r + 1
    dev = cur.device
    lam = _f32(lambda_satd)
    x0s, y0s = _block_origins(plan, dev)
    cur = cur.to(torch.int32)
    ref = ref.to(torch.int32)
    cur_blocks = cur.reshape(by, s, bx, s).permute(0, 2, 1, 3)
    cur_blocks = cur_blocks.reshape(n, s, s)

    sads = sad_surfaces(cur, ref, r, s, bitdepth).reshape(n, d, d)

    # Pass 1: pure-SAD integer winner.
    idx1 = torch.argmin(sads.reshape(n, -1), dim=-1)
    mv1 = torch.stack([idx1 % d - r, idx1 // d - r], dim=-1)
    mv1 = (mv1 * 4).reshape(by, bx, 2)

    # Pass 2: re-minimize with the mv rate against the median predictor.
    pred = _mv_pred_grid(mv1).reshape(n, 1, 1, 2)
    steps = torch.arange(-r, r + 1, device=dev) * 4
    bits = (_mv_bits_est(steps[None, None, :] - pred[..., 0])
            + _mv_bits_est(steps[None, :, None] - pred[..., 1]))
    cost = sads.to(torch.float32) + bits * lam
    idx2 = torch.argmin(cost.reshape(n, -1), dim=-1)
    mv_int = (torch.stack([idx2 % d - r, idx2 // d - r], dim=-1)
              * 4).to(torch.int32)
    pred_n = pred.reshape(n, 2)

    if not subpel:
        preds = mc_luma(ref, x0s, y0s, mv_int, s, bitdepth)
        satd = satd8_batch(preds - cur_blocks)
        rate = (_mv_bits_est(mv_int[:, 0] - pred_n[:, 0])
                + _mv_bits_est(mv_int[:, 1] - pred_n[:, 1]))
        cost_i = satd.to(torch.float32) + rate * lam
        return mv_int.reshape(by, bx, 2), cost_i.reshape(by, bx)

    satd49 = refine_qpel_dense(cur_blocks, ref, x0s, y0s, mv_int, s,
                               bitdepth)                  # (N, 49)
    cands = mv_int[:, None, :] + device_table("QPEL_OFFSETS", dev)
    rate = (_mv_bits_est(cands[..., 0] - pred_n[:, None, 0])
            + _mv_bits_est(cands[..., 1] - pred_n[:, None, 1]))
    c = satd49.to(torch.float32) + rate * lam
    k = torch.argmin(c, dim=-1)
    mv_q = cands[torch.arange(n, device=dev), k]
    cost_q = torch.min(c, dim=-1).values
    return mv_q.reshape(by, bx, 2).to(torch.int32), cost_q.reshape(by, bx)


def _blocks_to_plane(blocks, by: int, bx: int, size: int):
    return blocks.reshape(by, bx, size, size).permute(0, 2, 1, 3).reshape(
        by * size, bx * size)


def mc_planes(ref_y, ref_cb, ref_cr, mv, plan: IntraFramePlan,
              bitdepth: int = 8):
    """Full-frame MC prediction planes of the final MVs (one reference).

    mv: (By, Bx, 2) quarter-pel.  Returns (pred_y (H, W), pred_cb,
    pred_cr) int32.  Each block is interpolated from its own clamped
    window; the JAX package reaches the same samples through
    whole-plane phase planes on a 72-pixel edge extension, which is
    exact while an MV reaches at most 72 pixels outside the frame
    (config.validate caps me_range at 64)."""
    s = plan.cu_size
    by, bx = plan.blocks_y, plan.blocks_x
    x0s, y0s = _block_origins(plan, mv.device)
    mvs = mv.reshape(by * bx, 2).to(torch.int32)
    py = mc_luma(ref_y.to(torch.int32), x0s, y0s, mvs, s, bitdepth)
    out_y = _blocks_to_plane(py, by, bx, s)
    if ref_cb is None:
        return out_y, None, None
    s2 = s // 2
    pcb = mc_chroma(ref_cb.to(torch.int32), x0s // 2, y0s // 2, mvs, s2,
                    bitdepth)
    pcr = mc_chroma(ref_cr.to(torch.int32), x0s // 2, y0s // 2, mvs, s2,
                    bitdepth)
    return (out_y, _blocks_to_plane(pcb, by, bx, s2),
            _blocks_to_plane(pcr, by, bx, s2))
