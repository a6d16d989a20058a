"""Inter prediction ops: fractional-sample interpolation and exhaustive
integer-pel SAD motion search, as plain int32 tensor code.

Counterpart of kvazaar_tpu/ops/inter.py for P and B frames: one
reference picture, or stacked references with a per-block index for MC,
and the bi-pred average of two 14-bit predictions.  The
JAX package shapes these ops for the TPU's matrix unit (one-hot matmuls
for the window gather, banded 0/1 matmuls for block sums and for the
quarter-pel filters, bf16 splits to keep them exact); here the same
integer arithmetic is advanced indexing, shifted slices and reshape
sums, exact in int32 on any device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# H.265 Table 8-11: luma 8-tap filters per quarter phase.
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)

# H.265 Table 8-12 (chroma): 4-tap filters per eighth phase.
CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int32)

# (qx, qy) quarter-pel offsets of the dense refinement grid, row-major
# over qy then qx in -3..3.
QPEL_OFFSETS = np.array([(qx, qy) for qy in range(-3, 4)
                         for qx in range(-3, 4)], np.int32)


@functools.lru_cache(maxsize=None)
def device_table(name: str, device: torch.device) -> torch.Tensor:
    """One of this module's constant tables on ``device``, uploaded once
    (a per-call copy from pageable memory would make the host wait for
    the device)."""
    return torch.from_numpy(globals()[name]).to(device)


def gather_windows(plane: torch.Tensor, x0s: torch.Tensor,
                   y0s: torch.Tensor, win: int, ridx=None) -> torch.Tensor:
    """Clamped window gather: (N, win, win) from (H, W) at per-block
    integer origins, which may lie outside the plane (the clamp is the
    spec's reference padding, 8.5.3.3.3.1).  With stacked references
    (R, H, W), ridx (N,) picks each block's plane."""
    h, w = plane.shape[-2], plane.shape[-1]
    ar = torch.arange(win, device=plane.device)
    ys = torch.clamp(y0s[:, None] + ar[None, :], 0, h - 1)
    xs = torch.clamp(x0s[:, None] + ar[None, :], 0, w - 1)
    if ridx is not None:
        return plane[ridx.long()[:, None, None], ys[:, :, None],
                     xs[:, None, :]]
    return plane[ys[:, :, None], xs[:, None, :]]


def _tap_sum(win: torch.Tensor, coeffs: torch.Tensor, taps: int,
             out_len: int, axis_last: bool) -> torch.Tensor:
    """Per-block FIR along the last (or second-to-last) axis.  win:
    (N, H, W) int32; coeffs: (N, taps).  Returns (N, H, out_len) for
    axis_last, else (N, out_len, W)."""
    acc = None
    for k in range(taps):
        sl = (win[..., k:k + out_len] if axis_last
              else win[:, k:k + out_len, :])
        term = coeffs[:, k, None, None] * sl
        acc = term if acc is None else acc + term
    return acc


def mc_luma_hp(plane, x0s, y0s, mvs, size: int, bitdepth: int = 8,
               ridx=None):
    """Luma MC at the 14-bit intermediate precision (8.5.3.3.3.1).

    plane: (H, W) int32 reference (or (R, H, W) with ridx (N,) per
    block); x0s/y0s: (N,) block origins; mvs: (N, 2) quarter-pel (mvx,
    mvy).  Returns (N, S, S) int32."""
    ix = x0s + (mvs[:, 0] >> 2)
    iy = y0s + (mvs[:, 1] >> 2)
    fx = (mvs[:, 0] & 3).long()
    fy = (mvs[:, 1] & 3).long()
    win = gather_windows(plane, ix - 3, iy - 3, size + 7,
                         ridx).to(torch.int32)
    lf = device_table("LUMA_FILTERS", plane.device)
    hor = _tap_sum(win, lf[fx], 8, size, True)       # (N, S+7, S)
    shift1 = bitdepth - 8
    if shift1:
        hor = hor >> shift1
    return _tap_sum(hor, lf[fy], 8, size, False) >> 6


def uni_round(hp: torch.Tensor, bitdepth: int = 8) -> torch.Tensor:
    """Default weighted-sample process, uni-pred (8.5.3.3.4.2)."""
    shift = 14 - bitdepth
    return torch.clamp((hp + (1 << (shift - 1))) >> shift, 0,
                       (1 << bitdepth) - 1)


def bi_average(hp0: torch.Tensor, hp1: torch.Tensor,
               bitdepth: int = 8) -> torch.Tensor:
    """Default weighted-sample process, bi-pred (8.5.3.3.4.2): the two
    14-bit predictions averaged with one final rounding."""
    shift = 15 - bitdepth
    return torch.clamp((hp0 + hp1 + (1 << (shift - 1))) >> shift, 0,
                       (1 << bitdepth) - 1)


def mc_luma(plane, x0s, y0s, mvs, size: int, bitdepth: int = 8,
            ridx=None):
    """Motion-compensated luma prediction (uni-pred), (N, S, S) int32."""
    return uni_round(mc_luma_hp(plane, x0s, y0s, mvs, size, bitdepth,
                                ridx), bitdepth)


def mc_chroma_hp(plane, x0s, y0s, mvs, size: int, bitdepth: int = 8,
                 ridx=None):
    """Chroma MC at 14-bit precision (4-tap, eighth-pel).  mvs are the
    LUMA quarter-pel MVs, i.e. eighth-pel chroma MVs in 4:2:0."""
    ix = x0s + (mvs[:, 0] >> 3)
    iy = y0s + (mvs[:, 1] >> 3)
    fx = (mvs[:, 0] & 7).long()
    fy = (mvs[:, 1] & 7).long()
    win = gather_windows(plane, ix - 1, iy - 1, size + 3,
                         ridx).to(torch.int32)
    cf = device_table("CHROMA_FILTERS", plane.device)
    hor = _tap_sum(win, cf[fx], 4, size, True)
    shift1 = bitdepth - 8
    if shift1:
        hor = hor >> shift1
    return _tap_sum(hor, cf[fy], 4, size, False) >> 6


def mc_chroma(plane, x0s, y0s, mvs, size: int, bitdepth: int = 8,
              ridx=None):
    return uni_round(mc_chroma_hp(plane, x0s, y0s, mvs, size, bitdepth,
                                  ridx), bitdepth)


def edge_pad(plane: torch.Tensor, pad: int) -> torch.Tensor:
    """Replicate the border of an (H, W) plane by ``pad`` samples."""
    h, w = plane.shape
    dev = plane.device
    ys = torch.clamp(torch.arange(-pad, h + pad, device=dev), 0, h - 1)
    xs = torch.clamp(torch.arange(-pad, w + pad, device=dev), 0, w - 1)
    return plane[ys[:, None], xs[None, :]]


def sad_surfaces(cur_plane, ref_plane, radius: int, size: int,
                 bitdepth: int = 8) -> torch.Tensor:
    """Exhaustive integer-pel SAD surfaces of every size-aligned block:
    (By, Bx, 2R+1, 2R+1) int32 indexed [by, bx, dy+R, dx+R].

    One pass per dy: the edge-padded reference rows shifted by every dx
    at once, |difference| against the current plane, and block sums by
    reshape."""
    h, w = cur_plane.shape
    r = radius
    d = 2 * r + 1
    by, bx = h // size, w // size
    cur = cur_plane.to(torch.int32)
    pad = edge_pad(ref_plane.to(torch.int32), r)
    out = []
    for dy in range(d):
        rows = pad[dy:dy + h]                            # (H, W + 2R)
        sl = torch.stack([rows[:, k:k + w] for k in range(d)])
        diff = torch.abs(sl - cur[None])                 # (D, H, W)
        blk = diff.reshape(d, by, size, bx, size).sum(
            dim=(2, 4), dtype=torch.int32)               # (D, By, Bx)
        out.append(blk)
    sads = torch.stack(out)                              # (Ddy, Ddx, ...)
    return sads.permute(2, 3, 0, 1).contiguous()


def refine_qpel_dense(cur_blocks, ref_plane, x0s, y0s, mv_int,
                      size: int, bitdepth: int = 8) -> torch.Tensor:
    """SATD of all 49 quarter-pel positions of the 7x7 grid around each
    block's integer winner.

    Every candidate lies within +-3/4 px of mv_int, so one
    (S+8, S+8) window per block covers them all; each of the 7 phases
    per axis is an 8-tap sum over shifted slices of it.
    cur_blocks: (N, S, S) int32; mv_int: (N, 2) qpel, multiples of 4.
    Returns (N, 49) int32 in QPEL_OFFSETS order."""
    from kvazaar_tpu_torch.encoder.intra_search import satd8_batch
    n = cur_blocks.shape[0]
    ox = x0s + (mv_int[:, 0] >> 2) - 4
    oy = y0s + (mv_int[:, 1] >> 2) - 4
    win = gather_windows(ref_plane, ox, oy, size + 8).to(torch.int32)
    shift1 = bitdepth - 8

    def phase(q):
        # Window offset c0 of phase q (the integer part of q/4, plus the
        # filter's 3-sample lead) and its filter taps.
        return 1 + (q >> 2), [int(c) for c in LUMA_FILTERS[q & 3]]

    hors = []
    for qx in range(-3, 4):
        c0, taps = phase(qx)
        acc = sum(t * win[:, :, c0 + k:c0 + k + size]
                  for k, t in enumerate(taps) if t)    # (N, S+8, S)
        hors.append(acc >> shift1 if shift1 else acc)
    preds = []
    for qy in range(-3, 4):
        c0, taps = phase(qy)
        for hv in hors:
            v = sum(t * hv[:, c0 + k:c0 + k + size, :]
                    for k, t in enumerate(taps) if t) >> 6
            preds.append(uni_round(v, bitdepth))
    preds = torch.stack(preds, dim=1)                    # (N, 49, S, S)
    return satd8_batch(preds - cur_blocks[:, None])


def sad_surfaces_multi(cur_plane, ref_plane, radius: int, sizes,
                       bitdepth: int = 8) -> dict:
    """Integer-pel SAD surfaces for several block sizes in one pass:
    {size: (H//size, W//size, 2R+1, 2R+1) int32}.

    SAD is additive over sub-blocks, so the surface of the smallest size
    is taken once and each larger size is the 2x2 block sum of the one
    below it at the same displacement.  Grids use floor division: a
    plane not divisible by a size gives the aligned crop's grid, with
    the SADs still taken against the full plane (real samples beyond
    the crop, not the edge clamp)."""
    h, w = cur_plane.shape
    r = radius
    d = 2 * r + 1
    szs = sorted(set(int(s) for s in sizes))
    base = szs[0]
    by, bx = h // base, w // base
    hc, wc = by * base, bx * base
    cur = cur_plane.to(torch.int32)[:hc, :wc]
    pad = edge_pad(ref_plane.to(torch.int32), r)
    rows_out = []
    for dy in range(d):
        rows = pad[dy:dy + hc]                          # (Hc, W + 2R)
        sl = torch.stack([rows[:, k:k + wc] for k in range(d)])
        blk = torch.abs(sl - cur[None]).reshape(d, by, base, bx, base).sum(
            dim=(2, 4), dtype=torch.int32)              # (Ddx, By, Bx)
        rows_out.append(blk)
    s_now = torch.stack(rows_out)                       # (Ddy, Ddx, By, Bx)
    out = {}
    sz_now = base
    for s in szs:
        while sz_now < s:
            by2, bx2 = s_now.shape[2] // 2, s_now.shape[3] // 2
            s_now = (s_now[:, :, 0:2 * by2:2, 0:2 * bx2:2]
                     + s_now[:, :, 1:2 * by2:2, 0:2 * bx2:2]
                     + s_now[:, :, 0:2 * by2:2, 1:2 * bx2:2]
                     + s_now[:, :, 1:2 * by2:2, 1:2 * bx2:2])
            sz_now *= 2
        out[s] = s_now.permute(2, 3, 0, 1).contiguous()
    return out


def box4_mean(plane: torch.Tensor) -> torch.Tensor:
    """4x4 mean pool (floor) of an (H, W) plane over its 4-aligned crop:
    the coarse level of the hierarchical motion search."""
    h4, w4 = plane.shape[0] // 4, plane.shape[1] // 4
    p = plane[:h4 * 4, :w4 * 4].to(torch.int32)
    return p.reshape(h4, 4, w4, 4).sum(dim=(1, 3), dtype=torch.int32) >> 4


def coarse_mv_grids(cur, ref, radius: int, sizes, bitdepth: int = 8) -> dict:
    """Hierarchical motion search, stage 1: dense SAD surfaces of the
    4x4-pooled planes within max(radius // 4, 2) coarse samples, each
    size's argmin as a full-resolution MV hint grid in quarter-pel
    units, {size: (H//size, W//size, 2) int32 (x, y)}.  Sizes below 16
    take the 16 grid's winner, repeated (their pooled blocks are too
    small to rank); stage 2 (the hint branch of search_inter_frame)
    refines +-4 full-resolution samples around the hint and around
    zero."""
    c4 = box4_mean(cur)
    r4 = box4_mean(ref)
    rad4 = max(radius // 4, 2)
    want = sorted({int(s) for s in sizes if s >= 16}) or [16]
    surf = sad_surfaces_multi(c4, r4, rad4, tuple(s // 4 for s in want),
                              bitdepth)
    d = 2 * rad4 + 1
    out = {}
    for s in want:
        su = surf[s // 4]
        idx = torch.argmin(su.reshape(su.shape[0], su.shape[1], d * d),
                           dim=-1)
        # One coarse step is 4 samples, 16 quarter-pel units.
        out[s] = torch.stack([(idx % d - rad4) * 16,
                              (idx // d - rad4) * 16],
                             dim=-1).to(torch.int32)
    parent = min(out)
    for s in sizes:
        if s < 16:
            f = parent // s
            out[s] = torch.repeat_interleave(
                torch.repeat_interleave(out[parent], f, dim=0), f, dim=1)
    return out
