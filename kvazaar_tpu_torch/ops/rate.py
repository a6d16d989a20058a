"""Vectorized TB coefficient-rate model for RDO (--rd 2 and the
variable-CU tree costs).

Counterpart of kvazaar_tpu/ops/rate.py: static per-bin costs for the
context-coded syntax elements, exact bit counts for the bypass-coded
ones (signs, Golomb-Rice remainders, last-position suffixes), batched
over leading axes.  The constants are the JAX package's.

The result is float32, and three of its sums add non-dyadic constants
(0.9 and 0.6 per coded sub-block flag, 0.9 per gt2 flag), so their
float32 value depends on the order of the additions.  They are formed
here in the JAX package's order on its CPU backend, left to right in
runs of 32 terms whose partial sums are then added left to right (the
XLA CPU compiler's tree reduction); ``tests/test_torch_quadtree.py``
pins the result against the JAX function.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from kvazaar_tpu_torch.ops.scan import coeff_scan

_BITS_SIG_1 = 1.0     # sig_coeff_flag = 1
_BITS_SIG_0 = 0.5     # sig_coeff_flag = 0
_BITS_CSBF_1 = 0.9
_BITS_CSBF_0 = 0.6
_BITS_GT1 = 1.0
_BITS_GT2 = 0.9
_BITS_LAST_CTX = 0.85  # per last_sig prefix bin


@functools.lru_cache(maxsize=None)
def _scan_tables_np(size: int):
    """Static diag-scan tables: per scan index the flat position and
    the (x, y) coordinate."""
    log2n = size.bit_length() - 1
    scan = coeff_scan(log2n, 0)                 # (S*S, 2) (x, y)
    sx = scan[:, 0].astype(np.int32)
    sy = scan[:, 1].astype(np.int32)
    flat_of_scan = (sy * size + sx).astype(np.int32)
    return flat_of_scan, sx, sy


@functools.lru_cache(maxsize=None)
def _last_prefix_bits(size: int):
    """Bits to code a last_sig coordinate value v (9.3.3.1.2): ctx-coded
    TR prefix (group index bins) + exact bypass suffix bits."""
    out = np.zeros(size, np.float32)
    max_g = {4: 3, 8: 5, 16: 7, 32: 9}[size]
    for v in range(size):
        if v < 4:
            g, suffix = v, 0
        else:
            k = int(np.floor(np.log2(v)))
            g = 2 * k + ((v >> (k - 1)) & 1)   # lastSigCoeffGroupIdx
            suffix = k - 1                     # bypass suffix bits
        prefix_bins = g + 1 if g < max_g else max_g
        out[v] = _BITS_LAST_CTX * prefix_bins + suffix
    return out


@functools.lru_cache(maxsize=None)
def _tables(size: int, device: torch.device):
    flat_of_scan, sx, sy = _scan_tables_np(size)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return (t(flat_of_scan.astype(np.int64)), t(sx.astype(np.int64)),
            t(sy.astype(np.int64)), t(_last_prefix_bits(size)))


def _sum_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis in the JAX package's CPU order:
    left to right within runs of 32, then the runs' sums left to
    right."""
    n = x.shape[-1]
    parts = []
    for lo in range(0, n, 32):
        acc = x[..., lo]
        for i in range(lo + 1, min(lo + 32, n)):
            acc = acc + x[..., i]
        parts.append(acc)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def tb_rate_bits(levels: torch.Tensor) -> torch.Tensor:
    """Estimated bits to code one TB's quantized levels (diag scan).

    levels: (..., S, S) integer -> (...,) float32.  Zero TBs cost about
    the cbf flag alone (0.7)."""
    s = levels.shape[-1]
    dev = levels.device
    flat_of_scan, sx, sy, lp = _tables(s, dev)
    f32 = torch.float32
    a = torch.abs(levels.to(torch.int32)).reshape(*levels.shape[:-2],
                                                  s * s)
    a_scan = a[..., flat_of_scan]                      # scan order
    nz = a_scan > 0
    n = s * s
    idx = torch.arange(n, device=dev)
    last = torch.max(torch.where(nz, idx, -1), dim=-1).values
    any_nz = last >= 0
    lastc = torch.clamp(last, min=0)

    # last_sig_coeff_x/y bits from the last coefficient's coordinates.
    bits = lp[sx[lastc]] + lp[sy[lastc]]

    # Group structure (4x4 sub-blocks along the scan).
    ng = n // 16
    g = a_scan.reshape(*a_scan.shape[:-1], ng, 16)
    gnz = torch.any(g > 0, dim=-1)
    g_idx = torch.arange(ng, device=dev)
    last_g = lastc // 16
    in_region = g_idx <= last_g[..., None]
    coded_csbf = in_region & (g_idx != last_g[..., None]) & (g_idx != 0)
    zero = torch.zeros((), dtype=f32, device=dev)
    bits = bits + _sum_f32(torch.where(
        coded_csbf,
        torch.where(gnz, torch.tensor(_BITS_CSBF_1, dtype=f32, device=dev),
                    torch.tensor(_BITS_CSBF_0, dtype=f32, device=dev)),
        zero))

    # sig flags: coeffs in coded groups of the region, scan positions
    # before last (1.0 and 0.5 are exact, so the order is free).
    pos_in_region = idx < last[..., None]
    grp_coded = (torch.repeat_interleave(gnz | (g_idx == last_g[..., None]),
                                         16, dim=-1)
                 & torch.repeat_interleave(in_region, 16, dim=-1))
    sig_coded = pos_in_region & grp_coded
    bits = bits + torch.sum(torch.where(
        sig_coded, torch.where(nz, _BITS_SIG_1, _BITS_SIG_0), 0.0).to(f32),
        dim=-1)

    gnz_cnt = torch.sum((g > 0).to(torch.int32), dim=-1)
    n_gt1 = torch.clamp(gnz_cnt, max=8)
    bits = bits + torch.sum(n_gt1.to(f32) * _BITS_GT1, dim=-1)
    bits = bits + _sum_f32(torch.where(
        gnz_cnt > 0, torch.tensor(_BITS_GT2, dtype=f32, device=dev), zero))
    bits = bits + torch.sum(nz.to(f32), dim=-1)      # sign bits

    # Remainders: Golomb-Rice lengths with a per-group Rice parameter
    # from the group's mean magnitude (all integer-valued floats).
    rem = torch.clamp(g - 2, min=0)
    gsum = torch.sum(g, dim=-1)
    rice = torch.clamp(torch.floor(torch.log2(torch.clamp(
        gsum.to(f32) / 8.0, min=1.0))), 0, 4).to(torch.int32)[..., None]
    vf = rem.to(f32)
    kf = rice.to(f32)
    p2k = torch.exp2(kf)
    pre = torch.floor(vf / p2k)
    b_short = pre + 1 + kf
    eg = 2 * torch.floor(torch.log2(torch.clamp(
        vf - 8 * p2k + torch.exp2(kf + 1), min=1.0))) + 1 - kf
    b_long = 8 + 1 + torch.maximum(eg, kf + 1)
    rb = torch.where(pre < 8, b_short, b_long)
    bits = bits + torch.sum(torch.where(rem > 0, rb, zero).reshape(
        *rem.shape[:-2], -1), dim=-1)
    # cbf flag itself (context bin).
    return torch.where(any_nz, bits + 0.9,
                       torch.tensor(0.7, dtype=f32, device=dev))
