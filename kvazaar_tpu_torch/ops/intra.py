"""HEVC intra prediction (H.265 8.4.4.2), batched, as integer linear maps.

Counterpart of kvazaar_tpu/ops/intra.py.  Every intra mode (planar, the
DC base value, all 33 angular modes) is an integer linear map from the
reference-sample vector followed by a rounding shift, precomputed per
block size as W: (35, N*N, 2*(4N+1)) over [unfiltered | smoothed]
refs.  The DC and mode-10/26 boundary fixups are small post-passes.
``mode_weights_np`` and ``_filter_flag`` are copies of the JAX
package's (a test pins the tables).

Reference-vector layout (length 4N+1):
    ref[i]        = p[-1][2N-1-i]   for i in [0, 2N)   (left column, bottom-up)
    ref[2N]       = p[-1][-1]        (corner)
    ref[2N+1+x]   = p[x][-1]         for x in [0, 2N)   (top row)
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from kvazaar_tpu_torch.ops.exactmm import einsum_exact

# H.265 Table 8-4/8-5.
INTRA_PRED_ANGLE = np.array(
    [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26, -32,
     -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21, 26, 32],
    dtype=np.int32)  # index = mode - 2
INV_ANGLE = np.array(
    [-4096, -1638, -910, -630, -482, -390, -315, -256,
     -315, -390, -482, -630, -910, -1638, -4096],
    dtype=np.int32)  # index = mode - 11, for modes 11..25


def _ref_index_left(n: int, y: int) -> int:
    """Index of p[-1][y] in the ref vector (y in [-1, 2N-1])."""
    return 2 * n - 1 - y


def _ref_index_top(n: int, x: int) -> int:
    """Index of p[x][-1] in the ref vector (x in [-1, 2N-1])."""
    return 2 * n + 1 + x


def _filter_flag(mode: int, n: int) -> bool:
    """H.265 8.4.4.2.3 filterFlag (luma)."""
    if mode == 1 or n == 4:
        return False
    min_dist = min(abs(mode - 26), abs(mode - 10))
    thresh = {8: 7, 16: 1, 32: 0}[n]
    return min_dist > thresh


@functools.lru_cache(maxsize=None)
def mode_weights_np(n: int, luma: bool):
    """(W, shifts): W is (35, N*N, 2*(4N+1)) int32; shifts is (35,) int32.

    Column space = [unfiltered refs | smoothed refs]; each mode's taps live
    in the half the spec assigns it (chroma always unfiltered).
    """
    rlen = 4 * n + 1
    w = np.zeros((35, n * n, 2 * rlen), dtype=np.int32)
    shifts = np.zeros((35,), dtype=np.int32)
    log2n = int(n).bit_length() - 1

    def col(mode, ridx):
        use_filt = luma and _filter_flag(mode, n)
        return ridx + (rlen if use_filt else 0)

    # --- Planar (8.4.4.2.4) ---
    shifts[0] = log2n + 1
    for y in range(n):
        for x in range(n):
            p = y * n + x
            w[0, p, col(0, _ref_index_left(n, y))] += n - 1 - x
            w[0, p, col(0, _ref_index_top(n, n))] += x + 1
            w[0, p, col(0, _ref_index_top(n, x))] += n - 1 - y
            w[0, p, col(0, _ref_index_left(n, n))] += y + 1

    # --- DC base value (8.4.4.2.5); boundary fixup applied separately ---
    shifts[1] = log2n + 1
    for y in range(n):
        for x in range(n):
            p = y * n + x
            for xx in range(n):
                w[1, p, col(1, _ref_index_top(n, xx))] += 1
            for yy in range(n):
                w[1, p, col(1, _ref_index_left(n, yy))] += 1

    # --- Angular modes 2..34 (8.4.4.2.6) ---
    for mode in range(2, 35):
        shifts[mode] = 5
        angle = int(INTRA_PRED_ANGLE[mode - 2])
        vertical = mode >= 18

        def ext_ref(k: int) -> int:
            # Index into the ref vector of extended array ref_v/ref_h[k].
            if vertical:
                if k >= 0:
                    return _ref_index_top(n, k - 1)
                inv = int(INV_ANGLE[mode - 11])
                return _ref_index_left(n, -1 + ((k * inv + 128) >> 8))
            else:
                if k >= 0:
                    return _ref_index_left(n, k - 1)
                inv = int(INV_ANGLE[mode - 11])
                return _ref_index_top(n, -1 + ((k * inv + 128) >> 8))

        for y in range(n):
            for x in range(n):
                p = y * n + x
                t = (y + 1) if vertical else (x + 1)
                idx = (t * angle) >> 5
                fact = (t * angle) & 31
                base = (x if vertical else y) + idx + 1
                w[mode, p, col(mode, ext_ref(base))] += 32 - fact
                if fact:
                    w[mode, p, col(mode, ext_ref(base + 1))] += fact
    return w, shifts


@functools.lru_cache(maxsize=16)
def _weights(n: int, luma: bool, device: torch.device):
    """(W int32 (35, N*N, 2R), shifts int32 (35,)) on ``device``."""
    w, shifts = mode_weights_np(n, luma)
    return (torch.from_numpy(w).to(device),
            torch.from_numpy(shifts).to(device))


def smooth_refs(refs: torch.Tensor) -> torch.Tensor:
    """[1 2 1]/4 smoothing along the ref vector, endpoints kept
    (8.4.4.2.3)."""
    f = (refs[..., :-2] + 2 * refs[..., 1:-1] + refs[..., 2:] + 2) >> 2
    return torch.cat([refs[..., :1], f, refs[..., -1:]], dim=-1)


def _clip_pix(x, bitdepth):
    return torch.clamp(x, 0, (1 << bitdepth) - 1)


def _refs2(refs: torch.Tensor, n: int, luma: bool) -> torch.Tensor:
    filt = smooth_refs(refs) if (luma and n >= 8) else refs
    return torch.cat([refs, filt], dim=-1)


def predict_all_modes(refs: torch.Tensor, n: int, luma: bool = True,
                      bitdepth: int = 8) -> torch.Tensor:
    """refs: (B, 4N+1) int32 substituted reference vectors (unfiltered).
    Returns (B, 35, N, N) int32 predictions of every mode."""
    w, shifts = _weights(n, luma, refs.device)
    raw = einsum_exact("mpr,br->bmp", w, _refs2(refs, n, luma))
    pred = (raw + (1 << (shifts - 1))[None, :, None]) \
        >> shifts[None, :, None]
    pred = pred.reshape(pred.shape[0], 35, n, n)
    return _apply_fixups(pred, refs, n, luma, bitdepth)


def _boundary_pieces(refs, n):
    top = refs[..., 2 * n + 1: 2 * n + 1 + n]            # p[0..N-1][-1]
    left = torch.flip(refs[..., n: 2 * n], dims=(-1,))    # p[-1][0..N-1]
    corner = refs[..., 2 * n]
    return top, left, corner


def _fixup_planes(pred_dc, pred, refs, n, bitdepth):
    """(DC-with-boundary, mode-10, mode-26) planes from the (B, N, N)
    DC base prediction and the (B, N, N) plane each fixup starts from
    (JAX: the mode's own plane in predict_all_modes, the selected plane
    in predict_modes)."""
    top, left, corner = _boundary_pieces(refs, n)
    dc = pred_dc[:, n // 2, n // 2]   # DC base value (constant over block)
    p_dc = pred_dc.clone()
    p_dc[:, 0, :] = (top + 3 * dc[:, None] + 2) >> 2
    p_dc[:, :, 0] = (left + 3 * dc[:, None] + 2) >> 2
    p_dc[:, 0, 0] = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2
    p10 = pred[0].clone()
    p10[:, 0, :] = _clip_pix(left[:, :1] + ((top - corner[:, None]) >> 1),
                             bitdepth)
    p26 = pred[1].clone()
    p26[:, :, 0] = _clip_pix(top[:, :1] + ((left - corner[:, None]) >> 1),
                             bitdepth)
    return p_dc, p10, p26


def _apply_fixups(pred, refs, n, luma, bitdepth):
    """DC boundary smoothing and mode 10/26 edge filters (luma, N<32)."""
    if not luma or n >= 32:
        return pred
    p_dc, p10, p26 = _fixup_planes(pred[:, 1], (pred[:, 10], pred[:, 26]),
                                   refs, n, bitdepth)
    pred = pred.clone()
    pred[:, 1] = p_dc
    pred[:, 10] = p10
    pred[:, 26] = p26
    return pred


def predict_modes(refs: torch.Tensor, modes: torch.Tensor, n: int,
                  luma: bool = True, bitdepth: int = 8) -> torch.Tensor:
    """Predict one chosen mode per block.

    refs: (B, 4N+1) int32; modes: (B,) integer. Returns (B, N, N) int32.
    """
    w, shifts = _weights(n, luma, refs.device)
    modes = modes.to(torch.int64)
    ssel = shifts[modes]                                 # (B,)
    raw = einsum_exact("bpr,br->bp", w[modes], _refs2(refs, n, luma))
    pred = (raw + (1 << (ssel - 1))[:, None]) >> ssel[:, None]
    pred = pred.reshape(pred.shape[0], n, n)
    if not luma or n >= 32:
        return pred
    p_dc, p10, p26 = _fixup_planes(pred, (pred, pred), refs, n, bitdepth)
    pred = torch.where((modes == 1)[:, None, None], p_dc, pred)
    pred = torch.where((modes == 10)[:, None, None], p10, pred)
    return torch.where((modes == 26)[:, None, None], p26, pred)
