"""HEVC quantization / dequantization (H.265 8.6.3), RDOQ and sign-data
hiding, batched.

Counterpart of kvazaar_tpu/ops/quant.py: the scalar quantizer and RDOQ
take a frame-level QP or one QP per block (LCU rate control, ROI and
AQ), and at a frame-level QP the per-position tables of a scaling list
(``qc`` / ``dqc``, ops/scaling.py, an (intra, inter) pair selected per
block like the rounding offset; dequantization then follows the
reference's scaling-list schedule).  int32 arithmetic exactly as the
JAX package forms it; the scale tables are copies pinned by a test.

RDOQ's costs are float32 and decide levels at near-ties, so they are
formed as the JAX package's CPU backend forms them (pinned with
tolerance 0 by tests/test_torch_rdoq.py):

- the rate of a level above 2 holds ``2 * log2(rem + 2) + 1``, which
  XLA computes as ONE fused multiply-add of its float32 natural log
  with ``2 * float32(1 / ln 2)``, and XLA's float32 log is not
  correctly rounded: it is one ulp off at 308 of the reachable
  integers 2..32766.  ``rem_bits_np`` holds the result per level,
  built on the host from the correctly rounded log and the listed
  exceptions, and moved to the device once: the same values on the CPU
  and on a card;
- ``dist + lam * rate`` is one fused multiply-add (``_fma_f32``), but
  for the all-zero candidate, whose rate XLA folds to a constant, it
  adds the scalar product ``lam * 0.15`` rounded on its own;
- the 4x4 group sums add the 16 costs in XLA's order (``_group_sum``).

Inside the JAX package's encoder programs two of these differ (read
from the optimized LLVM IR of its fixed-grid I, P and B programs, tiled
or not, and of its variable-tree programs; F2 in ROADMAP.md), and
``quantize_rdoq(program=)`` follows each:

- there the forward transform feeds RDOQ, and LLVM vectorizes the kept
  costs' group sums over each group's columns, adding row after row
  (``_group_sum_rows``); the zeroed distortions keep ``_group_sum``'s
  order (``program`` "grid" and "var");
- in the fixed-grid programs lambda is a compile-time constant, and LLVM
  moves the product by it inside the select between a level's rate and
  0.15, so ``lam * rate`` is rounded before the add, with no fused
  multiply-add (``program="grid"``); the variable-tree programs take
  lambda at run time and keep the fused multiply-add (``"var"``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from kvazaar_tpu_torch.ops.scan import scan_order

# g_quantScales / g_invQuantScales of the standard (per qp % 6).
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564],
                        dtype=np.int32)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)

QUANT_SHIFT = 14


def quant_params(qp: int, log2_size: int, bitdepth: int):
    """(scale, qbits, inv_scale, inv_shift) for a transform size."""
    transform_shift = 15 - bitdepth - log2_size  # MAX_TR_DYNAMIC_RANGE=15
    qbits = QUANT_SHIFT + qp // 6 + transform_shift
    inv_shift = bitdepth + log2_size - 5
    return (int(QUANT_SCALES[qp % 6]), qbits,
            int(INV_QUANT_SCALES[qp % 6]), inv_shift)


def _quant_params_arr(qp: torch.Tensor, log2_size: int, bitdepth: int):
    """Array form of quant_params for a per-block QP tensor (LCU rate
    control, ROI and AQ): (scale, qbits, inv_scale) of qp's shape; the
    inverse shift depends on the size alone."""
    qp = qp.to(torch.int32)
    idx = torch.remainder(qp, 6).long()
    qbits = QUANT_SHIFT + torch.div(qp, 6, rounding_mode="floor") \
        + (15 - bitdepth - log2_size)
    return (int32_table(QUANT_SCALES.tobytes(), qp.device)[idx], qbits,
            int32_table(INV_QUANT_SCALES.tobytes(), qp.device)[idx])


@functools.lru_cache(maxsize=None)
def int32_table(data: bytes, device: torch.device) -> torch.Tensor:
    """An int32 table or index vector on ``device``, uploaded once per
    content (a per-call copy from pageable memory would make the host
    wait for the device)."""
    return torch.from_numpy(np.frombuffer(data, np.int32).copy()).to(device)


def scaling_tables(scaling, size: int, comp: int, qp: int,
                   device: torch.device) -> tuple:
    """(qc_intra, qc_inter, dqc_intra, dqc_inter): the (S, S) int32
    per-position tables of a scaling list (ops.scaling.ScalingLists) for
    one block size, component (0 Y, 1 Cb, 2 Cr) and QP, on ``device``
    (uploaded once per content)."""
    rem = qp % 6
    return tuple(
        int32_table(np.ascontiguousarray(t[rem], np.int32).tobytes(),
                    device).reshape(size, size)
        for t in (scaling.qc(size, True, comp), scaling.qc(size, False, comp),
                  scaling.dqc(size, True, comp),
                  scaling.dqc(size, False, comp)))


def _select(tab, intra):
    """A scaling list's per-position table of each block: ``tab`` is one
    (S, S) table or an (intra, inter) pair, picked by ``intra`` (a bool,
    or a bool tensor over the blocks' leading axes)."""
    if not isinstance(tab, tuple):
        return tab
    if intra is None or isinstance(intra, bool):
        return tab[0] if intra is None or intra else tab[1]
    return torch.where(intra[..., None, None], tab[0], tab[1])


def _no_qp_map(qp, tab):
    if tab is not None and isinstance(qp, torch.Tensor):
        raise NotImplementedError("scaling lists with per-block QP")


def _dequant_sl(l: torch.Tensor, m, sh: int) -> torch.Tensor:
    """The reference's scaling-list dequantization of levels l by
    per-position multipliers m at shift sh = bitdepth + log2 S - 5 -
    QP / 6: rounded down-shift, or below 1 the product clipped to int16
    and shifted up (clipped again by the caller)."""
    if sh > 0:
        return (l * m + (1 << (sh - 1))) >> sh
    return torch.clamp(l * m, -32768, 32767) << (-sh)


def quantize(coeff: torch.Tensor, qp, size: int, bitdepth: int = 8,
             intra=True, qc=None) -> torch.Tensor:
    """Scalar quantization with the 171/512 (intra) or 85/512 (inter)
    rounding offset.  ``intra`` is a bool, or a bool tensor over the
    leading (block) axes of coeff for mixed P-frame batches.  qp is an
    int, or an int tensor of one QP per block over those axes.  qc: a
    scaling list's per-position scale (S, S), or its (intra, inter)
    pair selected by ``intra`` (an int qp only).  int32-safe: |coeff|
    fits int16 (and m >= 8 bounds qc)."""
    _no_qp_map(qp, qc)
    log2n = size.bit_length() - 1
    if isinstance(qp, torch.Tensor):
        scale, qbits, _ = _quant_params_arr(qp, log2n, bitdepth)
        scale, qbits = scale[..., None, None], qbits[..., None, None]
    else:
        scale, qbits, _, _ = quant_params(qp, log2n, bitdepth)
        if qc is not None:
            scale = _select(qc, intra)
    if isinstance(intra, bool):
        offset = (171 if intra else 85) << (qbits - 9)
    else:
        offset = torch.where(intra, 171, 85)[..., None, None] << (qbits - 9)
    c = coeff.to(torch.int32)
    level = torch.clamp((torch.abs(c) * scale + offset) >> qbits, 0, 32767)
    return torch.where(c < 0, -level, level)


def dequantize(level: torch.Tensor, qp, size: int, bitdepth: int = 8,
               dqc=None, intra=None) -> torch.Tensor:
    """Spec scaling with the *16 folded into the shift (int32-safe:
    |level| * levScale << 8 < 2^31); qp as in ``quantize``.  dqc: a
    scaling list's per-position multipliers inv_scale * m (S, S) or
    their (intra, inter) pair selected by ``intra`` (None: intra), with
    the reference's scaling-list schedule (``_dequant_sl``; dqc <= 72 *
    255 keeps |level| * dqc < 2^31)."""
    _no_qp_map(qp, dqc)
    log2n = size.bit_length() - 1
    shift = bitdepth + log2n - 5
    if dqc is not None:
        d = _dequant_sl(level.to(torch.int32), _select(dqc, intra),
                        shift - qp // 6)
        return torch.clamp(d, -32768, 32767)
    if isinstance(qp, torch.Tensor):
        _, _, inv_scale = _quant_params_arr(qp, log2n, bitdepth)
        mult = (inv_scale << torch.div(qp.to(torch.int32), 6,
                                       rounding_mode="floor"))[..., None,
                                                               None]
    else:
        mult = int(INV_QUANT_SCALES[qp % 6]) << (qp // 6)
    d = (level.to(torch.int32) * mult + (1 << (shift - 5))) >> (shift - 4)
    return torch.clamp(d, -32768, 32767)


# Integers in 2..32766 where the float32 natural log of XLA's CPU
# backend is one ulp above (_LOG_UP) or below (_LOG_DOWN) the correctly
# rounded value (measured against jax.jit(jnp.log); pinned by
# tests/test_torch_rdoq.py).
_LOG_UP = (
    7, 47, 49, 335, 383, 402, 434, 715, 858, 1166, 1333, 1385, 1423, 1433,
    1469, 1534, 1562, 1755, 1882, 2436, 2526, 2777, 2845, 2860, 2862, 3100,
    3399, 3625, 3733, 3771, 4352, 4753, 4935, 5484, 5739, 5870, 5904, 5936,
    6077, 6106, 6184, 6197, 6256, 6279, 6423, 6521, 6591, 6749, 6778, 6781,
    6949, 7112, 7178, 8075, 9311, 9345, 9442, 9549, 9742, 10121, 10513,
    10654, 10681, 10912, 11082, 11105, 11143, 11167, 11427, 11451, 11542,
    11560, 11654, 11822, 11853, 11974, 12042, 12221, 12575, 12665, 12760,
    12776, 12799, 12815, 12974, 13120, 13923, 14094, 15196, 15312, 17884,
    18754, 18819, 18914, 18970, 19174, 19306, 19829, 19855, 19941, 20258,
    20266, 20426, 20942, 21022, 21084, 21153, 21175, 21191, 21220, 21246,
    21264, 21389, 21409, 21522, 21570, 21637, 21741, 21785, 21842, 21843,
    21844, 21846, 21847, 21888, 21950, 22055, 22136, 22320, 22413, 22426,
    22434, 22513, 22580, 22632, 22712, 23090, 23226, 23353, 23553, 23738,
    23825, 23838, 23993, 24006, 24175, 24347, 24404, 24696, 25173, 25195,
    25339, 25361, 25410, 25526, 25541, 25609, 25624, 26142, 26211, 26212,
    26213, 26214, 26216, 26217, 26613, 26642, 26784, 26947, 27096, 27167,
    27494, 27529, 27971, 28107, 28256, 28564, 28677, 29630, 30393, 31461)
_LOG_DOWN = (
    179, 429, 626, 716, 721, 730, 795, 1314, 1431, 1453, 1577, 1579, 1781,
    1917, 1950, 2315, 2481, 2504, 2531, 2778, 2857, 2864, 2884, 2891, 2920,
    3280, 3468, 3799, 3828, 4471, 5271, 5305, 5658, 5691, 6344, 6366, 6406,
    7241, 7735, 8719, 8944, 9396, 10676, 10964, 10999, 11216, 11498, 11777,
    11836, 11877, 11936, 12014, 12022, 12027, 12118, 12160, 12353, 12614,
    13263, 13720, 13977, 13985, 14176, 14348, 14562, 14956, 17236, 18094,
    18238, 18518, 19585, 19709, 20541, 20720, 20967, 20976, 21189, 21333,
    21689, 21701, 22278, 22319, 22430, 22587, 22751, 22913, 22943, 23384,
    23474, 23477, 23502, 23667, 23688, 23798, 24015, 24085, 24210, 24403,
    24513, 24565, 24639, 24726, 24817, 24843, 24853, 24864, 25145, 25707,
    25898, 25967, 26458, 26699, 27115, 28010, 28057, 28403, 28546, 28845,
    28941, 28969, 29522, 29890, 30015, 30275, 30364, 30516, 31432)

# float32(1 / ln 2): XLA's log2 is its float32 log times this.
_INV_LN2 = np.float32(1.0 / np.log(2.0))


@functools.lru_cache(maxsize=None)
def log_table_np() -> np.ndarray:
    """(32768,) float32 natural log of 0..32767 as XLA's CPU backend
    rounds it at 2..32766 (entries 0 and 1 are unused)."""
    t = np.log(np.maximum(np.arange(32768), 1).astype(np.float64)
               ).astype(np.float32)
    bits = t.view(np.int32)
    bits[list(_LOG_UP)] += 1
    bits[list(_LOG_DOWN)] -= 1
    return t


@functools.lru_cache(maxsize=None)
def rem_bits_np() -> np.ndarray:
    """(32768,) float32 RDOQ remainder bits per level l: ``2 * log2(l -
    1) + 1`` above 2, else 0, as one fused multiply-add of the float32
    log with 2 * float32(1/ln 2) (exact in float64, rounded once)."""
    lg = log_table_np()[np.maximum(np.arange(32768) - 1, 0)]
    rb = (lg.astype(np.float64) * (2.0 * np.float64(_INV_LN2)) + 1.0
          ).astype(np.float32)
    rb[:3] = 0.0
    return rb


@functools.lru_cache(maxsize=None)
def _rem_bits(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(rem_bits_np()).to(device)


@functools.lru_cache(maxsize=None)
def tskip_bits_np() -> np.ndarray:
    """(32768,) float32 rate term of the transform-skip decision per
    level magnitude a: ``2 + 2 * log2(a + 1)`` for a > 0, else 0, as one
    fused multiply-add of XLA's float32 log of a + 1 with 2 * float32(1 /
    ln 2) (XLA's log is correctly rounded at 32767 and 32768)."""
    lg = np.concatenate([log_table_np(),
                         np.log(np.float64([32768])).astype(np.float32)])
    t = (lg[1:].astype(np.float64) * (2.0 * np.float64(_INV_LN2)) + 2.0
         ).astype(np.float32)
    t[0] = 0.0
    return t


@functools.lru_cache(maxsize=None)
def _tskip_bits(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(tskip_bits_np()).to(device)


def _f32(x: float) -> float:
    """A Python float rounded to float32, as JAX rounds a weak-typed
    scalar against a float32 array."""
    return float(np.float32(x))


def _fma_f32(a: torch.Tensor, lam: float, b: torch.Tensor) -> torch.Tensor:
    """float32 ``a + lam * b`` rounded once, as XLA's CPU backend fuses
    an elementwise multiply-add: the float32 operands' product is exact
    in float64."""
    return (a.to(torch.float64) + _f32(lam) * b.to(torch.float64)
            ).to(torch.float32)


def _group_sum(g: torch.Tensor) -> torch.Tensor:
    """float32 sums of 4x4 groups (..., nsb, 4, nsb, 4) -> (..., nsb,
    nsb) in the order of the JAX package's jitted op: each of the
    group's rows left to right, then (row 0 + row 2) + (row 1 + row 3)."""
    g = g.transpose(-3, -2)                   # (..., nsb, nsb, row, col)
    r = ((g[..., 0] + g[..., 1]) + g[..., 2]) + g[..., 3]
    return (r[..., 0] + r[..., 2]) + (r[..., 1] + r[..., 3])


def _group_sum_rows(g: torch.Tensor) -> torch.Tensor:
    """float32 sums of 4x4 groups (..., nsb, 4, nsb, 4) -> (..., nsb,
    nsb) in the order of the JAX package's encoder programs: the sum
    so far plus each row as a vector of its 4 columns, reduced as
    ((sum + c0) + c2) + (c1 + c3), row after row."""
    g = g.transpose(-3, -2)                   # (..., nsb, nsb, row, col)
    acc = None
    for r in range(4):
        c = g[..., r, :]
        a = c[..., 0] if acc is None else acc + c[..., 0]
        acc = (a + c[..., 2]) + (c[..., 1] + c[..., 3])
    return acc


def quantize_rdoq(coeff: torch.Tensor, qp: int, size: int,
                  bitdepth: int = 8, intra=True, lam: float = 1.0,
                  program: str = "op", qc=None, dqc=None) -> torch.Tensor:
    """Rate-distortion optimized quantization (the JAX package's
    vectorized form of the reference's RDOQ, flat scaling list; qp an
    int, or one QP per block over the leading axes as in ``quantize``,
    with the caller's lambda for every block):
    every coefficient picks the cheapest of {0, l - 1, l} (l the
    round-half level) by pixel-domain distortion + lam * a static rate
    model, then whole 4x4 groups whose coded cost exceeds their zeroed
    distortion are dropped.  ``intra`` enters only through the JAX
    signature: both roundings use the half offset.  program: whose float32
    order to follow (module docstring): "op" the JAX package's jitted
    ``quantize_rdoq`` alone, "grid" its fixed-grid encoder programs,
    "var" its variable-tree programs.  qc / dqc: a scaling list's
    per-position scale and dequantization multipliers (tables or
    (intra, inter) pairs selected by ``intra``, as in ``quantize`` and
    ``dequantize``; an int qp only).  Returns int32 levels."""
    _no_qp_map(qp, qc)
    log2n = size.bit_length() - 1
    inv_shift = bitdepth + log2n - 5
    if isinstance(qp, torch.Tensor):
        scale, qbits, inv_scale = _quant_params_arr(qp, log2n, bitdepth)
        inv_m = (inv_scale << torch.div(qp.to(torch.int32), 6,
                                        rounding_mode="floor"))[..., None,
                                                                None]
        scale, qbits = scale[..., None, None], qbits[..., None, None]
    else:
        scale, qbits, inv_scale, _ = quant_params(qp, log2n, bitdepth)
        inv_m = inv_scale << (qp // 6)
        if qc is not None:
            scale, inv_m = _select(qc, intra), _select(dqc, intra)
    c = coeff.to(torch.int32)
    ac = torch.abs(c)
    l1 = torch.clamp((ac * scale + (1 << (qbits - 1))) >> qbits, 0, 32767)
    cands = torch.stack([torch.zeros_like(l1), torch.clamp(l1 - 1, min=0),
                         l1])
    if qc is not None:
        d = torch.clamp(_dequant_sl(cands, inv_m, inv_shift - qp // 6),
                        -32768, 32767)
    else:
        d = torch.clamp((cands * inv_m + (1 << (inv_shift - 5)))
                        >> (inv_shift - 4), -32768, 32767)
    e = (d - ac).to(torch.float32)
    dist = e * e * (1.0 / float(4 ** (15 - bitdepth - log2n)))
    rate = torch.where(cands > 0, (3.0 + (cands > 1).to(torch.float32))
                       + _rem_bits(c.device)[cands.long()], _f32(0.15))
    if program == "grid":
        costs = dist + rate * _f32(lam)
    else:
        costs = _fma_f32(dist, lam, rate)
    costs[0] = dist[0] + _f32(_f32(lam) * _f32(0.15))
    best, sel = torch.amin(costs, dim=0), torch.argmin(costs, dim=0)
    lvl = torch.gather(cands, 0, sel[None])[0]

    # Group zeroing: drop 4x4 groups whose rate is not worth their
    # distortion (the coded_sub_block_flag trade).
    lead = lvl.shape[:-2]
    nsb = size // 4
    keep = (_group_sum if program == "op" else _group_sum_rows)(
        best.reshape(*lead, nsb, 4, nsb, 4))
    zero = _group_sum(dist[0].reshape(*lead, nsb, 4, nsb, 4))
    kill = (zero < keep + _f32(lam))[..., :, None, :, None]
    lvl = torch.where(kill, 0, lvl.reshape(*lead, nsb, 4, nsb, 4))
    lvl = lvl.reshape(*lead, size, size)
    return torch.where(c < 0, -lvl, lvl)


@functools.lru_cache(maxsize=None)
def _scan4_pos(device: torch.device) -> torch.Tensor:
    """(3, 16) int64: the scan position of each raster position of a
    4x4 group, per scanIdx."""
    pos = np.zeros((3, 16), np.int64)
    for s in range(3):
        so = scan_order(4, s)
        pos[s, so[:, 1] * 4 + so[:, 0]] = np.arange(16)
    return torch.from_numpy(pos).to(device)


def sign_hide(levels: torch.Tensor, scan_sel: torch.Tensor) -> torch.Tensor:
    """Sign-data hiding parity adjustment (the JAX package's non-RDO
    strategy): in each 4x4 group whose last and first nonzero scan
    positions are more than 3 apart, the decoder infers the first
    coefficient's sign from the parity of the group's absolute sum, so
    |first| grows by one where the parity disagrees.

    levels: (..., S, S) int32; scan_sel: (...,) scanIdx per block."""
    s = levels.shape[-1]
    nsb = s // 4
    lead = levels.shape[:-2]
    g = levels.reshape(*lead, nsb, 4, nsb, 4).transpose(-3, -2).reshape(
        *lead, nsb * nsb, 16)
    pos = _scan4_pos(levels.device)[scan_sel.long()][..., None, :]
    nz = g != 0
    first = torch.where(nz, pos, 16).amin(dim=-1)
    last = torch.where(nz, pos, -1).amax(dim=-1)
    at_first = nz & (pos == first[..., None])
    firstv = torch.sum(g * at_first, dim=-1)
    neg = firstv < 0
    odd = (torch.sum(torch.abs(g), dim=-1) & 1) == 1
    mismatch = ((last - first) > 3) & (odd != neg)
    bump = torch.where(neg, -1, 1).to(g.dtype)
    g = g + torch.where(at_first & mismatch[..., None], bump[..., None], 0)
    return g.reshape(*lead, nsb, nsb, 4, 4).transpose(-3, -2).reshape(
        *lead, s, s)
