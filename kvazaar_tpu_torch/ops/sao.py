"""Sample-adaptive offset (H.265 8.7.3) on the device: per-CTU
statistics, the parameter decision with its greedy merge, and the
filter, batched over leading (frame) axes.

Counterpart of the device path of kvazaar_tpu/ops/sao.py (``sao_stats``,
``sao_decide_frame_device``, ``apply_sao_plane``): SAO is a pure
post-pass over the deblocked frame; the statistics are per-CTU integer
sums per edge category and band, the offsets are chosen in closed form
from them, and the merge-left / merge-up decisions run as a wavefront
over the CTU anti-diagonals (a CTU's merge candidates are its left and
upper neighbours' resolved parameters, one diagonal earlier).

Conventions: type 0 = off, 1 = band, 2 = edge; edge offsets are stored
signed (+, +, -, -) as applied; band_position is the first of 4
consecutive bands (the window wraps).

Under tiles the decision runs on the host instead (``sao_decide_frame``
and its helpers, numpy copies of the JAX package's host functions, the
colliding names suffixed ``_np``): a CTU's merge candidates must stay
inside its tile (7.3.8.3), which the device's merge wavefront does not
see.

The decision's costs are float32 ``ddist + lam * bits`` and are formed
as the JAX package's CPU backend forms them (one fused multiply-add,
``_fma_f32``; pinned with tolerance 0 by tests/test_torch_sao.py).
"""

from __future__ import annotations

import numpy as np
import torch

from kvazaar_tpu_torch.ops.quant import _f32, _fma_f32

# Edge class neighbour directions (8.7.3: 0 = 0 deg, 1 = 90 deg, 2 = 135
# deg, 3 = 45 deg).
EO_DIRS = ((1, 0), (0, 1), (1, 1), (1, -1))
# Edge category of sign(p - a) + sign(p - b) + 2.
_CAT_OF_SIGNS = (1, 2, 0, 3, 4)


def _edge_categories(p: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """Per-sample edge category 0..4 of one class over (..., H, W) int32
    samples; samples with a neighbour outside the picture are 0."""
    h, w = p.shape[-2:]
    a = torch.roll(p, shifts=(dy, dx), dims=(-2, -1))      # p[y-dy, x-dx]
    b = torch.roll(p, shifts=(-dy, -dx), dims=(-2, -1))    # p[y+dy, x+dx]
    s = torch.sign(p - a) + torch.sign(p - b) + 2
    lut = torch.tensor(_CAT_OF_SIGNS, dtype=p.dtype, device=p.device)
    cat = lut[s.long()]
    yy = torch.arange(h, device=p.device)[:, None]
    xx = torch.arange(w, device=p.device)[None, :]
    inside = ((yy - abs(dy) >= 0) & (yy + abs(dy) < h)
              & (xx - abs(dx) >= 0) & (xx + abs(dx) < w))
    return torch.where(inside, cat, 0)


def sao_stats(orig: torch.Tensor, rec: torch.Tensor, ctu: int = 64,
              bitdepth: int = 8):
    """Per-CTU SAO statistics of one plane (..., H, W) (integer samples,
    any leading frame axes).  Partial boundary CTUs count their padding
    as edge category 0 with zero difference, as the JAX package does.
    Returns int32 (edge_cnt (..., 4, 5, Cy, Cx), edge_sum (same),
    band_cnt (..., 32, Cy, Cx), band_sum (same))."""
    lead = rec.shape[:-2]
    h, w = rec.shape[-2:]
    dev = rec.device
    cy, cx = -(-h // ctu), -(-w // ctu)
    hp, wp = cy * ctu, cx * ctu
    nb = int(np.prod(lead, dtype=np.int64))
    ncell = cy * cx
    r = rec.to(torch.int32).reshape(nb, h, w)
    diff = orig.to(torch.int64).reshape(nb, h, w) - r
    pad = (0, wp - w, 0, hp - h)
    cell = ((torch.arange(hp, device=dev)[:, None] // ctu) * cx
            + torch.arange(wp, device=dev)[None, :] // ctu)
    frame = torch.arange(nb, device=dev)[:, None, None]

    cats = torch.stack([_edge_categories(r, dx, dy) for dx, dy in EO_DIRS],
                       dim=1)                                  # (nb, 4, h, w)
    cats = torch.nn.functional.pad(cats, pad).to(torch.int64)
    cls = torch.arange(4, device=dev)[None, :, None, None]
    e_idx = ((frame[:, None] * 4 + cls) * 5 + cats) * ncell + cell
    e_diff = torch.nn.functional.pad(diff, pad)[:, None].expand_as(e_idx)
    n_e = nb * 20 * ncell
    e_cnt = torch.zeros(n_e, dtype=torch.int64, device=dev).index_add_(
        0, e_idx.reshape(-1), torch.ones_like(e_idx).reshape(-1))
    e_sum = torch.zeros(n_e, dtype=torch.int64, device=dev).index_add_(
        0, e_idx.reshape(-1), e_diff.reshape(-1))

    band = (r >> (bitdepth - 5)).to(torch.int64)
    b_idx = (frame * 32 + band) * ncell + cell[:h, :w]
    n_b = nb * 32 * ncell
    b_cnt = torch.zeros(n_b, dtype=torch.int64, device=dev).index_add_(
        0, b_idx.reshape(-1), torch.ones_like(b_idx).reshape(-1))
    b_sum = torch.zeros(n_b, dtype=torch.int64, device=dev).index_add_(
        0, b_idx.reshape(-1), diff.reshape(-1))

    def shaped(t, *dims):
        return t.reshape(*lead, *dims, cy, cx).to(torch.int32)

    return (shaped(e_cnt, 4, 5), shaped(e_sum, 4, 5), shaped(b_cnt, 32),
            shaped(b_sum, 32))


def _best_offset(cnt: torch.Tensor, acc: torch.Tensor, lo, hi):
    """Closed-form offsets of SAO categories (int32 counts and difference
    sums): round(acc / cnt) in float32, half to even, clipped to +-7
    and to [lo, hi] (an edge category's sign constraint: 0..7 or -7..0),
    then the best of +-1 around it by the exact quadratic ddist =
    cnt*o^2 - 2*o*acc.  Returns (offset, ddist) int32 (0, 0 when no
    candidate improves)."""
    off = torch.where(cnt > 0,
                      torch.round(acc.to(torch.float32)
                                  / torch.clamp(cnt, min=1).to(torch.float32)),
                      0.0)
    off = torch.clamp(torch.clamp(off, -7, 7).to(torch.int32), lo, hi)
    best_off = torch.zeros_like(off)
    best_d = torch.zeros_like(off)
    for delta in (-1, 0, 1):
        o = torch.clamp(off + delta, lo, hi)
        d = cnt * o * o - 2 * o * acc
        take = d < best_d
        best_off = torch.where(take, o, best_off)
        best_d = torch.where(take, d, best_d)
    return best_off, best_d


def _offset_bits(off: torch.Tensor, edge: bool) -> torch.Tensor:
    """Approximate signalling bits of one offset (float32): TR cMax 7,
    plus a sign bin for band offsets."""
    a = torch.abs(off).to(torch.float32)
    bits = torch.clamp(a + 1, max=7.0)
    if not edge:
        bits = bits + (a > 0).to(torch.float32)
    return bits


def _edge_offsets(e_cnt, e_sum):
    """Offsets of every edge class and category 1..4 of one component:
    (offsets (..., 4 classes, 4, Cy, Cx), ddist per class, bits per
    class without the 4 bits of type and class)."""
    def bound(v):
        return torch.tensor(v, dtype=torch.int32,
                            device=e_cnt.device)[:, None, None]

    lo, hi = bound([0, 0, -7, -7]), bound([7, 7, 0, 0])
    offs, dd = _best_offset(e_cnt[..., 1:, :, :], e_sum[..., 1:, :, :], lo,
                            hi)
    # Integer sums: exact in any order.
    return (offs, dd.sum(dim=-3, dtype=torch.int32),
            _offset_bits(offs, True).sum(dim=-3))


def _band_windows(b_cnt, b_sum):
    """Per band window (the 4 bands from each position, wrapping):
    (offsets (..., 32 windows, 4, Cy, Cx), ddist, offset bits)."""
    offs, dd = _best_offset(b_cnt, b_sum, -7, 7)
    win = (torch.arange(32, device=offs.device)[:, None]
           + torch.arange(4, device=offs.device)) & 31
    return (offs[..., win, :, :], dd[..., win, :, :].sum(
        dim=-3, dtype=torch.int32), _offset_bits(offs, False)[
            ..., win, :, :].sum(dim=-3))


def _pick(cands, idx):
    """cands[..., idx, :, Cy, Cx] per CTU -> (..., Cy, Cx, 4)."""
    i = idx[..., None, None, :, :].expand(*idx.shape[:-2], 1,
                                          *cands.shape[-3:])
    return torch.gather(cands, -4, i)[..., 0, :, :, :].movedim(-3, -1)


def _first_min(costs):
    """(min, index of its first occurrence) over dim -3: the reference's
    sequential ``if cost < best`` scan over its candidates in order."""
    return torch.amin(costs, dim=-3), torch.argmin(costs, dim=-3)


def _choose_luma(e_cnt, e_sum, b_cnt, b_sum, lam: float) -> dict:
    """Own parameters of one component per CTU: the cheapest of off,
    the 4 edge classes and the 32 band windows, in that order, first on
    ties.  The edge class keeps the best edge choice even when a band
    wins (the reference's band scan leaves it)."""
    eoffs, edd, ebits = _edge_offsets(e_cnt, e_sum)
    boffs, bdd, bbits = _band_windows(b_cnt, b_sum)
    off_cost = torch.full_like(edd[..., :1, :, :], _f32(lam),
                               dtype=torch.float32)
    costs = torch.cat([off_cost, _fma_f32(edd.to(torch.float32), lam,
                                          4.0 + ebits),
                       _fma_f32(bdd.to(torch.float32), lam, 7.0 + bbits)],
                      dim=-3)
    cost, idx = _first_min(costs)
    eo = torch.clamp(_first_min(costs[..., :5, :, :])[1] - 1, min=0)
    zero = torch.zeros_like(eoffs[..., :1, :, :, :])
    return dict(type=torch.where(idx == 0, 0, torch.where(idx <= 4, 2, 1)),
                eo_class=eo, band_pos=torch.clamp(idx - 5, min=0),
                offsets=_pick(torch.cat([zero, eoffs, boffs], dim=-4), idx),
                cost=cost)


def _choose_chroma(scb, scr, lam: float) -> dict:
    """Joint Cb + Cr parameters: shared type and edge class (7.3.8.3),
    separate offsets and band positions."""
    ob, ddb, bitsb = _edge_offsets(scb[0], scb[1])
    orr, ddr, bitsr = _edge_offsets(scr[0], scr[1])
    off_cost = torch.full_like(ddb[..., :1, :, :], _f32(lam),
                               dtype=torch.float32)
    e_cost, e_idx = _first_min(torch.cat(
        [off_cost, _fma_f32((ddb + ddr).to(torch.float32), lam,
                            4.0 + bitsb + bitsr)], dim=-3))
    zero = torch.zeros_like(ob[..., :1, :, :, :])
    e_ob = _pick(torch.cat([zero, ob], dim=-4), e_idx)
    e_or = _pick(torch.cat([zero, orr], dim=-4), e_idx)

    def band_best(stats):
        boffs, bdd, bbits = _band_windows(stats[2], stats[3])
        cost, bp = _first_min(_fma_f32(bdd.to(torch.float32), lam,
                                       5.0 + bbits))
        return cost, bp, _pick(boffs, bp)

    cb_cost, cb_bp, cb_off = band_best(scb)
    cr_cost, cr_bp, cr_off = band_best(scr)
    cost = cb_cost + cr_cost + 2.0 * _f32(lam)
    take = cost < e_cost
    z = torch.zeros_like(cb_bp)
    return dict(type=torch.where(take, 1, torch.where(e_idx > 0, 2, 0)),
                eo_class=torch.clamp(e_idx - 1, min=0),
                bp_cb=torch.where(take, cb_bp, z),
                bp_cr=torch.where(take, cr_bp, z),
                off_cb=torch.where(take[..., None], cb_off, e_ob),
                off_cr=torch.where(take[..., None], cr_off, e_or),
                cost=torch.where(take, cost, e_cost))


# The packed per-CTU parameters of the merge wavefront (int32, last
# axis): type (luma, chroma), edge class (luma, chroma), band position
# (y, cb, cr), offsets (y, cb, cr) x 4.
_T, _EO, _BP, _OFF = slice(0, 2), slice(2, 4), slice(4, 7), slice(7, 19)


def _apply_cost(stats, q):
    """float32 ddist of applying packed parameters q (..., Cy, Cx, 19)
    per CTU, from the components' statistics stats = (edge_cnt,
    edge_sum (..., Cy, Cx, C, 4, 5), band_cnt, band_sum (..., Cy, Cx,
    C, 32)), C = 1 (luma) or 3; the components' ddists are added in
    float32, luma first."""
    lead = q.shape[:-1]
    ec, es = (a.expand(*lead, *a.shape[-3:]) for a in stats[:2])
    bc, bs = (a.expand(*lead, *a.shape[-2:]) for a in stats[2:])
    nc = ec.shape[-3]
    j = [0, 1, 1][:nc]
    t = q[..., _T][..., j]                                   # (..., C)
    offs = q[..., _OFF].unflatten(-1, (3, 4))[..., :nc, :]  # (..., C, 4)
    cls = q[..., _EO][..., j].long()[..., None, None].expand(*lead, nc, 1,
                                                              5)
    ec_c = torch.gather(ec, -2, cls)[..., 0, 1:]
    es_c = torch.gather(es, -2, cls)[..., 0, 1:]
    dd_e = torch.sum(ec_c * offs * offs - 2 * offs * es_c, dim=-1,
                     dtype=torch.int32)
    widx = (q[..., _BP][..., :nc, None].long()
            + torch.arange(4, device=q.device)) & 31
    dd_b = torch.sum(torch.gather(bc, -1, widx) * offs * offs
                     - 2 * offs * torch.gather(bs, -1, widx), dim=-1,
                     dtype=torch.int32)
    term = torch.where(t == 2, dd_e,
                       torch.where(t == 1, dd_b, 0)).to(torch.float32)
    c = term[..., 0]
    for i in range(1, nc):
        c = c + term[..., i]
    return c


def sao_decide_frame_device(stats_y, stats_c, lam: float) -> dict:
    """Per-CTU SAO parameters of a frame from its statistics (leading
    frame axes allowed): each CTU's own choice, then the greedy raster
    merge as a wavefront over the CTU anti-diagonals.  stats_y: luma
    (edge_cnt, edge_sum, band_cnt, band_sum); stats_c: (Cb stats, Cr
    stats) or None.  Returns the resolved int32 arrays merge (..., Cy,
    Cx), type (..., Cy, Cx, 2), eo (..., Cy, Cx, 2), bp (..., Cy, Cx,
    3), off (..., Cy, Cx, 3, 4)."""
    cy, cx = stats_y[0].shape[-2:]
    dev = stats_y[0].device
    luma = _choose_luma(*stats_y, lam)
    z = torch.zeros_like(luma["type"])
    zo = torch.zeros_like(luma["offsets"])
    own_cost = luma["cost"]
    comps = [stats_y]
    if stats_c is None:
        fields = [luma["type"], z, luma["eo_class"], z, luma["band_pos"], z,
                  z]
        offs = [luma["offsets"], zo, zo]
    else:
        cpar = _choose_chroma(*stats_c, lam)
        fields = [luma["type"], cpar["type"], luma["eo_class"],
                  cpar["eo_class"], luma["band_pos"], cpar["bp_cb"],
                  cpar["bp_cr"]]
        offs = [luma["offsets"], cpar["off_cb"], cpar["off_cr"]]
        own_cost = own_cost + cpar["cost"]
        comps += list(stats_c)
    params = torch.cat([torch.stack(fields, dim=-1)] + offs,
                       dim=-1).to(torch.int32)
    # Per CTU: (..., Cy, Cx, C, 4, 5) edge and (..., Cy, Cx, C, 32) band
    # counts and sums.
    stats = tuple(
        torch.stack([s[i] for s in comps], dim=-5 if i < 2 else -4).movedim(
            (-2, -1), (-5, -4) if i < 2 else (-4, -3)) for i in range(4))

    lam32 = _f32(lam)
    yy = torch.arange(cy, device=dev)[:, None]
    xx = torch.arange(cx, device=dev)[None, :]
    left_ok = (xx > 0).expand(cy, cx)
    up_ok = (yy > 0).expand(cy, cx)
    # Products of lam with 0, 1 or 2 are exact: no rounding question.
    base = own_cost + lam32 * (left_ok.to(torch.float32)
                               + up_ok.to(torch.float32))
    up_bits = lam32 * (left_ok.to(torch.float32) + 1.0)
    merge = torch.zeros_like(z, dtype=torch.int32)
    for d in range(cy + cx - 1):
        on_diag = (yy + xx) == d
        # Each CTU's left and upper neighbours' resolved parameters.
        cand = torch.stack([torch.roll(params, 1, dims=-2),
                            torch.roll(params, 1, dims=-3)])
        cost = _apply_cost(stats, cand)
        cl = cost[0] + lam32
        tl = left_ok & (cl < base)
        tu = up_ok & (cost[1] + up_bits < torch.where(tl, cl, base))
        choice = torch.where(tu, 2, torch.where(tl, 1, 0)).to(torch.int32)
        params = torch.where((on_diag & tu)[..., None], cand[1], torch.where(
            (on_diag & tl & ~tu)[..., None], cand[0], params))
        merge = torch.where(on_diag, choice, merge)
    return dict(merge=merge, type=params[..., _T], eo=params[..., _EO],
                bp=params[..., _BP],
                off=params[..., _OFF].unflatten(-1, (3, 4)))


def apply_sao_plane(rec: torch.Tensor, sao_type: torch.Tensor,
                    eo_class: torch.Tensor, band_pos: torch.Tensor,
                    offsets: torch.Tensor, ctu: int = 64,
                    bitdepth: int = 8) -> torch.Tensor:
    """Filter one plane (..., H, W) with per-CTU parameters (..., Cy,
    Cx) and signed offsets (..., Cy, Cx, 4).  Returns the filtered
    plane in rec's dtype."""
    h, w = rec.shape[-2:]
    cy, cx = sao_type.shape[-2:]
    lead = rec.shape[:-2]
    dev = rec.device
    p = rec.to(torch.int32)
    ctuy = torch.arange(h, device=dev) // ctu
    ctux = torch.arange(w, device=dev) // ctu
    cell = (ctuy[:, None] * cx + ctux[None, :]).expand(*lead, h, w)

    def per_sample(a):
        return torch.gather(a.reshape(*lead, cy * cx), -1,
                            cell.reshape(*lead, h * w)).reshape(*lead, h, w)

    t_map = per_sample(sao_type.to(torch.int32))
    cats = torch.stack([_edge_categories(p, dx, dy) for dx, dy in EO_DIRS],
                       dim=-3)
    cls_map = per_sample(eo_class.to(torch.int64))
    cat = torch.gather(cats, -3, cls_map[..., None, :, :])[..., 0, :, :]
    # Offsets per CTU with a leading 0 for category 0, flattened so one
    # gather reads offset k of each sample's CTU.
    off5 = torch.cat([torch.zeros((*offsets.shape[:-1], 1), dtype=torch.int32,
                                  device=dev), offsets.to(torch.int32)],
                     dim=-1).reshape(*lead, cy * cx * 5)

    def offset_at(k):
        return torch.gather(off5, -1, (cell * 5 + k).reshape(
            *lead, h * w)).reshape(*lead, h, w)

    eo_off = offset_at(cat.to(torch.int64))
    widx = (p >> (bitdepth - 5)) - per_sample(band_pos.to(torch.int32))
    widx = widx & 31                                       # wraps (8.7.3)
    b_off = torch.where(widx < 4,
                        offset_at(torch.clamp(widx, 0, 3).to(torch.int64)
                                  + 1), 0)
    out = torch.where(t_map == 2, p + eo_off,
                      torch.where(t_map == 1, p + b_off, p))
    return torch.clamp(out, 0, (1 << bitdepth) - 1).to(rec.dtype)


# ---- Host decision (tiles): numpy copies of the JAX package's host
# functions (kvazaar_tpu/ops/sao.py:106-396). ----


def _best_offset_np(cnt, acc, sign):
    """Closed-form offset choice per category (the reference's
    sao_calc_offset + dist model): offset = clamp(round(acc/cnt)) with
    spec sign constraint; returns (offset, ddist) where ddist =
    cnt*off^2 - 2*off*acc (negative = improvement)."""
    cnt = cnt.astype(np.int64)
    acc = acc.astype(np.int64)
    with np.errstate(divide="ignore", invalid="ignore"):
        off = np.where(cnt > 0,
                       np.round(acc / np.maximum(cnt, 1)), 0)
    off = np.clip(off, -7, 7).astype(np.int64)
    if sign > 0:
        off = np.maximum(off, 0)
    elif sign < 0:
        off = np.minimum(off, 0)
    # refine +-1 around the rounded value (the quadratic is exact)
    best_off = np.zeros_like(off)
    best_d = np.zeros_like(off)
    for delta in (-1, 0, 1):
        o = np.clip(off + delta, -7, 7)
        if sign > 0:
            o = np.maximum(o, 0)
        elif sign < 0:
            o = np.minimum(o, 0)
        d = cnt * o * o - 2 * o * acc
        take = d < best_d
        best_off = np.where(take, o, best_off)
        best_d = np.where(take, d, best_d)
    return best_off, best_d


def _offset_bits_np(off, edge: bool):
    """Approximate signalling bits of one offset (TR cMax 7 bypass +
    sign for band)."""
    a = np.abs(off)
    bits = np.minimum(a + 1, 7)
    if not edge:
        bits = bits + (a > 0)
    return bits


def choose_sao_params(e_cnt, e_sum, b_cnt, b_sum, lam: float):
    """Per-CTU parameter selection for one component from device stats
    (numpy).  Returns dict with arrays over (Cy, Cx): type (0/1/2),
    eo_class, band_pos, offsets (4,) signed, cost (RD of the choice;
    OFF has cost 0 baseline + ~1 bit)."""
    _, _, cy, cx = e_cnt.shape
    best_type = np.zeros((cy, cx), np.int8)
    best_eo = np.zeros((cy, cx), np.int8)
    best_bp = np.zeros((cy, cx), np.int8)
    best_off = np.zeros((cy, cx, 4), np.int8)
    # OFF: ddist 0, ~1 bit for type.
    best_cost = np.full((cy, cx), lam * 1.0)

    for cls in range(4):
        offs = np.zeros((cy, cx, 4), np.int64)
        dd = np.zeros((cy, cx), np.int64)
        bits = np.full((cy, cx), 4.0)   # type(2) + eo_class(2)
        for k, sign in zip(range(1, 5), (1, 1, -1, -1)):
            o, d = _best_offset_np(e_cnt[cls, k], e_sum[cls, k], sign)
            offs[:, :, k - 1] = o
            dd += d
            bits += _offset_bits_np(o, True)
        cost = dd + lam * bits
        take = cost < best_cost
        best_cost = np.where(take, cost, best_cost)
        best_type = np.where(take, 2, best_type)
        best_eo = np.where(take, cls, best_eo)
        best_off = np.where(take[..., None], offs, best_off)

    # Band: best 4-consecutive-band window.
    boffs = np.zeros((32, cy, cx), np.int64)
    bdd = np.zeros((32, cy, cx), np.int64)
    for k in range(32):
        o, d = _best_offset_np(b_cnt[k], b_sum[k], 0)
        boffs[k] = o
        bdd[k] = d
    for bp in range(32):
        # The 4-band window wraps (8.7.3: bandTable[(bp + i) & 31]).
        idx = [(bp + i) & 31 for i in range(4)]
        dd = sum(bdd[i] for i in idx)
        obits = sum(_offset_bits_np(boffs[i], False) for i in idx)
        cost = dd + lam * (2.0 + 5.0 + obits)
        take = cost < best_cost
        if not take.any():
            continue
        best_cost = np.where(take, cost, best_cost)
        best_type = np.where(take, 1, best_type)
        best_bp = np.where(take, bp, best_bp)
        woff = np.stack([boffs[i] for i in idx], axis=-1)
        best_off = np.where(take[..., None], woff, best_off)

    return dict(type=best_type, eo_class=best_eo, band_pos=best_bp,
                offsets=best_off.astype(np.int8), cost=best_cost)


def _dd_edge(e_cnt, e_sum, cls, offs, cy, cx):
    dd = np.zeros((cy, cx), np.int64)
    for k in range(1, 5):
        o = offs[..., k - 1].astype(np.int64)
        dd += e_cnt[cls, k] * o * o - 2 * o * e_sum[cls, k]
    return dd


def _dd_band(b_cnt, b_sum, bp, offs, cy, cx):
    dd = np.zeros((cy, cx), np.int64)
    for i in range(4):
        idx = (bp + i) & 31
        o = offs[..., i].astype(np.int64)
        cnt = np.take_along_axis(b_cnt, idx[None], axis=0)[0]
        sm = np.take_along_axis(b_sum, idx[None], axis=0)[0]
        dd += cnt * o * o - 2 * o * sm
    return dd


def sao_decide_frame(stats_y, stats_c, lam: float,
                     tile_col=None, tile_row=None):
    """Full SAO parameter decision for one frame from device stats.

    stats_y: (e_cnt, e_sum, b_cnt, b_sum) luma; stats_c: ((cb...),
    (cr...)) or None.  Returns the FrameData-style arrays: merge
    (Cy,Cx), type (Cy,Cx,2), eo (Cy,Cx,2), bp (Cy,Cx,3),
    off (Cy,Cx,3,4) — resolved post-merge values (reference analogue:
    sao_search_best_mode + merge evaluation, src/sao.c:467-646)."""
    e_cnt, e_sum, b_cnt, b_sum = [np.asarray(a) for a in stats_y]
    _, _, cy, cx = e_cnt.shape
    luma = choose_sao_params(e_cnt, e_sum, b_cnt, b_sum, lam)
    chroma = stats_c is not None
    if chroma:
        scb = [np.asarray(a) for a in stats_c[0]]
        scr = [np.asarray(a) for a in stats_c[1]]
        cpar = _choose_chroma_np(scb, scr, lam)

    n_t = np.zeros((cy, cx, 2), np.uint8)
    n_eo = np.zeros((cy, cx, 2), np.uint8)
    n_bp = np.zeros((cy, cx, 3), np.uint8)
    n_off = np.zeros((cy, cx, 3, 4), np.int8)
    n_merge = np.zeros((cy, cx), np.uint8)
    n_t[:, :, 0] = luma["type"]
    n_eo[:, :, 0] = luma["eo_class"]
    n_bp[:, :, 0] = luma["band_pos"]
    n_off[:, :, 0] = luma["offsets"]
    own_cost = luma["cost"].copy()
    if chroma:
        n_t[:, :, 1] = cpar["type"]
        n_eo[:, :, 1] = cpar["eo_class"]
        n_bp[:, :, 1] = cpar["bp_cb"]
        n_bp[:, :, 2] = cpar["bp_cr"]
        n_off[:, :, 1] = cpar["off_cb"]
        n_off[:, :, 2] = cpar["off_cr"]
        own_cost = own_cost + cpar["cost"]

    def cost_with(params, yy, xx):
        """RD of applying (t, eo, bp, off) params at CTU (yy, xx)."""
        t2, eo2, bp2, off2 = params
        c = 0.0
        comps = [(0, e_cnt, e_sum, b_cnt, b_sum)]
        if chroma:
            comps += [(1, scb[0], scb[1], scb[2], scb[3]),
                      (2, scr[0], scr[1], scr[2], scr[3])]
        for (ci, ec, es, bc, bs) in comps:
            t = int(t2[0 if ci == 0 else 1])
            offs = off2[ci].astype(np.int64)
            if t == 2:
                cls = int(eo2[0 if ci == 0 else 1])
                dd = 0
                for k in range(1, 5):
                    o = int(offs[k - 1])
                    dd += int(ec[cls, k, yy, xx]) * o * o \
                        - 2 * o * int(es[cls, k, yy, xx])
                c += dd
            elif t == 1:
                bp = int(bp2[ci])
                dd = 0
                for i in range(4):
                    idx = (bp + i) & 31
                    o = int(offs[i])
                    dd += int(bc[idx, yy, xx]) * o * o \
                        - 2 * o * int(bs[idx, yy, xx])
                c += dd
        return c

    # Greedy raster merge decisions (exact RD on the stats).
    # Merge flags exist only toward neighbors in the SAME tile
    # (7.3.8.3 conditions; tile_col/tile_row: tile id per CTU axis).
    def left_ok(yy, xx):
        return xx > 0 and (tile_col is None
                           or tile_col[xx - 1] == tile_col[xx])

    def up_ok(yy, xx):
        return yy > 0 and (tile_row is None
                           or tile_row[yy - 1] == tile_row[yy])

    for yy in range(cy):
        for xx in range(cx):
            best = own_cost[yy, xx] + lam * (left_ok(yy, xx)
                                             + up_ok(yy, xx))
            choice = 0
            if left_ok(yy, xx):
                p = (n_t[yy, xx - 1], n_eo[yy, xx - 1],
                     n_bp[yy, xx - 1], n_off[yy, xx - 1])
                cm = cost_with(p, yy, xx) + lam * 1.0
                if cm < best:
                    best, choice = cm, 1
            if up_ok(yy, xx):
                p = (n_t[yy - 1, xx], n_eo[yy - 1, xx],
                     n_bp[yy - 1, xx], n_off[yy - 1, xx])
                cm = cost_with(p, yy, xx) + lam * (left_ok(yy, xx)
                                                   + 1.0)
                if cm < best:
                    best, choice = cm, 2
            if choice:
                sy, sx = (yy, xx - 1) if choice == 1 else (yy - 1, xx)
                n_t[yy, xx] = n_t[sy, sx]
                n_eo[yy, xx] = n_eo[sy, sx]
                n_bp[yy, xx] = n_bp[sy, sx]
                n_off[yy, xx] = n_off[sy, sx]
                n_merge[yy, xx] = choice
    return dict(merge=n_merge, type=n_t, eo=n_eo, bp=n_bp, off=n_off)


def _choose_chroma_np(scb, scr, lam):
    """Joint cb+cr choice: shared type and eo_class (7.3.8.3),
    separate offsets and band positions."""
    ecb, esb, bcb, bsb = scb
    ecr, esr, bcr, bsr = scr
    _, _, cy, cx = ecb.shape
    best = dict(type=np.zeros((cy, cx), np.uint8),
                eo_class=np.zeros((cy, cx), np.uint8),
                bp_cb=np.zeros((cy, cx), np.uint8),
                bp_cr=np.zeros((cy, cx), np.uint8),
                off_cb=np.zeros((cy, cx, 4), np.int8),
                off_cr=np.zeros((cy, cx, 4), np.int8),
                cost=np.full((cy, cx), lam * 1.0))
    for cls in range(4):
        offs_b = np.zeros((cy, cx, 4), np.int64)
        offs_r = np.zeros((cy, cx, 4), np.int64)
        dd = np.zeros((cy, cx), np.int64)
        bits = np.full((cy, cx), 4.0)
        for k, sign in zip(range(1, 5), (1, 1, -1, -1)):
            ob, db = _best_offset_np(ecb[cls, k], esb[cls, k], sign)
            orr, dr = _best_offset_np(ecr[cls, k], esr[cls, k], sign)
            offs_b[:, :, k - 1] = ob
            offs_r[:, :, k - 1] = orr
            dd += db + dr
            bits += _offset_bits_np(ob, True) + _offset_bits_np(orr, True)
        cost = dd + lam * bits
        take = cost < best["cost"]
        best["cost"] = np.where(take, cost, best["cost"])
        best["type"] = np.where(take, 2, best["type"])
        best["eo_class"] = np.where(take, cls, best["eo_class"])
        best["off_cb"] = np.where(take[..., None], offs_b,
                                  best["off_cb"]).astype(np.int8)
        best["off_cr"] = np.where(take[..., None], offs_r,
                                  best["off_cr"]).astype(np.int8)

    def band_best(bc, bs):
        boffs = np.zeros((32, cy, cx), np.int64)
        bdd = np.zeros((32, cy, cx), np.int64)
        for k in range(32):
            o, d = _best_offset_np(bc[k], bs[k], 0)
            boffs[k] = o
            bdd[k] = d
        bcost = np.full((cy, cx), np.inf)
        bbp = np.zeros((cy, cx), np.uint8)
        boff = np.zeros((cy, cx, 4), np.int64)
        for bp in range(32):
            idx = [(bp + i) & 31 for i in range(4)]
            dd = sum(bdd[i] for i in idx)
            bits = 5.0 + sum(_offset_bits_np(boffs[i], False) for i in idx)
            cost = dd + lam * bits
            take = cost < bcost
            bcost = np.where(take, cost, bcost)
            bbp = np.where(take, bp, bbp)
            w = np.stack([boffs[i] for i in idx], axis=-1)
            boff = np.where(take[..., None], w, boff)
        return bcost, bbp, boff

    cb_cost, cb_bp, cb_off = band_best(bcb, bsb)
    cr_cost, cr_bp, cr_off = band_best(bcr, bsr)
    cost = cb_cost + cr_cost + lam * 2.0
    take = cost < best["cost"]
    best["cost"] = np.where(take, cost, best["cost"])
    best["type"] = np.where(take, 1, best["type"])
    best["bp_cb"] = np.where(take, cb_bp, best["bp_cb"]).astype(np.uint8)
    best["bp_cr"] = np.where(take, cr_bp, best["bp_cr"]).astype(np.uint8)
    best["off_cb"] = np.where(take[..., None], cb_off,
                              best["off_cb"]).astype(np.int8)
    best["off_cr"] = np.where(take[..., None], cr_off,
                              best["off_cr"]).astype(np.int8)
    return best
