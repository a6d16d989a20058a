"""Static per-geometry planning: decode order, wavefront schedule, and
reference-sample gather maps with spec substitution resolved at plan time.

Everything here depends only on (width, height, cu_size) — it is computed
once in numpy, cached, and baked into the jitted device program as
constant index tensors.  The key trick: HEVC reference availability
(6.4.1) and reference-sample substitution (8.4.4.2.2) are *static* for a
fixed CU grid, so "substitute unavailable samples by scanning for the
previous available one" becomes a gather-index rewrite, not runtime
control flow.

Reference behavior being matched: kvz_intra_build_reference
(src/intra.c:334) availability walk + the z-scan availability rules the
decoder applies; the wavefront step schedule is the TPU analogue of the
reference's WPP job DAG (src/encoderstate.c:776-830).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


def z_order_index(ix: int, iy: int) -> int:
    """Morton interleave of block coords within a CTU (decode order of
    equal-size CUs, H.265 6.5.2)."""
    z = 0
    for b in range(16):
        z |= ((ix >> b) & 1) << (2 * b)
        z |= ((iy >> b) & 1) << (2 * b + 1)
    return z


@dataclasses.dataclass(frozen=True)
class PlaneMaps:
    """Gather/scatter maps for one plane (luma or chroma)."""
    gather_idx: np.ndarray    # (steps, slots, 4S+1) int32 into flat plane
    no_refs: np.ndarray       # (steps, slots) bool — all refs unavailable
    scatter_idx: np.ndarray   # (steps, slots, S*S) int32 (trash for pads)
    size: int                 # block size S


@dataclasses.dataclass(frozen=True)
class IntraFramePlan:
    width: int                # coded (padded) luma width
    height: int
    cu_size: int
    blocks_x: int
    blocks_y: int
    n_steps: int
    n_slots: int
    step_of_block: np.ndarray   # (By, Bx) int32
    slot_of_block: np.ndarray   # (By, Bx) int32
    block_of_slot: np.ndarray   # (steps, slots) int32 block id, -1 pad
    avail: np.ndarray           # (By, Bx, 5) bool: L, A, AR, BL, AL
    luma: PlaneMaps
    chroma: PlaneMaps | None
    tiles: tuple = (1, 1)       # (columns, rows)
    tile_col_bounds: tuple = () # CTU x boundaries, len tx+1
    tile_row_bounds: tuple = () # CTU y boundaries, len ty+1


def _block_availability(bx, by, Bx, By, order, tile_of=None):
    """Availability of the 5 neighbor blocks (left, above, above-right,
    below-left, above-left) per z-scan decode order.  With a tile map,
    neighbors in a different tile are unavailable (6.4.1: prediction
    never crosses tile boundaries)."""
    me = order[by, bx]
    out = np.zeros(5, dtype=bool)
    for i, (dx, dy) in enumerate([(-1, 0), (0, -1), (1, -1), (-1, 1),
                                  (-1, -1)]):
        nx, ny = bx + dx, by + dy
        if 0 <= nx < Bx and 0 <= ny < By and order[ny, nx] < me \
                and (tile_of is None
                     or tile_of[ny, nx] == tile_of[by, bx]):
            out[i] = True
    return out


def uniform_tile_bounds(n_ctus: int, n_tiles: int) -> list:
    """Uniform-spacing tile boundaries in CTUs (7.4.3.3.1:
    colWidth[i] = ((i+1)*W)/T - (i*W)/T)."""
    return [(i * n_ctus) // n_tiles for i in range(n_tiles + 1)]


def _ref_sample_owner(i: int, s: int):
    """Which neighbor-block region ref index i belongs to, and the sample
    coords relative to the block origin.  Layout (ops/intra.py):
    ref[0..2S-1] = left column bottom-up, ref[2S] = corner,
    ref[2S+1+x] = top row."""
    if i < 2 * s:
        y = 2 * s - 1 - i
        region = 3 if y >= s else 0          # below-left : left
        return region, (-1, y)
    if i == 2 * s:
        return 4, (-1, -1)                   # above-left corner
    x = i - (2 * s + 1)
    region = 2 if x >= s else 1              # above-right : above
    return region, (x, -1)


def _plane_maps(plan_geo, s: int, width: int, height: int) -> PlaneMaps:
    (Bx, By, n_steps, n_slots, block_of_slot, avail) = plan_geo
    rlen = 4 * s + 1
    trash = width * height
    gather = np.full((n_steps, n_slots, rlen), trash, dtype=np.int32)
    no_refs = np.ones((n_steps, n_slots), dtype=bool)
    scatter = np.full((n_steps, n_slots, s * s), trash, dtype=np.int32)

    owners = [_ref_sample_owner(i, s) for i in range(rlen)]
    yy, xx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    block_pix = (yy * width + xx).astype(np.int64).ravel()

    for step in range(n_steps):
        for slot in range(n_slots):
            bid = block_of_slot[step, slot]
            if bid < 0:
                continue
            by, bx = divmod(bid, Bx)
            x0, y0 = bx * s, by * s
            av = avail[by, bx]
            # Raw availability + coords per ref index.
            idx = np.full(rlen, -1, dtype=np.int64)
            for i, (region, (dx, dy)) in enumerate(owners):
                x, y = x0 + dx, y0 + dy
                if av[region] and 0 <= x < width and 0 <= y < height:
                    idx[i] = y * width + x
            # Spec substitution as index rewrite: position i takes the
            # nearest available index at or below i; leading gap takes
            # the first available.
            first = -1
            for i in range(rlen):
                if idx[i] >= 0:
                    first = idx[i]
                    break
            if first >= 0:
                no_refs[step, slot] = False
                cur = first
                for i in range(rlen):
                    if idx[i] >= 0:
                        cur = idx[i]
                    gather[step, slot, i] = cur
            scatter[step, slot] = y0 * width + x0 + block_pix
    return PlaneMaps(gather_idx=gather, no_refs=no_refs,
                     scatter_idx=scatter, size=s)


def plan_flat_gather(plan: "IntraFramePlan", luma: bool = True):
    """(N_blocks, 4S+1) int32 ref-gather indices in raster-block order
    (PlaneMaps.gather_idx indexed by each block's wavefront step/slot).
    Large (up to ~9 MB at 1080p s=8) — thread through jits as a
    devconst argument, keyed by plan_gidx_key, instead of inlining."""
    maps = plan.luma if luma else plan.chroma
    steps = plan.step_of_block.ravel()
    slots = plan.slot_of_block.ravel()
    return maps.gather_idx[steps, slots]


def plan_flat_noref(plan: "IntraFramePlan", luma: bool = True):
    maps = plan.luma if luma else plan.chroma
    steps = plan.step_of_block.ravel()
    slots = plan.slot_of_block.ravel()
    return maps.no_refs[steps, slots]


def plan_gidx_key(plan: "IntraFramePlan", luma: bool = True) -> str:
    maps = plan.luma if luma else plan.chroma
    return (f"gidx.{'l' if luma else 'c'}{maps.size}."
            f"{plan.blocks_y}x{plan.blocks_x}"
            f".t{plan.tiles[0]}x{plan.tiles[1]}")


@functools.lru_cache(maxsize=8)
def make_intra_plan(width: int, height: int, cu_size: int,
                    chroma: bool = True, ctu_size: int = 64,
                    tiles: tuple = (1, 1)) -> IntraFramePlan:
    """Build the full static plan.  width/height are the *coded* sizes
    (multiples of cu_size).  tiles = (columns, rows): uniform-spacing
    tile grid; decode order becomes tile-major (raster over tiles,
    CTU raster within, z within CTU) and availability stops at tile
    boundaries — which also CUTS wavefront dependency chains, so tiles
    shorten the recon schedule (the reference's tile thread
    parallelism, src/encoderstate.c:860-965, recast as schedule
    width)."""
    s = cu_size
    assert width % s == 0 and height % s == 0
    Bx, By = width // s, height // s
    k = ctu_size // s
    tx, ty = tiles

    # Uniform tile boundaries in CTUs -> tile id per block.
    ctus_x = -(-Bx // k)
    ctus_y = -(-By // k)
    cbx = uniform_tile_bounds(ctus_x, tx)
    cby = uniform_tile_bounds(ctus_y, ty)
    tcol_of_ctu = np.searchsorted(cbx[1:], np.arange(ctus_x),
                                  side="right")
    trow_of_ctu = np.searchsorted(cby[1:], np.arange(ctus_y),
                                  side="right")
    tile_of = np.zeros((By, Bx), dtype=np.int64)
    rank_in_tile = np.zeros((By, Bx), dtype=np.int64)
    for by in range(By):
        for bx in range(Bx):
            cx, cy = bx // k, by // k
            tc, tr = tcol_of_ctu[cx], trow_of_ctu[cy]
            tile_of[by, bx] = tr * tx + tc
            tw = cbx[tc + 1] - cbx[tc]          # tile width in CTUs
            rank_in_tile[by, bx] = ((cy - cby[tr]) * tw
                                    + (cx - cbx[tc]))

    # Decode order: tile-major, CTU raster within tile, z within CTU.
    order = (tile_of * (ctus_x * ctus_y) + rank_in_tile) * (k * k) \
        + np.array([[z_order_index(bx % k, by % k)
                     for bx in range(Bx)] for by in range(By)],
                   dtype=np.int64)

    avail = np.zeros((By, Bx, 5), dtype=bool)
    for by in range(By):
        for bx in range(Bx):
            avail[by, bx] = _block_availability(bx, by, Bx, By, order,
                                               tile_of)

    # Wavefront step = longest dependency chain over available neighbors.
    step_of = np.zeros((By, Bx), dtype=np.int32)
    flat_order = np.argsort(order.ravel(), kind="stable")
    neigh = [(-1, 0), (0, -1), (1, -1), (-1, 1), (-1, -1)]
    for bid in flat_order:
        by, bx = divmod(int(bid), Bx)
        dep_steps = [-1]
        for i, (dx, dy) in enumerate(neigh):
            if avail[by, bx, i]:
                dep_steps.append(step_of[by + dy, bx + dx])
        step_of[by, bx] = max(dep_steps) + 1

    n_steps = int(step_of.max()) + 1
    counts = np.bincount(step_of.ravel(), minlength=n_steps)
    n_slots = int(counts.max())
    block_of_slot = np.full((n_steps, n_slots), -1, dtype=np.int64)
    slot_of = np.zeros((By, Bx), dtype=np.int32)
    fill = np.zeros(n_steps, dtype=np.int64)
    for bid in flat_order:
        by, bx = divmod(int(bid), Bx)
        st = step_of[by, bx]
        block_of_slot[st, fill[st]] = bid
        slot_of[by, bx] = fill[st]
        fill[st] += 1

    geo = (Bx, By, n_steps, n_slots, block_of_slot, avail)
    luma = _plane_maps(geo, s, width, height)
    chroma_maps = None
    if chroma:
        chroma_maps = _plane_maps(geo, s // 2, width // 2, height // 2)
    return IntraFramePlan(
        width=width, height=height, cu_size=s, blocks_x=Bx, blocks_y=By,
        n_steps=n_steps, n_slots=n_slots, step_of_block=step_of,
        slot_of_block=slot_of, block_of_slot=block_of_slot, avail=avail,
        luma=luma, chroma=chroma_maps, tiles=(tx, ty),
        tile_col_bounds=tuple(cbx), tile_row_bounds=tuple(cby))
