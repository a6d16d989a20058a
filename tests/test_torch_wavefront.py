"""Port reconstruct_frames (plain per-step path) == JAX reconstruct_frames.

On the JAX side both the lax.scan path (``wfp.DISABLE``) and the
interpreted Pallas kernel (``wfp.INTERPRET``) run, exactly as
tests/test_wavefront_pallas.py drives them, on the same cases: cu 8/16,
QP 22/32/37, with and without chroma, B=2, intra frames and P frames
(random inter maps and MC planes: the kernel's inter variant); at cu 32
(luma S=32, chroma S=16), which the Pallas kernel does not take and the
JAX package reconstructs with its lax.scan, the scan alone.  Levels
and reconstruction must be equal (tolerance 0).  The CUDA kernel itself
is compared with the same plain path on the card by chip_smoke.py; here
its host-side tables are checked: the edge ring depth against a
brute-force replay of the schedule, the packed schedule, the plane
sizes the wrapper takes, and the transform matrix in its source.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvazaar_tpu.ops.wavefront_pallas as wfp
from kvazaar_tpu.encoder.geometry import make_intra_plan
from kvazaar_tpu.encoder.intra_recon import \
    reconstruct_frames as jax_reconstruct_frames
from kvazaar_tpu_torch.encoder.frame_encoder import chroma_qp
from kvazaar_tpu_torch.encoder.intra_recon import (reconstruct_frames,
                                                   wavefront_recon_plain)
from kvazaar_tpu_torch.ops import wavefront
from kvazaar_tpu_torch.ops.transform import dct_matrix_np
from test_torch_slice import _jit_whole

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

# Small CPU shapes: one intra-op thread each, so that the xdist
# workers sharing the cores do not oversubscribe them.
torch.set_num_threads(1)

NAMES = ("rec_y", "lv_y", "rec_cb", "lv_cb", "rec_cr", "lv_cr")


def _sources(rng, b, w, h, chroma=True):
    ys = rng.integers(0, 256, (b, h, w)).astype(np.int32)
    cbs = crs = None
    if chroma:
        cbs = rng.integers(0, 256, (b, h // 2, w // 2)).astype(np.int32)
        crs = rng.integers(0, 256, (b, h // 2, w // 2)).astype(np.int32)
    return ys, cbs, crs


# JAX reconstruct_frames jitted whole, one wrapper per backend gate
# (the gate is read while tracing): one compile per case instead of one
# per primitive call.
_JAX_KERNEL = _jit_whole(jax_reconstruct_frames)
_JAX_SCAN = _jit_whole(jax_reconstruct_frames)


def _jax_both(plan, ys, cbs, crs, modes, qp, inter=None):
    """(interpreted Pallas kernel, lax.scan) outputs of the JAX
    package; at cu 32, which the Pallas kernel does not take, the
    lax.scan output alone.  inter: None, or (is_inter, mc_y, mc_cb,
    mc_cr)."""
    def j(a):
        return None if a is None else jnp.asarray(a)

    args = (j(ys), j(cbs), j(crs), j(modes), plan, qp, chroma_qp(qp), 8)
    kw = {}
    if inter is not None:
        kw = dict(zip(("is_inter", "mc_y", "mc_cb", "mc_cr"),
                      (j(a) for a in inter)))
    wfp.DISABLE = True
    try:
        scan = _JAX_SCAN(*args, **kw)
    finally:
        wfp.DISABLE = False
    if plan.cu_size == 32:
        return (scan,)
    wfp.INTERPRET = True
    try:
        kernel = _JAX_KERNEL(*args, **kw)
    finally:
        wfp.INTERPRET = False
    return kernel, scan


def _check(plan, ys, cbs, crs, modes, qp, inter=None):
    def t(a):
        return None if a is None else torch.from_numpy(a)

    kw = {}
    if inter is not None:
        kw = dict(zip(("is_inter", "mc_y", "mc_cb", "mc_cr"),
                      (t(a) for a in inter)))
    got = reconstruct_frames(t(ys), t(cbs), t(crs), t(modes), plan, qp,
                             chroma_qp(qp), **kw)
    outs = _jax_both(plan, ys, cbs, crs, modes, qp, inter)
    for want, path in zip(outs[::-1], ("scan", "pallas-interpret")):
        for g, w, n in zip(got, want, NAMES):
            assert (g is None) == (w is None), n
            if g is not None:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=f"{n} vs {path}")


@pytest.mark.parametrize("cu,w,h,qp", [
    (8, 32, 24, 32),
    (16, 64, 32, 22),
    (16, 48, 48, 37),
    (32, 64, 64, 27),
])
def test_recon_matches_jax(cu, w, h, qp):
    rng = np.random.default_rng(cu * 100 + qp)
    plan = make_intra_plan(w, h, cu, chroma=True)
    ys, cbs, crs = _sources(rng, 2, w, h)
    modes = rng.integers(0, 35, (2, plan.blocks_y,
                                 plan.blocks_x)).astype(np.int32)
    _check(plan, ys, cbs, crs, modes, qp)


@pytest.mark.parametrize("cu,w,h,qp", [
    (8, 24, 16, 30),
    (16, 48, 32, 22),
    (32, 64, 64, 30),
])
def test_inter_recon_matches_jax(cu, w, h, qp):
    """P frames: inter blocks (p = 0.5) take the MC prediction and the
    inter rounding and feed their intra neighbours' references."""
    rng = np.random.default_rng(cu * 1000 + qp)
    plan = make_intra_plan(w, h, cu, chroma=True)
    ys, cbs, crs = _sources(rng, 2, w, h)
    shape = (2, plan.blocks_y, plan.blocks_x)
    modes = rng.integers(0, 35, shape).astype(np.int32)
    is_inter = rng.random(shape) < 0.5
    # MC planes near the source, so that inter residuals stay small and
    # both rounding offsets matter.
    mc_y, mc_cb, mc_cr = (np.clip(p + rng.integers(-6, 7, p.shape), 0, 255)
                          .astype(np.int32) for p in (ys, cbs, crs))
    _check(plan, ys, cbs, crs, modes, qp, (is_inter, mc_y, mc_cb, mc_cr))


def test_recon_luma_only_matches_jax():
    rng = np.random.default_rng(7)
    plan = make_intra_plan(32, 32, 16, chroma=False)
    ys, _, _ = _sources(rng, 2, 32, 32, chroma=False)
    modes = rng.integers(0, 35, (2, plan.blocks_y,
                                 plan.blocks_x)).astype(np.int32)
    _check(plan, ys, None, None, modes, 27)


def test_schedule_matches_pallas_schedule():
    """The kernel's (block id, availability flags) table is a copy of
    the Pallas kernel's scalar-prefetched schedule."""
    for cu in (8, 16):
        plan = make_intra_plan(96, 64, cu, chroma=True)
        np.testing.assert_array_equal(wavefront.schedule_np(plan).reshape(-1),
                                      wfp._schedule_np(plan))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    plan = make_intra_plan(32, 32, 16, chroma=True)
    modes = torch.zeros((1, 2, 2), dtype=torch.int32)
    orig = torch.zeros((1, 32, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="bit depth 12"):
        wavefront._check(orig, modes, plan, 16, True, 12)
    with pytest.raises(ValueError, match="int16 at 10-bit"):
        wavefront._check(orig, modes, plan, 16, True, 10)
    with pytest.raises(ValueError, match="block size"):
        wavefront._check(orig, modes, plan, 8, True, 8)
    with pytest.raises(ValueError, match="does not match"):
        wavefront._check(orig[:, :16], modes, plan, 16, True, 8)
    with pytest.raises(ValueError, match="int32"):
        wavefront._check(orig, modes.to(torch.int64), plan, 16, True, 8)
    with pytest.raises(ValueError, match="unsupported device"):
        wavefront.wavefront_recon(orig.to("meta"), modes, plan, 16, True,
                                  22)


@pytest.mark.parametrize("inter", [False, True])
def test_planes_entry_matches_plain_per_kind(inter):
    """wavefront_recon_planes on CPU tensors == wavefront_recon_plain run
    on each plane alone (Cb and Cr apart, sharing the luma modes)."""
    rng = np.random.default_rng(11 + inter)
    plan = make_intra_plan(32, 32, 8, chroma=True)
    ys, cbs, crs = (torch.from_numpy(a) for a in _sources(rng, 2, 32, 32))
    shape = (2, plan.blocks_y, plan.blocks_x)
    modes = torch.from_numpy(rng.integers(0, 35, shape).astype(np.int32))
    kinds = [(ys, 8, True, 27), (cbs, 4, False, chroma_qp(27)),
             (crs, 4, False, chroma_qp(27))]
    is_inter = mcs = None
    if inter:
        is_inter = torch.from_numpy(rng.random(shape) < 0.5)
        mcs = [torch.from_numpy(rng.integers(0, 256, tuple(p.shape))
                                .astype(np.uint8)) for p, *_ in kinds]
    got = wavefront.wavefront_recon_planes(
        ys, cbs, crs, modes, plan, 27, chroma_qp(27), 8, is_inter,
        *(mcs or (None,) * 3))
    for i, (orig, s, luma, qp) in enumerate(kinds):
        want = wavefront_recon_plain(orig, modes, plan, s, luma, qp, 8,
                                     is_inter, mcs and mcs[i])
        for g, w in zip(got[2 * i:2 * i + 2], want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


def _ring_holds(plan, k):
    """Replay the schedule on a ring of k block rows: every reference
    read must find its neighbour's edges, written in an earlier step and
    not written over in the reader's step."""
    owner = {}
    for step in plan.block_of_slot:
        blocks = [divmod(int(b), plan.blocks_x) for b in step if b >= 0]
        writes = {}
        for by, bx in blocks:
            writes.setdefault((by % k, bx), []).append((by, bx))
        for by, bx in blocks:
            for i, (dx, dy) in enumerate(((-1, 0), (0, -1), (1, -1),
                                          (-1, 1), (-1, -1))):
                if not plan.avail[by, bx, i]:
                    continue
                loc = ((by + dy) % k, bx + dx)
                if owner.get(loc) != (by + dy, bx + dx) or loc in writes:
                    return False
        for loc, ws in writes.items():
            owner[loc] = ws[0] if len(ws) == 1 else None
    return True


@pytest.mark.parametrize("w,h,cu,tiles", [
    (832, 480, 16, (1, 1)),
    (832, 480, 8, (1, 1)),
    (832, 480, 16, (2, 2)),
    (256, 192, 8, (3, 2)),
    (96, 64, 8, (1, 1)),
])
def test_ring_depth_matches_brute_force(w, h, cu, tiles):
    plan = make_intra_plan(w, h, cu, chroma=False, tiles=tiles)
    k = wavefront.ring_depth(plan)
    assert _ring_holds(plan, k)
    assert k == 1 or not _ring_holds(plan, k - 1)
    if tiles == (1, 1) and w == 832:
        assert k == 3


def test_step_tables_follow_the_schedule():
    """blk_info / step_start list exactly the schedule's blocks, tile by
    tile and in step order within a tile, with their availability in the
    scan order below-left, left, above-left, above, above-right (the
    schedule's flag bits L=1, A=2, AR=4, BL=8, AL=16); tile_info names
    each tile's blocks, and step_start holds a row of steps per tile."""
    plan = make_intra_plan(96, 64, 8, chroma=True, tiles=(2, 1))
    sched = wavefront.schedule_np(plan)
    blk_info, step_start, tile_info = wavefront.step_tables(plan)
    bits = wavefront._POS_BITS
    pos, mask = blk_info & ((1 << bits) - 1), blk_info >> bits
    # Tile columns are whole CTUs: 64 and 32 samples.
    np.testing.assert_array_equal(tile_info, [[0, 0, 8, 8], [8, 0, 4, 8]])
    assert step_start.shape == (2, plan.n_steps + 1)
    seen = 0
    for (bx0, by0, bw, bh), starts in zip(tile_info, step_start):
        yy, xx = np.mgrid[by0:by0 + bh, bx0:bx0 + bw]
        mine = set((yy * plan.blocks_x + xx).ravel().tolist())
        n_steps = plan.step_of_block[yy, xx].max() + 1
        # Past its last step a tile runs empty steps.
        assert (starts[n_steps:] == starts[-1]).all()
        for st in range(n_steps):
            real = sched[st][np.isin(sched[st, :, 0], list(mine))]
            np.testing.assert_array_equal(
                np.sort(pos[real[:, 0]]),
                np.arange(starts[st], starts[st + 1]))
            scan = sum(((real[:, 1] >> b) & 1) << r
                       for r, b in enumerate((3, 0, 4, 1, 2)))
            np.testing.assert_array_equal(mask[real[:, 0]], scan)
            seen += len(real)
    # Positions count from 0 in each tile.
    assert seen == step_start[:, -1].sum() == len(blk_info) == \
        plan.blocks_x * plan.blocks_y


@pytest.mark.parametrize("cu", [16, 8])
def test_large_planes_are_taken(cu):
    """The kernel keeps K block rows of edges in shared memory, so its
    shared memory grows with a plane's width and height, not its area:
    at 1920x1088 the ring stays 3 rows deep.  The wrapper takes 3840x2160
    (129600 blocks at cu 8) and refuses only planes whose block ids the
    packed schedule words cannot hold.  The layout's bytes themselves are
    the library's, checked on the card by chip_smoke.py up to 3840x2160."""
    plan = make_intra_plan(1920, 1088, cu, chroma=False)
    assert wavefront.ring_depth(plan) == 3
    uhd = SimpleNamespace(cu_size=cu, blocks_y=2160 // cu,
                          blocks_x=3840 // cu)
    orig = torch.zeros((1, 2160, 3840), dtype=torch.uint8)
    modes = torch.zeros((1, uhd.blocks_y, uhd.blocks_x), dtype=torch.int32)
    assert wavefront._check(orig, modes, uhd, cu, True, 8) == (1, 2160, 3840)
    huge = SimpleNamespace(cu_size=cu, blocks_y=1025, blocks_x=1024)
    with pytest.raises(ValueError, match="too large"):
        wavefront._check(orig, modes, huge, cu, True, 8)


def test_kernel_transform_matrix():
    """kT32 in csrc/wavefront.cu is the HEVC matrix; its subsampled rows
    are the 16-, 8- and 4-point matrices, with the even/odd symmetry the
    butterflies rely on."""
    src = (Path(wavefront.__file__).resolve().parent.parent / "csrc"
           / "wavefront.cu").read_text()
    body = re.search(r"kT32\[32\]\[32\] = \{(.*?)\};", src, re.S).group(1)
    t32 = np.array([int(v) for v in re.findall(r"-?\d+", body)]
                   ).reshape(32, 32)
    for s in (32, 16, 8, 4):
        t = t32[::32 // s, :s]
        np.testing.assert_array_equal(t, dct_matrix_np(s))
        np.testing.assert_array_equal(t[0::2], t[0::2, ::-1])
        np.testing.assert_array_equal(t[1::2], -t[1::2, ::-1])
