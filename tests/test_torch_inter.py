"""Port inter ops == JAX inter ops, exactly (tolerance 0).

The same seeded numpy inputs go through each kvazaar_tpu function (CPU
backend) and its kvazaar_tpu_torch counterpart (CPU tensors): the mv
bit estimate, motion compensation with MVs that reach outside the
frame, the SAD surfaces, the dense quarter-pel refinement, the whole
one-reference search (MVs and float32 costs), the P-frame boundary
strengths and deblocking with random boundary-strength maps.  The JAX
functions run jitted, as the JAX encoder runs them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvazaar_tpu.encoder import inter_search as jsearch
from kvazaar_tpu.encoder.frame_encoder import \
    compute_bs_maps as jax_compute_bs_maps
from kvazaar_tpu.ops import deblock as jdeblock
from kvazaar_tpu.ops import inter as jinter
from kvazaar_tpu_torch.encoder import inter_search as tsearch
from kvazaar_tpu_torch.encoder.frame_encoder import compute_bs_maps
from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
from kvazaar_tpu_torch.ops import deblock as tdeblock
from kvazaar_tpu_torch.ops import inter as tinter

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

# Small CPU shapes: one intra-op thread each, so that the xdist
# workers sharing the cores do not oversubscribe them.
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=msg)


def _moving_pair(rng, w, h):
    """A smooth textured plane and a copy shifted by a few pixels with
    a little noise: a reference/current pair with real motion."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = (128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
            + rng.normal(0, 8, (h, w)))
    ref = np.clip(base, 0, 255).astype(np.int32)
    cur = np.roll(ref, (2, -3), (0, 1)) + rng.integers(-3, 4, (h, w))
    return np.clip(cur, 0, 255).astype(np.int32), ref


def test_mv_bits_est_matches_jax():
    v = np.arange(-(1 << 15), (1 << 15) + 1, dtype=np.int32)
    _eq(tsearch._mv_bits_est(_t(v)), jsearch._mv_bits_est(jnp.asarray(v)))


@pytest.mark.parametrize("cu", [8, 16])
def test_mc_planes_out_of_frame_match_jax(cu):
    """MVs up to me_range + 3/4 px outside the frame: the port's
    per-block MC equals JAX's phase-plane MC."""
    rng = np.random.default_rng(cu)
    w, h, r = 64, 48, 16
    plan = make_intra_plan(w, h, cu, chroma=True)
    ref_y = rng.integers(0, 256, (h, w)).astype(np.int32)
    ref_cb = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    ref_cr = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    lim = 4 * r + 3
    mv = rng.integers(-lim, lim + 1,
                      (plan.blocks_y, plan.blocks_x, 2)).astype(np.int32)
    mv[0, 0] = (-lim, -lim)
    mv[-1, -1] = (lim, lim)
    got = tsearch.mc_planes(_t(ref_y), _t(ref_cb), _t(ref_cr), _t(mv),
                            plan)
    want = jax.jit(lambda *a: jsearch.mc_planes(*a, plan))(
        ref_y, ref_cb, ref_cr, mv)
    for g, w_, n in zip(got, want, ("y", "cb", "cr")):
        _eq(g, w_, n)


@pytest.mark.parametrize("cu,r", [(8, 4), (16, 16)])
def test_sad_surfaces_match_jax(cu, r):
    rng = np.random.default_rng(r)
    cur, ref = _moving_pair(rng, 64, 48)
    _eq(tinter.sad_surfaces(_t(cur), _t(ref), r, cu),
        jax.jit(lambda c, f: jinter.sad_surfaces(c, f, r, cu))(cur, ref))


@pytest.mark.parametrize("size", [8, 16])
def test_refine_qpel_dense_matches_jax(size):
    rng = np.random.default_rng(size)
    cur, ref = _moving_pair(rng, 64, 48)
    n = 9
    x0s = rng.integers(-8, 64, n).astype(np.int32)
    y0s = rng.integers(-8, 48, n).astype(np.int32)
    mv_int = rng.integers(-5, 6, (n, 2)).astype(np.int32) * 4
    blocks = rng.integers(0, 256, (n, size, size)).astype(np.int32)
    got = tinter.refine_qpel_dense(_t(blocks), _t(ref), _t(x0s), _t(y0s),
                                   _t(mv_int), size)
    want = jax.jit(lambda *a: jinter.refine_qpel_dense(*a, size))(
        blocks, ref, x0s, y0s, mv_int)
    _eq(got, want)
    np.testing.assert_array_equal(tinter.QPEL_OFFSETS, jinter.QPEL_OFFSETS)


@pytest.mark.parametrize("cu,subpel", [(8, True), (16, True), (16, False)])
def test_search_inter_frame_matches_jax(cu, subpel):
    """MVs and the float32 winner costs are equal, bit for bit."""
    rng = np.random.default_rng(cu + subpel)
    cur, ref = _moving_pair(rng, 64, 48)
    plan = make_intra_plan(64, 48, cu, chroma=False)
    lam = 4.2426406871192848
    mv, cost = tsearch.search_inter_frame(_t(cur), _t(ref), plan, lam, 8,
                                          subpel=subpel)
    jmv, jcost = jax.jit(lambda c, f: jsearch.search_inter_frame(
        c, f, plan, lam, 8, subpel=subpel))(cur, ref)
    _eq(mv, jmv, "mv")
    assert cost.dtype == torch.float32
    _eq(cost, jcost, "cost")
    assert np.abs(mv.numpy()).max() > 0


def test_compute_bs_maps_match_jax():
    rng = np.random.default_rng(5)
    by, bx = 6, 8
    inter = rng.random((by, bx)) < 0.7
    cbf = rng.random((by, bx)) < 0.4
    mv = rng.integers(-9, 10, (by, bx, 2)).astype(np.int32)
    mv[rng.random((by, bx)) < 0.5] = (4, -4)
    got = compute_bs_maps(_t(inter), _t(cbf), _t(mv))
    want = jax_compute_bs_maps(jnp.asarray(inter), jnp.asarray(cbf),
                               jnp.asarray(mv))
    for g, w_ in zip(got, want):
        _eq(g, w_)
    assert {0, 1, 2} <= set(np.unique(got[0].numpy()))


@pytest.mark.parametrize("cu,qp", [(8, 30), (16, 22), (16, 37)])
def test_deblock_random_bs_matches_jax(cu, qp):
    rng = np.random.default_rng(cu * qp)
    w, h = 64, 48

    def blocky(hh, ww, blk):
        # Flat blocks a few levels apart plus a little noise: most edges
        # pass the beta decisions, so bS decides what is filtered.
        lv = rng.integers(100, 112, (hh // blk, ww // blk))
        return (np.kron(lv, np.ones((blk, blk), np.int64))
                + rng.integers(0, 2, (hh, ww))).astype(np.int32)

    y = blocky(h, w, cu)
    cb = blocky(h // 2, w // 2, cu // 2)
    cr = blocky(h // 2, w // 2, cu // 2)
    shape = (h // cu, w // cu)
    bs_v = rng.integers(0, 3, shape).astype(np.int32)
    bs_h = rng.integers(0, 3, shape).astype(np.int32)
    got = tdeblock.deblock_frame(_t(y), _t(cb), _t(cr), qp, cu,
                                 bs_v=_t(bs_v), bs_h=_t(bs_h))
    want = jax.jit(lambda *a: jdeblock.deblock_frame(
        *a[:3], qp, cu, bs_v=a[3], bs_h=a[4]))(y, cb, cr, bs_v, bs_h)
    for g, w_, n, src in zip(got, want, ("y", "cb", "cr"), (y, cb, cr)):
        _eq(g, w_, n)
        assert not np.array_equal(g.numpy(), src), n
