"""Port reconstruct_frames (plain per-step path) == JAX reconstruct_frames.

On the JAX side both the lax.scan path (``wfp.DISABLE``) and the
interpreted Pallas kernel (``wfp.INTERPRET``) run, exactly as
tests/test_wavefront_pallas.py drives them, on the same cases: cu 8/16,
QP 22/32/37, with and without chroma, B=2, intra frames and P frames
(random inter maps and MC planes: the kernel's inter variant).  Levels
and reconstruction must be equal (tolerance 0).  The CUDA kernel itself
is compared with the same plain path on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvazaar_tpu.ops.wavefront_pallas as wfp
from kvazaar_tpu.encoder.geometry import make_intra_plan
from kvazaar_tpu.encoder.intra_recon import \
    reconstruct_frames as jax_reconstruct_frames
from kvazaar_tpu_torch.encoder.frame_encoder import chroma_qp
from kvazaar_tpu_torch.encoder.intra_recon import reconstruct_frames
from kvazaar_tpu_torch.ops import wavefront

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

NAMES = ("rec_y", "lv_y", "rec_cb", "lv_cb", "rec_cr", "lv_cr")


def _sources(rng, b, w, h, chroma=True):
    ys = rng.integers(0, 256, (b, h, w)).astype(np.int32)
    cbs = crs = None
    if chroma:
        cbs = rng.integers(0, 256, (b, h // 2, w // 2)).astype(np.int32)
        crs = rng.integers(0, 256, (b, h // 2, w // 2)).astype(np.int32)
    return ys, cbs, crs


def _jax_both(plan, ys, cbs, crs, modes, qp, inter=None):
    """(interpreted Pallas kernel, lax.scan) outputs of the JAX
    package.  inter: None, or (is_inter, mc_y, mc_cb, mc_cr)."""
    def j(a):
        return None if a is None else jnp.asarray(a)

    args = (j(ys), j(cbs), j(crs), j(modes), plan, qp, chroma_qp(qp), 8)
    kw = {}
    if inter is not None:
        kw = dict(zip(("is_inter", "mc_y", "mc_cb", "mc_cr"),
                      (j(a) for a in inter)))
    wfp.INTERPRET = True
    try:
        kernel = jax_reconstruct_frames(*args, **kw)
    finally:
        wfp.INTERPRET = False
    wfp.DISABLE = True
    try:
        scan = jax_reconstruct_frames(*args, **kw)
    finally:
        wfp.DISABLE = False
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
    for want, path in zip(_jax_both(plan, ys, cbs, crs, modes, qp, inter),
                          ("pallas-interpret", "scan")):
        for g, w, n in zip(got, want, NAMES):
            assert (g is None) == (w is None), n
            if g is not None:
                np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                              err_msg=f"{n} vs {path}")


@pytest.mark.parametrize("cu,w,h,qp", [
    (8, 32, 24, 32),
    (16, 64, 32, 22),
    (16, 48, 48, 37),
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
    with pytest.raises(ValueError, match="8-bit"):
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
