"""The pipelined path's SSEs == the JAX package's float32 sums.

The JAX package's pipelined frame programs take each plane's SSE as a
float32 ``jnp.sum(d * d)`` over the conformance window; above 2^24 the
float depends on the order of the additions.  ``ops/sse.py`` sums in
XLA's CPU order: window sums of 32 x 32, one level per dimension above
32, then the final grid, row by row or in vector lanes where LLVM
vectorizes the loop.  Held here, with tolerance 0:

- the final grid's order (``reduce_grid``) against a jitted ``jnp.sum``
  of random float32 grids whose sums round, at the grid shapes where
  the lanes change;
- whole planes of uniform noise (8- and 10-bit, so that some 32 x 32
  windows pass 2^24 too) against the JAX package's two forms, the batch
  ``jnp.sum(d * d, axis=(1, 2))`` of its I batches and the 2-D sum of
  its P frames, at the frame shapes of the tests and the card's cells;
- ``Encoder.encode_stream``'s FrameInfo against the JAX package's,
  field by field, on 128x128 noise at QP 51, whose SSEs pass 2^24:
  all-intra batches, IPPP, and 10-bit all-intra.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvazaar_tpu.api as japi
from kvazaar_tpu.config import Config as JaxConfig
from kvazaar_tpu_torch import Config
from kvazaar_tpu_torch.api import Encoder
from kvazaar_tpu_torch.ops.sse import FrameSse, PlaneSse, reduce_grid

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

# Small CPU shapes: one intra-op thread each, so that the xdist
# workers sharing the cores do not oversubscribe them.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_batch_sum(hh, ww):
    def f(a, b):
        d = (a[:, :hh, :ww].astype(jnp.float32)
             - b[:, :hh, :ww].astype(jnp.float32))
        return jnp.sum(d * d, axis=(1, 2))
    return jax.jit(f)


@functools.lru_cache(maxsize=None)
def _jax_frame_sum(hh, ww):
    def f(a, b):
        d = (a[:hh, :ww].astype(jnp.float32)
             - b[:hh, :ww].astype(jnp.float32))
        return jnp.sum(d * d)
    return jax.jit(f)


@pytest.mark.parametrize("r", [2, 3, 4, 8, 15, 16, 17, 20, 24, 28, 32])
def test_final_grid_order_matches_xla(r):
    """Grids of r rows and 1..10 columns: row-major sums and the vector
    lanes LLVM picks, on values near 2^24 so that every order rounds
    differently."""
    rng = np.random.default_rng(r)
    for c in (1, 2, 3, 6, 7, 8, 9, 10):
        x = (rng.uniform(1, 2, (3, r, c))
             * 2.0 ** rng.integers(22, 26, (3, r, c))).astype(np.float32)
        want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=(1, 2)))(x))
        np.testing.assert_array_equal(reduce_grid(x), want,
                                      err_msg=f"{r}x{c}")


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("coded,window", [
    ((64, 64), (64, 64)), ((128, 128), (128, 128)), ((48, 80), (40, 72)),
    ((240, 416), (240, 416)), ((480, 832), (480, 832)),
    ((1088, 1920), (1080, 1920))], ids=str)
def test_plane_sse_matches_jax(coded, window, bd):
    """Uniform noise planes against their noise 'reconstruction': the
    batch and the 2-D forms of the JAX package's SSE."""
    rng = np.random.default_rng(bd + coded[0])
    hi = 1 << bd
    dt = np.uint8 if bd == 8 else np.int16
    a, b = (rng.integers(0, hi, (2, *coded)).astype(dt) for _ in range(2))
    hh, ww = window
    got = PlaneSse(torch.from_numpy(a), torch.from_numpy(b), hh, ww).host()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(
        _jax_batch_sum(hh, ww)(a, b)))
    np.testing.assert_array_equal(got[0], np.asarray(
        _jax_frame_sum(hh, ww)(a[0], b[0])))
    if bd == 10:
        sq = (a[:, :hh, :ww].astype(np.int64) - b[:, :hh, :ww]) ** 2
        assert sq[:, :32, :32].sum() > 1 << 24      # a window rounds
    planes = FrameSse([PlaneSse(torch.from_numpy(a), torch.from_numpy(b),
                                hh, ww), None, None]).host()
    np.testing.assert_array_equal(planes[:, 0], got)
    assert not planes[:, 1:].any()


def _noise(n, w, h, seed, bd=8):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if bd == 8 else np.uint16
    return [tuple(rng.integers(0, 1 << bd, s).astype(dt)
                  for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
            for _ in range(n)]


@pytest.mark.parametrize("kind", ["all-intra", "ippp", "10bit"])
def test_pipelined_frame_info_matches_jax_above_2_24(kind):
    """encode_stream's FrameInfo (PSNR from the device SSEs) equals the
    JAX package's field by field on 128x128 noise at QP 51, where every
    luma SSE passes 2^24; the bytes are equal too."""
    w = h = 128
    kw = dict(width=w, height=h, qp=51, intra_min_cu=16, intra_max_cu=16,
              intra_period=0 if kind == "ippp" else 1)
    bd = 10 if kind == "10bit" else 8
    if bd == 10:
        kw["input_bitdepth"] = 10
    frames = _noise(3, w, h, seed=41, bd=bd)
    enc = Encoder(Config(**kw), device="cpu")
    assert enc.can_pipeline()
    got = list(enc.encode_stream(frames, need_recon=True))
    want = list(japi.Encoder(JaxConfig(**kw)).encode_stream(
        frames, need_recon=True))
    assert len(got) == len(want) == len(frames)
    for (gc, gi, gr), (wc, wi, _wr), f in zip(got, want, frames):
        assert gc == wc
        assert dataclasses.astuple(gi) == dataclasses.astuple(wi), (gi, wi)
        sse = ((gr[0].astype(np.int64) - f[0]) ** 2).sum()
        assert sse > 1 << 24
