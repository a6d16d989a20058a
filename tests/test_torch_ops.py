"""Port ops == JAX ops, exactly (tolerance 0: HEVC is an integer codec).

The same seeded numpy inputs go through each kvazaar_tpu op (CPU
backend) and its kvazaar_tpu_torch counterpart (CPU tensors), and the
port is also held against the scalar spec models the JAX package's own
tests use (test_oracle_independence.py, test_spec_models.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvazaar_tpu.encoder.geometry import make_intra_plan
from kvazaar_tpu.encoder import intra_search as jsearch
from kvazaar_tpu.ops import deblock as jdeblock
from kvazaar_tpu.ops import intra as jintra
from kvazaar_tpu.ops import quant as jquant
from kvazaar_tpu.ops import transform as jtransform
from kvazaar_tpu_torch.encoder import intra_search as tsearch
from kvazaar_tpu_torch.ops import deblock as tdeblock
from kvazaar_tpu_torch.ops import intra as tintra
from kvazaar_tpu_torch.ops import quant as tquant
from kvazaar_tpu_torch.ops import transform as ttransform
from kvazaar_tpu_torch.ops.exactmm import einsum_exact
from test_oracle_independence import (spec_intra_predict,
                                      spec_inverse_transform)
from test_spec_models import np_deblock_luma_vertical, np_dequant

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=msg)


def test_einsum_exact_is_exact_beyond_float32():
    """The forward DCT's second stage exceeds 2^24, where float32 is
    no longer exact; the helper must still equal int64 arithmetic."""
    rng = np.random.default_rng(0)
    t = rng.integers(-90, 91, (32, 32))
    x = rng.integers(-32768, 32768, (3, 32, 32))
    got = einsum_exact("lm,bkm->bkl", _t(t), _t(x))
    want = np.einsum("lm,bkm->bkl", t, x)
    assert np.abs(want).max() > 2 ** 24
    _eq(got, want)


@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_transforms_match_jax(size):
    rng = np.random.default_rng(size)
    resid = rng.integers(-255, 256, (3, size, size)).astype(np.int32)
    fwd = ttransform.forward_transform(_t(resid), size)
    _eq(fwd, jtransform.forward_transform(jnp.asarray(resid), size))
    coeff = rng.integers(-32768, 32768, (3, size, size)).astype(np.int32)
    coeff[0] //= 64
    inv = ttransform.inverse_transform(_t(coeff), size)
    _eq(inv, jtransform.inverse_transform(jnp.asarray(coeff), size))
    for b in range(coeff.shape[0]):
        np.testing.assert_array_equal(
            inv[b].numpy(), spec_inverse_transform(coeff[b], size))


@pytest.mark.parametrize("qp", [0, 22, 37, 51])
def test_quant_dequant_match_jax(qp):
    rng = np.random.default_rng(qp)
    for size in (4, 8, 16, 32):
        coeff = rng.integers(-32768, 32768, (2, size, size)).astype(
            np.int32)
        lv = tquant.quantize(_t(coeff), qp, size)
        _eq(lv, jquant.quantize(jnp.asarray(coeff), qp, size), size)
        levels = (lv.numpy() // 3).astype(np.int32)
        dq = tquant.dequantize(_t(levels), qp, size)
        _eq(dq, jquant.dequantize(jnp.asarray(levels), qp, size), size)
        _eq(dq[0], np_dequant(levels[0], qp, size), size)


@pytest.mark.parametrize("n,luma", [(8, True), (16, True), (4, False),
                                    (8, False)])
def test_intra_prediction_matches_jax(n, luma):
    rng = np.random.default_rng(n + 100 * luma)
    refs = rng.integers(0, 256, (3, 4 * n + 1)).astype(np.int32)
    allm = tintra.predict_all_modes(_t(refs), n, luma=luma)
    _eq(allm, jax.jit(functools.partial(
        jintra.predict_all_modes, n=n, luma=luma))(jnp.asarray(refs)))
    modes = np.tile(np.arange(35, dtype=np.int32), 3)
    refs3 = np.repeat(refs, 35, axis=0)
    one = tintra.predict_modes(_t(refs3), _t(modes), n, luma=luma)
    _eq(one, jax.jit(functools.partial(
        jintra.predict_modes, n=n, luma=luma))(jnp.asarray(refs3),
                                              jnp.asarray(modes)))
    for i in range(0, refs3.shape[0], 11):
        np.testing.assert_array_equal(
            one[i].numpy(),
            spec_intra_predict(refs3[i], int(modes[i]), n, luma=luma))


def test_mode_search_matches_jax():
    """satd8_batch, mode_bits_table and search_frame_modes (rd 0 and 1)
    on a 64x48 frame."""
    rng = np.random.default_rng(5)
    diff = rng.integers(-255, 256, (4, 3, 16, 16)).astype(np.int32)
    _eq(tsearch.satd8_batch(_t(diff)),
        jsearch.satd8_batch(jnp.asarray(diff)))
    _eq(tsearch.satd8_batch(_t(diff[..., :4, :4].copy())),
        jsearch.satd8_batch(jnp.asarray(diff[..., :4, :4])))
    grid = rng.integers(0, 35, (6, 8)).astype(np.int32)
    _eq(tsearch.mode_bits_table(_t(grid), 8),
        jsearch.mode_bits_table(jnp.asarray(grid), 8))
    yy, xx = np.mgrid[0:48, 0:64]
    frame = np.clip(120 + 50 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
                    + rng.normal(0, 8, (48, 64)), 0, 255).astype(np.int32)
    for cu in (8, 16):
        plan = make_intra_plan(64, 48, cu, chroma=False)
        for two_pass in (False, True):
            got = tsearch.search_frame_modes(_t(frame), plan, 6.3, 8,
                                             two_pass)
            want = jax.jit(functools.partial(
                jsearch.search_frame_modes, plan=plan, lambda_satd=6.3,
                two_pass=two_pass))(jnp.asarray(frame))
            _eq(got[0], want[0], f"modes cu{cu} two_pass={two_pass}")
            _eq(got[1], want[1], f"costs cu{cu} two_pass={two_pass}")


@pytest.mark.parametrize("cu", [8, 16])
def test_deblock_frame_matches_jax(cu):
    rng = np.random.default_rng(cu)
    base = rng.integers(60, 196, (2, 1, 64)).astype(np.int32)
    y = np.clip(base + rng.integers(-6, 7, (2, 48, 64)), 0, 255).astype(
        np.int32)
    cb = rng.integers(90, 160, (2, 24, 32)).astype(np.int32)
    cr = rng.integers(90, 160, (2, 24, 32)).astype(np.int32)
    for qp in (22, 37):
        got = tdeblock.deblock_frame(_t(y), _t(cb), _t(cr), qp, cu)
        want = jax.jit(functools.partial(jdeblock.deblock_frame, qp=qp,
                                         cu_size=cu))(
            jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr))
        for g, w, n in zip(got, want, ("y", "cb", "cr")):
            _eq(g, w, f"{n} qp{qp}")


@pytest.mark.parametrize("qp,seed", [(27, 0), (37, 1)])
def test_deblock_edge_matches_spec_model(qp, seed):
    """One vertical luma edge at x = 8 of an 8x16 plane (a 16-wide
    transpose has no horizontal edge inside it)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(60, 196, (1, 16)).astype(np.int64)
    plane = (base + rng.integers(-6, 7, (8, 16))).clip(0, 255)
    got = tdeblock.deblock_plane(_t(plane.astype(np.int32)), qp, 8)
    np.testing.assert_array_equal(got.numpy(),
                                  np_deblock_luma_vertical(plane, qp))
