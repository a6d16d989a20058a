"""The port's SAO == the JAX package's, exactly (tolerance 0).

kvazaar_tpu_torch.ops.sao (CPU tensors) against kvazaar_tpu.ops.sao on
its CPU backend, jitted:

- ``sao_stats`` on planes with partial CTUs (200x136 luma at CTU 64,
  100x68 chroma at CTU 32);
- ``sao_decide_frame_device`` and ``apply_sao_plane`` against the JAX
  encoder's own fused device program (``_sao_device_fn``: statistics,
  decision and filter in one program, as the encoders run it) on a
  96x96 frame whose CTUs are partial in both axes, at two lambdas and
  over a sweep of lambdas (the decision's float32 costs are fused
  multiply-adds in that program);
- a 2-frame superfast all-intra stream (fixed 16x16 grid, rd 0, SAO,
  WPP) at 96x96: bytes, reconstruction and pre-SAO SSEs equal to the
  JAX encoder's, and the JAX oracle decoder turning the stream back
  into exactly the port's post-SAO reconstruction;
- every preset's all-intra operating point passes the port's gates, and
  what stays unported (field sources, selective encryption, also at
  cu 4)
  still raises.

The JAX SAO program takes about a minute to compile on the CPU (most of
it XLA compiling one unrolled program), so it is built once per process
(``jax_sao_program``) and shared by every JAX encoder of the port's SAO
tests, test_torch_quadtree.py's included: all of them run it on one
shape, a single 96x96 frame.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvazaar_tpu.config import Config as JaxConfig
from kvazaar_tpu.config import config_from_preset as jax_preset
from kvazaar_tpu.encoder import frame_encoder as jfe
from kvazaar_tpu.ops import sao as jsao
from kvazaar_tpu_torch.api import Encoder
from kvazaar_tpu_torch.config import PRESETS, config_from_preset
from kvazaar_tpu_torch.encoder.frame_encoder import (IntraFrameEncoder,
                                                     unsupported)
from kvazaar_tpu_torch.ops import sao as tsao
from test_torch_slice import _clip, oracle_decode

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

# Small CPU shapes: one intra-op thread each, so that the xdist
# workers sharing the cores do not oversubscribe them.
torch.set_num_threads(1)

# The one frame shape of every JAX SAO program run here.
W, H = 96, 96


@functools.lru_cache(maxsize=None)
def jax_sao_program():
    """The JAX package's fused device SAO program for 8-bit frames,
    compiled once (it depends on the bit depth only).  The source planes
    go in as int32 whatever their type: the program's first step widens
    them to int32, and one input type keeps it to one compile (the JAX
    fixed grid passes uint8 sources, its variable trees int32)."""
    enc = jfe.IntraFrameEncoder(JaxConfig(width=W, height=H, intra_period=1,
                                          intra_min_cu=16, intra_max_cu=16))
    prog = enc._sao_device_fn()

    def run(ys, recs_y, cbs, recs_cb, crs, recs_cr, lam):
        return prog(jnp.asarray(ys, jnp.int32), recs_y,
                    jnp.asarray(cbs, jnp.int32), recs_cb,
                    jnp.asarray(crs, jnp.int32), recs_cr, lam)
    return run


def share_sao_program(jax_enc):
    """Make a JAX encoder run the shared, compiled SAO program."""
    assert jax_enc.bitdepth == 8
    jax_enc._sao_dev_jit = jax_sao_program()
    return jax_enc


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def _planes(w, h, seed):
    """(source, reconstruction) uint8 planes with errors SAO can fix: on
    the left a bias of the samples in bands 12..15 (band offsets), on
    the right dips at strong horizontal gradients (edge offsets)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    src = np.clip(112 + 50 * np.sin(xx / 9.0) * np.cos(yy / 6.0)
                  + rng.normal(0, 6, (h, w)), 0, 255)
    in_bands = (src >= 96) & (src < 128)
    edges = np.abs(np.diff(src, axis=1, prepend=0)) > 12
    err = np.where(xx < w // 2, 4 * in_bands, -4 * edges)
    rec = np.clip(src + err + rng.integers(-1, 2, (h, w)), 0, 255)
    return src.astype(np.uint8), rec.astype(np.uint8)


@pytest.mark.parametrize("ctu", [64, 32])
def test_sao_stats_matches_jax(ctu):
    w, h = (200, 136) if ctu == 64 else (100, 68)
    src, rec = _planes(w, h, ctu)
    want = jax.jit(lambda o, r: jsao.sao_stats(o, r, ctu, 8))(
        src.astype(np.int32), rec.astype(np.int32))
    got = tsao.sao_stats(_t(src), _t(rec), ctu, 8)
    for g, wv, name in zip(got, want, ("e_cnt", "e_sum", "b_cnt", "b_sum")):
        assert g.dtype == torch.int32 and g.shape == wv.shape, name
        _eq(g, wv, name)


def _frame_planes():
    y = _planes(W, H, 1)
    cb = _planes(W // 2, H // 2, 2)
    cr = _planes(W // 2, H // 2, 3)
    return y, cb, cr


def _port_sao(planes, lam):
    """The port's statistics -> decision -> filter on one frame's (source,
    reconstruction) planes, as the frame encoder's SAO stage runs them."""
    (ys, ry), (cbs, rcb), (crs, rcr) = [(_t(s), _t(r)) for s, r in planes]
    p = tsao.sao_decide_frame_device(
        tsao.sao_stats(ys, ry, 64),
        (tsao.sao_stats(cbs, rcb, 32), tsao.sao_stats(crs, rcr, 32)), lam)
    t, eo, bp, off = p["type"], p["eo"], p["bp"], p["off"]
    ay = tsao.apply_sao_plane(ry, t[..., 0], eo[..., 0], bp[..., 0],
                              off[..., 0, :], 64)
    acb = tsao.apply_sao_plane(rcb, t[..., 1], eo[..., 1], bp[..., 1],
                               off[..., 1, :], 32)
    acr = tsao.apply_sao_plane(rcr, t[..., 1], eo[..., 1], bp[..., 2],
                               off[..., 2, :], 32)
    return p, (ay, acb, acr)


def _jax_sao(planes, lam):
    args = []
    for src, rec in planes:
        args += [jnp.asarray(src[None]), jnp.asarray(rec[None])]
    ay, acb, acr, packed = jax_sao_program()(*args, jnp.float32(lam))
    return np.asarray(packed)[0], [np.asarray(a)[0] for a in (ay, acb, acr)]


def _check(planes, lam):
    p, recs = _port_sao(planes, lam)
    packed, want = _jax_sao(planes, lam)
    _eq(p["merge"], packed[..., 0], f"merge lam {lam}")
    _eq(p["type"], packed[..., 1:3], f"type lam {lam}")
    _eq(p["eo"], packed[..., 3:5], f"eo lam {lam}")
    _eq(p["bp"], packed[..., 5:8], f"bp lam {lam}")
    _eq(p["off"], packed[..., 8:20].reshape(2, 2, 3, 4), f"off lam {lam}")
    for g, wv, name in zip(recs, want, ("y", "cb", "cr")):
        assert g.dtype == torch.uint8
        _eq(g, wv, f"{name} lam {lam}")
    return p


@pytest.mark.parametrize("lam", [4.25, 61.5])
def test_sao_decide_and_apply_match_jax(lam):
    """Partial CTUs in both axes; both lambdas choose band and edge
    offsets, the larger one also merges."""
    p = _check(_frame_planes(), lam)
    assert p["merge"].dtype == torch.int32
    assert {1, 2} <= set(p["type"].unique().tolist())
    assert p["merge"].any() or lam < 10


def test_sao_decision_lambda_sweep_matches_jax():
    """Many lambdas through the same compiled program: the own-choice
    costs ``ddist + lam * bits`` and the merge costs decide at every
    lambda exactly as the JAX program does."""
    planes = _frame_planes()
    for lam in np.geomspace(0.5, 2000, 24).astype(np.float32):
        _check(planes, float(lam))


def _stats(planes):
    (ys, ry), (cbs, rcb), (crs, rcr) = [(_t(s), _t(r)) for s, r in planes]
    return (tsao.sao_stats(ys, ry, 64),
            (tsao.sao_stats(cbs, rcb, 32), tsao.sao_stats(crs, rcr, 32)))


def _decision(stats, lam):
    p = tsao.sao_decide_frame_device(*stats, float(lam))
    return torch.cat([v.reshape(-1) for v in p.values()])


def test_sao_decision_near_ties_match_jax():
    """Lambdas within an ulp or two of where the port's decision flips
    (found by bisection in float32): there the choice rests on the last
    bit of the float32 costs, i.e. on how ``ddist + lam * bits`` is
    rounded."""
    planes = _frame_planes()
    stats = _stats(planes)
    lams = np.geomspace(0.5, 2000, 40).astype(np.float32)
    flips = 0
    for lo, hi in zip(lams[:-1], lams[1:]):
        d_lo = _decision(stats, lo)
        if torch.equal(d_lo, _decision(stats, hi)):
            continue
        while True:
            mid = np.float32((float(lo) + float(hi)) / 2)
            if mid in (lo, hi):
                break
            if torch.equal(_decision(stats, mid), d_lo):
                lo = mid
            else:
                hi = mid
        b = hi.view(np.int32)
        for k in (-2, -1, 0, 1):
            _check(planes, float(np.int32(b + k).view(np.float32)))
        flips += 1
    assert flips >= 8


@functools.lru_cache(maxsize=None)
def _superfast():
    """(frames, JAX results, port encoder, port results) of a 2-frame
    superfast all-intra stream; the JAX encoder codes one frame per
    batch, so it runs the shared SAO program."""
    frames = _clip(2, W, H, seed=11)
    kw = dict(width=W, height=H, qp=22, intra_period=1)
    jax_enc = share_sao_program(jfe.IntraFrameEncoder(
        jax_preset("superfast", **kw)))
    want = [jax_enc.encode_frames([f])[0] for f in frames]
    port = IntraFrameEncoder(config_from_preset("superfast", **kw),
                             device="cpu")
    assert port.headers() == jax_enc.headers()
    return frames, want, port, port.encode_frames(frames)


def test_superfast_stream_matches_jax_and_decodes():
    frames, want, port, got = _superfast()
    assert port.params.sao_enabled and not port.var
    for g, wv in zip(got, want):
        assert g.nals == wv.nals
        for a, b in ((g.recon_y, wv.recon_y), (g.recon_cb, wv.recon_cb),
                     (g.recon_cr, wv.recon_cr)):
            _eq(a, b)
        # PSNR of the pipelined path: the deblocked, pre-SAO SSEs.
        assert g.sse == wv.sse
        assert g.frame_data.sao_type.any()
    stream = port.headers() + b"".join(r.nals for r in got)
    for ((dy, dcb, dcr), _fd), r in zip(oracle_decode(stream, port.params),
                                        got):
        _eq(dy, r.recon_y)
        _eq(dcb, r.recon_cb)
        _eq(dcr, r.recon_cr)


def test_superfast_encode_stream_matches_encode():
    """The pipelined API path (SAO in the submit stage) == per-frame
    encode, PSNR from the device's pre-SAO SSEs as in the JAX
    package's pipelined path."""
    frames, want, _port, got = _superfast()
    cfg = config_from_preset("superfast", width=W, height=H, qp=22,
                             intra_period=1)
    enc = Encoder(cfg, device="cpu")
    assert enc.can_pipeline()
    out = list(enc.encode_stream(frames))
    assert all(o[0].endswith(w.nals) for o, w in zip(out, want))
    per_frame = Encoder(cfg, device="cpu")
    assert [o[0] for o in out] == [per_frame.encode(*f)[0][0]
                                   for f in frames]
    for (_, info, _), w in zip(out, want):
        assert info.psnr_y == 10.0 * math.log10(255 * 255 * W * H
                                                / w.sse[0])


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_every_preset_all_intra_is_ported(preset):
    cfg = config_from_preset(preset, width=64, height=64, intra_period=1)
    assert unsupported(cfg) == []
    Encoder(cfg, device="cpu")


@pytest.mark.parametrize("change,match", [
    pytest.param(dict(source_scan_type=1), "field",
                 id="change0-scaling lists"),
    pytest.param(dict(intra_min_cu=4, intra_max_cu=4, crypto="k"),
                 "selective encryption", id="change1-fixed CU size 4"),
    (dict(sao=True, intra_period=0, lp_gop=None, gop_len=8,
          crypto="k"), "selective encryption")])
def test_unported_rdoq_sao_raise(change, match):
    cfg = config_from_preset("superfast", width=64, height=64,
                             intra_period=1, sao=False)
    for k, v in change.items():
        setattr(cfg, k, v)
    with pytest.raises(NotImplementedError, match=match):
        Encoder(cfg, device="cpu")
