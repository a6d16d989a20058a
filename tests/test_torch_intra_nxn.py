"""The intra-NxN point (fixed CU 4: 8x8 CUs coded PART_NxN with four 4x4
luma PUs / TBs and the DST-VII, one 4x4 chroma TB per CU) and transform
skip in the port == the JAX package's, with tolerance 0.

Op cases: the DST-VII forward and inverse at 8 and 10 bits; the TB
roundtrip with DST and the transform-skip decision, sign hiding off and
on, on random blocks and on blocks whose two candidates' costs lie one
float32 ulp apart (lambda moved across the tie); the decision's rate term
for every level magnitude; the plain twin of the wavefront kernel's cu 4
instances (luma on the plan of 4x4 blocks, chroma through the chroma-only
pass on the cu 8 plan) against the JAX package's jitted XLA scan
(``reconstruct_frames`` + ``reconstruct_chroma_frames``) with transform
skip, RDOQ, lossless and at 10 bits; ``search_frame_modes`` on the plan
of 4x4 blocks (MPMs across the NxN PUs, the CTU-row rule).  The CUDA
kernel's cu 4 instances are held against the plain twin on the card by
``chip_smoke.py`` (phase 18).

Streams, one test per JAX reference stream: kvazaar_tpu_torch's
``Encoder`` on CPU tensors against kvazaar_tpu's on its CPU backend,
each picture's bytes, FrameInfo and reconstruction equal, and the JAX
oracle decoder turning the port's stream back into its recon: (n1) cu 4
at 64x64, QP 30, WPP and sign hiding; (n2) cu 4 with transform skip on
step content; (n3) cu 4 at 10 bits, 4:0:0, 32x32; (n4) cu 4 with RDOQ,
and lossless; (n5) ``Encoder.encode`` (frame by frame) == its
``encode_stream``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvazaar_tpu.api as japi
from kvazaar_tpu.config import Config as JaxConfig
from kvazaar_tpu.encoder import intra_recon as jrecon
from kvazaar_tpu.encoder.geometry import make_intra_plan as jax_plan
from kvazaar_tpu.encoder.intra_search import \
    search_frame_modes as jax_search_frame_modes
from kvazaar_tpu.ops import transform as jtransform
from kvazaar_tpu_torch import Config
from kvazaar_tpu_torch.api import Encoder
from kvazaar_tpu_torch.encoder.frame_encoder import unsupported
from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
from kvazaar_tpu_torch.encoder.intra_recon import (
    _tu_roundtrip, reconstruct_chroma_frames, reconstruct_frames)
from kvazaar_tpu_torch.encoder.intra_search import search_frame_modes
from kvazaar_tpu_torch.ops import quant as tquant
from kvazaar_tpu_torch.ops import transform as ttransform
from test_torch_rate_control import _same_streams
from test_torch_rdoq import _ulps
from test_torch_slice import _clip, oracle_decode

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

# Small CPU shapes: one intra-op thread each, so that the xdist
# workers sharing the cores do not oversubscribe them.
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                  err_msg=msg)


def _nxn(**kw):
    """Port and JAX configs of the intra-NxN point."""
    kw = dict(dict(intra_min_cu=4, intra_max_cu=4, intra_period=1), **kw)
    return Config(**kw), JaxConfig(**kw)


# ---------------------------------------------------------------- ops

def test_dst_table_and_transforms_match_jax():
    _eq(ttransform.dst4_matrix_np(), jtransform.dst4_matrix_np())
    rng = np.random.default_rng(0)
    for bd in (8, 10):
        m = (1 << bd) - 1
        resid = rng.integers(-m, m + 1, (64, 4, 4)).astype(np.int32)
        got = ttransform.forward_transform(_t(resid), 4, bd, dst=True)
        want = jtransform.forward_transform(jnp.asarray(resid), 4, bd,
                                            dst=True)
        _eq(got, want, f"forward {bd}")
        coeff = rng.integers(-32768, 32768, (64, 4, 4)).astype(np.int32)
        got = ttransform.inverse_transform(_t(coeff), 4, bd, dst=True)
        want = jtransform.inverse_transform(jnp.asarray(coeff), 4, bd,
                                            dst=True)
        _eq(got, want, f"inverse {bd}")


def test_tskip_bits_term_matches_jax():
    """The decision's per-level rate for every magnitude 0..32767, as
    the JAX package's jitted expression forms it."""
    a = np.arange(32768, dtype=np.float32)
    want = jax.jit(lambda a: jnp.where(
        a > 0, 2.0 + 2.0 * jnp.log2(a + 1.0), 0.0))(jnp.asarray(a))
    _eq(tquant.tskip_bits_np(), want)


@functools.lru_cache(maxsize=None)
def _jax_tu(bitdepth, signhide):
    """JAX's TB roundtrip with DST and the transform-skip decision,
    jitted with QP and lambda traced."""
    def f(orig, pred, qp, lam, scan_sel):
        return jrecon._tu_roundtrip(
            orig, pred, 4, qp, bitdepth, True, False,
            scan_sel if signhide else None, False, lam, None, dst=True,
            tskip=True)
    return jax.jit(f)


def _tu_both(orig, pred, qp, lam, bitdepth, signhide, scan_sel):
    want = _jax_tu(bitdepth, signhide)(
        jnp.asarray(orig), jnp.asarray(pred), jnp.int32(qp),
        jnp.float32(lam), jnp.asarray(scan_sel))
    got = _tu_roundtrip(_t(orig), _t(pred), 4, qp, bitdepth,
                        scan_sel=_t(scan_sel) if signhide else None,
                        lam=float(lam), program="grid", dst=True,
                        tskip=True)
    return got, want


@pytest.mark.parametrize("bitdepth", [8, 10])
@pytest.mark.parametrize("signhide", [False, True], ids=["sh0", "sh1"])
def test_tu_roundtrip_dst_tskip_matches_jax(bitdepth, signhide):
    rng = np.random.default_rng(bitdepth + 3 * signhide)
    m = (1 << bitdepth) - 1
    n = 256
    orig = rng.integers(0, m + 1, (n, 4, 4)).astype(np.int32)
    # Flat, stepped and textured predictions, so that both candidates
    # win somewhere.
    pred = np.clip(orig + rng.integers(-m // 8, m // 8 + 1, (n, 4, 4))
                   * (rng.random((n, 1, 1)) < 0.7), 0, m).astype(np.int32)
    pred[::5] = orig[::5].mean(axis=(1, 2), keepdims=True).astype(np.int32)
    scan_sel = rng.integers(0, 3, n).astype(np.int32)
    seen = set()
    for qp in (4, 22, 30, 37, 45):
        lam = np.float32(0.57 * 2 ** ((qp - 12) / 3))
        got, want = _tu_both(orig, pred, qp, lam, bitdepth, signhide,
                             scan_sel)
        for g, w, name in zip(got, want, ("levels", "rec", "skip")):
            _eq(g, w, f"qp {qp} {name}")
        seen |= set(np.asarray(want[2]).tolist())
    assert seen == {0, 1}


def _cost_gap_lambda(orig, pred, qp, bitdepth):
    """The float32 lambda at which the transform-skip candidate's cost
    of a block first stops being below the transform's, by bisection
    (None if the decision does not flip in 0.01..1e5)."""
    def skip(lam):
        return bool(_tu_roundtrip(_t(orig), _t(pred), 4, qp, bitdepth,
                                  lam=float(lam), program="grid", dst=True,
                                  tskip=True)[2][0])

    lo, hi = np.float32(0.01), np.float32(1e5)
    if skip(lo) == skip(hi):
        return None
    want = skip(lo)
    while True:
        mid = np.float32((float(lo) + float(hi)) / 2)
        if mid in (lo, hi):
            return hi
        lo, hi = (mid, hi) if skip(mid) == want else (lo, mid)


@pytest.mark.parametrize("bitdepth", [8, 10])
def test_tskip_decision_near_ties_match_jax(bitdepth):
    """Blocks whose two candidates' costs cross within an ulp of lambda:
    the decision compares two float32 costs (the bits sums' order, the
    fused multiply-add), so the lambdas next to the crossing pin their
    rounding."""
    rng = np.random.default_rng(40 + bitdepth)
    m = (1 << bitdepth) - 1
    found = 0
    for _ in range(300):
        orig = rng.integers(0, m + 1, (1, 4, 4)).astype(np.int32)
        pred = np.clip(orig + rng.integers(-m // 4, m // 4 + 1, (1, 4, 4)),
                       0, m).astype(np.int32)
        qp = int(rng.choice([22, 27, 32, 37]))
        lam = _cost_gap_lambda(orig, pred, qp, bitdepth)
        if lam is None:
            continue
        for lam_k in _ulps(lam, (-2, -1, 0, 1)):
            got, want = _tu_both(orig, pred, qp, lam_k, bitdepth, False,
                                 np.zeros(1, np.int32))
            for g, w in zip(got, want):
                _eq(g, w, f"qp {qp} lam {lam_k!r}")
        found += 1
        if found == 6:
            break
    assert found == 6


def _frames4(n, w, h, seed, bitdepth=8, chroma=True):
    fr = _clip(n, w, h, seed)
    if bitdepth == 10:
        fr = [tuple(p.astype(np.uint16) * 4 + 3 for p in f) for f in fr]
    if not chroma:
        fr = [(f[0], None, None) for f in fr]
    return fr


@functools.lru_cache(maxsize=None)
def _jax_recon4(w, h, kw_items):
    """JAX's cu 4 luma scan and chroma-only scan, jitted per case."""
    kw = dict(kw_items)
    plan, plan_c = jax_plan(w, h, 4, chroma=False), jax_plan(w, h, 8, True)

    def f(ys, cbs, crs, modes, qp, qp_c, lam):
        out = jrecon.reconstruct_frames(ys, None, None, modes, plan, qp,
                                        qp_c, lam=lam, **kw)
        cho = jrecon.reconstruct_chroma_frames(
            cbs, crs, modes[:, ::2, ::2], plan_c, qp_c,
            kw.get("bitdepth", 8), lossless=kw.get("lossless", False),
            signhide=kw.get("signhide", False), rdoq=kw.get("rdoq", False),
            lam=lam)
        return out, cho
    return jax.jit(f, static_argnums=(4, 5))


@pytest.mark.parametrize("case", [
    dict(tskip=True), dict(tskip=True, signhide=True),
    dict(rdoq=True, signhide=True), dict(lossless=True),
    dict(tskip=True, bitdepth=10)],
    ids=["tskip", "tskip-sh", "rdoq-sh", "lossless", "tskip-10bit"])
def test_nxn_plain_twin_matches_jax(case):
    w, h, qp = 64, 48, 30
    bd = case.get("bitdepth", 8)
    (y, cb, cr), = _frames4(1, w, h, seed=7, bitdepth=bd)
    rng = np.random.default_rng(1)
    modes = rng.integers(0, 35, (1, h // 4, w // 4)).astype(np.int32)
    qp_c = 29
    lam = 0.57 * 2 ** ((qp - 12) / 3)
    want, want_c = _jax_recon4(w, h, tuple(sorted(case.items())))(
        jnp.asarray(y[None].astype(np.int32)),
        jnp.asarray(cb[None].astype(np.int32)),
        jnp.asarray(cr[None].astype(np.int32)), jnp.asarray(modes), qp,
        qp_c, jnp.float32(lam))
    plan = make_intra_plan(w, h, 4, chroma=False)
    plan_c = make_intra_plan(w, h, 8, True)
    tools = dict(lossless=case.get("lossless", False),
                 signhide=case.get("signhide", False),
                 rdoq=case.get("rdoq", False), lam=lam)
    got = reconstruct_frames(_t(y[None].astype(np.int32)), None, None,
                             _t(modes), plan, qp, qp_c, bd,
                             tskip=case.get("tskip", False), **tools)
    _eq(got[0], want[0], "rec y")
    _eq(got[1], want[1], "levels y")
    if case.get("tskip"):
        _eq(got[6], want[6], "skip")
        assert np.asarray(want[6]).any()
    got_c = reconstruct_chroma_frames(
        _t(cb[None].astype(np.int32)), _t(cr[None].astype(np.int32)),
        _t(modes[:, ::2, ::2].copy()), plan_c, qp_c, bd, **tools)
    for g, wnt, name in zip(got_c, want_c, ("rec cb", "lv cb", "rec cr",
                                            "lv cr")):
        _eq(g, wnt, name)


def test_search_frame_modes_4x4_matches_jax():
    """The NxN PUs' search on the plan of 4x4 blocks: 4x4 Hadamard,
    unfiltered prediction, MPMs from the neighbouring PUs and DC above a
    CTU row."""
    w, h = 64, 128
    (y, _cb, _cr), = _clip(1, w, h, seed=3)
    plan, jplan = make_intra_plan(w, h, 4, False), jax_plan(w, h, 4, False)
    lam = float(np.sqrt(0.57 * 2 ** ((30 - 12) / 3)))
    for two_pass in (False, True):
        got = search_frame_modes(_t(y.astype(np.int32)), plan, lam, 8,
                                 two_pass)
        want = jax.jit(lambda f: jax_search_frame_modes(
            f, jplan, lam, 8, two_pass))(jnp.asarray(y.astype(np.int32)))
        _eq(got[0], want[0], f"modes two_pass={two_pass}")
        _eq(got[1], want[1], f"costs two_pass={two_pass}")


# ------------------------------------------------------------ streams

def _encode_both(cfg, jcfg, frames, per_frame=False):
    assert unsupported(cfg) == []
    enc = Encoder(cfg, device="cpu")
    if per_frame:
        got = [r for f in frames for r in enc.encode(*f)]
        got += enc.flush()
    else:
        got = list(enc.encode_stream(frames, need_recon=True))
    want = list(japi.Encoder(jcfg).encode_stream(frames, need_recon=True))
    return enc, got, want


def _decodes_to_recon(enc, got, frames):
    """The oracle decodes the port's stream to its recon; returns the
    decoded FrameData."""
    dec = oracle_decode(b"".join(r[0] for r in got), enc._intra.params)
    assert len(dec) == len(frames)
    h, w = frames[0][0].shape
    for (planes, _fd), (_c, info, rec) in zip(dec, got):
        for i, (d, r) in enumerate(zip(planes, rec)):
            if r is None:
                continue
            f = 1 if i == 0 else 2
            _eq(d[:h // f, :w // f], r, f"decoded POC {info.poc}")
    return [fd for _r, fd in dec]


def _stream(cfg, jcfg, frames):
    enc, got, want = _encode_both(cfg, jcfg, frames)
    _same_streams(got, want)
    return got, _decodes_to_recon(enc, got, frames)


def test_nxn_wpp_signhide_stream():
    """(n1) cu 4 at 64x64, QP 30, WPP and sign hiding: every CU NxN."""
    cfg, jcfg = _nxn(width=64, height=64, qp=30, wpp=True, signhide=True)
    _got, fds = _stream(cfg, jcfg, _clip(2, 64, 64, seed=5))
    assert all(fd.nxn8.all() for fd in fds)


def _step_frames():
    """Piecewise-flat content with sharp steps: where transform skip
    wins (as tests/test_intra4.py)."""
    rng = np.random.default_rng(3)
    y = np.kron(rng.integers(0, 255, (8, 8)),
                np.ones((8, 8))).astype(np.uint8)
    y[::3, :] = 255 - y[::3, :]
    cb = np.kron(rng.integers(60, 200, (4, 4)),
                 np.ones((8, 8))).astype(np.uint8)
    return [(y, cb, np.full((32, 32), 130, np.uint8)),
            (np.roll(y, 3, axis=1), cb, np.full((32, 32), 128, np.uint8))]


def test_nxn_transform_skip_stream():
    """(n2) cu 4 with transform skip on step content: some TBs skip."""
    cfg, jcfg = _nxn(width=64, height=64, qp=32, wpp=False,
                     transform_skip=True, hash="md5")
    _got, fds = _stream(cfg, jcfg, _step_frames())
    assert any(fd.tskip4.any() for fd in fds)


def test_nxn_mono_10bit_stream():
    """(n3) cu 4 at 10 bits, 4:0:0, 32x32 (as tests/test_intra4.py)."""
    cfg, jcfg = _nxn(width=32, height=32, qp=28, wpp=False,
                     chroma_format=400, input_bitdepth=10, hash="md5")
    rng = np.random.default_rng(9)
    frames = [(rng.integers(0, 1023, (32, 32)).astype(np.uint16), None,
               None)]
    _stream(cfg, jcfg, frames)


@pytest.mark.parametrize("tool", ["rdoq", "lossless"])
def test_nxn_rdoq_and_lossless_streams(tool):
    """(n4) cu 4 with RDOQ (and sign hiding), and cu 4 lossless (decoded
    back to the source)."""
    kw = (dict(rdoq=True, signhide=True) if tool == "rdoq"
          else dict(lossless=True))
    cfg, jcfg = _nxn(width=48, height=32, qp=27, **kw)
    frames = _clip(2, 48, 32, seed=12)
    got, _fds = _stream(cfg, jcfg, frames)
    if tool == "lossless":
        for (_c, _i, rec), f in zip(got, frames):
            for r, s in zip(rec, f):
                _eq(r, s)


def test_nxn_encode_matches_encode_stream():
    """(n5) cu 4 with transform skip through ``Encoder.encode`` frame by
    frame == through the pipelined ``encode_stream``."""
    cfg, _jcfg = _nxn(width=64, height=64, qp=32, transform_skip=True)
    frames = _step_frames()
    one = list(Encoder(cfg, device="cpu").encode_stream(frames,
                                                        need_recon=True))
    enc = Encoder(cfg, device="cpu")
    two = [r for f in frames for r in enc.encode(*f)] + enc.flush()
    _same_streams(one, two)


def test_nxn_cli_encodes(tmp_path):
    """The CLI's --set intra_min_cu=4 --set intra_max_cu=4 --set
    transform_skip=1 writes what Encoder.encode_stream yields for the
    Config its flags build."""
    from kvazaar_tpu_torch import cli
    frames = _step_frames()
    src = tmp_path / "in.yuv"
    src.write_bytes(b"".join(p.tobytes() for f in frames for p in f))
    argv = ["-i", str(src), "--input-res", "64x64", "-o",
            str(tmp_path / "out.hevc"), "-q", "32", "--period", "1",
            "--device", "cpu", "--no-psnr", "--set", "intra_min_cu=4",
            "--set", "intra_max_cu=4", "--set", "transform_skip=1"]
    assert cli.main(argv) == 0
    cfg = cli.config_from_args(cli.build_argparser().parse_args(argv))
    assert (cfg.intra_max_cu, cfg.transform_skip) == (4, True)
    want = b"".join(c for c, _, _ in
                    Encoder(cfg, device="cpu").encode_stream(frames))
    assert (tmp_path / "out.hevc").read_bytes() == want
