"""Lossless coding (transquant bypass) and implicit RDPCM on the port ==
the JAX package's, byte for byte.

Op cases, tolerance 0: intra prediction without the luma boundary
fixups, and the wavefront reconstruction's plain version (the CUDA
kernel's bypass instance is held against it on the card by
``chip_smoke.py``) against the JAX package's XLA scan with
``lossless=True``, RDPCM off and on, at S = 4..32, intra and inter, 8
and 10 bits, on seeded modes of which most are 10 and 26.

Streams, one test per JAX reference stream: kvazaar_tpu_torch's public
``Encoder`` on CPU tensors against kvazaar_tpu's on its CPU backend, each
picture's bytes, FrameInfo and reconstruction equal, the reconstruction
equal to the source, and the JAX oracle decoder turning the port's
stream back into the source:

(a) ``tests/test_lossless_10bit.py``'s 64x64 fixed cu 16 all-intra
    (random samples), through the pipelined ``encode_stream``;
(b) its gradient picture with implicit RDPCM (modes 10 and 26 coded);
(c) BASELINE config #5's lossless check (``tests/test_baseline_configs
    .py``): ``Config()`` (cu 32) at 96x64, two all-intra frames;
(d) lossless + RDPCM fixed cu 16 IPPP at 64x48, IDR + 2 P, pipelined:
    the P pictures' intra blocks code no DPCM, in the JAX package's
    encoder and oracle alike (ROADMAP §3), and the stream pins it;
(e) 10-bit lossless + RDPCM all-intra at 64x64;
(f) the medium preset at --gop 0 without RDOQ and SAO (which the config
    refuses with lossless): variable I and P trees, IDR + 1 P;
(g) a fixed-grid GOP-4 B pyramid (an IDR and one GOP, 5 frames);
(h) IPPP with --bitrate: frame-level rate control, a frame encoder per
    QP (per-CTU QP is off under lossless).

The lossless slices go through the Python CABAC in both packages (the
native one is not bound for bypass).  Cheap cases pin the gates: no
structure names lossless or RDPCM any more, and what the JAX config
refuses with lossless still raises ValueError in both packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvazaar_tpu.api as japi
from kvazaar_tpu.config import Config as JaxConfig
from kvazaar_tpu.config import config_from_preset as jax_preset
from kvazaar_tpu.encoder.intra_recon import \
    reconstruct_frames as jax_reconstruct_frames
from kvazaar_tpu.ops import intra as jintra
from kvazaar_tpu_torch import Config
from kvazaar_tpu_torch.api import Encoder
from kvazaar_tpu_torch.config import config_from_preset
from kvazaar_tpu_torch.encoder import frame_encoder as tfe
from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
from kvazaar_tpu_torch.encoder.intra_recon import reconstruct_frames
from kvazaar_tpu_torch.ops import intra as tintra
from kvazaar_tpu_torch.ops import wavefront
from test_baseline_configs import _clip as baseline_clip
from test_torch_rate_control import _same_streams
from test_torch_slice import _clip, _jit_whole, oracle_decode

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

# Small CPU shapes: one intra-op thread each, so that the xdist
# workers sharing the cores do not oversubscribe them.
torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def _modes_10_26(rng, shape):
    """Seeded intra modes, about 60 % of them 10 or 26."""
    return np.where(rng.random(shape) < 0.6, rng.choice([10, 26], shape),
                    rng.integers(0, 35, shape)).astype(np.int32)


# ---- ops ----

@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_prediction_without_fixups_matches_jax(n):
    """predict_all_modes / predict_modes with fixups=False (luma): the
    DC, 10 and 26 planes keep their unfiltered first row and column."""
    rng = np.random.default_rng(n)
    refs = rng.integers(0, 256, (3, 4 * n + 1)).astype(np.int32)
    refs[0] = np.where(np.arange(4 * n + 1) < 2 * n, 250, 5)
    jall = jax.jit(functools.partial(jintra.predict_all_modes, n=n,
                                     luma=True, fixups=False))
    got = tintra.predict_all_modes(_t(refs), n, luma=True, fixups=False)
    _eq(got, jall(jnp.asarray(refs)))
    if n < 32:
        assert not torch.equal(got, tintra.predict_all_modes(_t(refs), n))
    modes = np.tile(np.arange(35, dtype=np.int32), 3)
    refs3 = np.repeat(refs, 35, axis=0)
    jsel = jax.jit(functools.partial(jintra.predict_modes, n=n, luma=True,
                                     fixups=False))
    _eq(tintra.predict_modes(_t(refs3), _t(modes), n, luma=True,
                             fixups=False),
        jsel(jnp.asarray(refs3), jnp.asarray(modes)))


_JAX_RECON = _jit_whole(jax_reconstruct_frames)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("rdpcm", [False, True], ids=["bypass", "rdpcm"])
@pytest.mark.parametrize("kind", ["intra", "inter"])
@pytest.mark.parametrize("cu", [8, 16, 32])
def test_wavefront_plain_lossless_matches_jax_scan(cu, kind, rdpcm, bd):
    """The kernel's plain version with lossless=True (rdpcm on or off)
    against the JAX XLA scan: two frames of uniform random samples,
    modes rich in 10 and 26, and for inter a random inter map with
    random MC planes.  Levels and recon equal, the recon the source."""
    rng = np.random.default_rng(cu + 3 * bd + 7 * rdpcm)
    w = h = 2 * max(cu, 16)
    mx = (1 << bd) - 1
    plan = make_intra_plan(w, h, cu, chroma=True)
    ys = rng.integers(0, mx + 1, (2, h, w)).astype(np.int32)
    cbs, crs = (rng.integers(0, mx + 1, (2, h // 2, w // 2)).astype(
        np.int32) for _ in range(2))
    shape = (2, plan.blocks_y, plan.blocks_x)
    modes = _modes_10_26(rng, shape)
    kw = {}
    if kind == "inter":
        kw = dict(is_inter=rng.random(shape) < 0.5,
                  **{k: rng.integers(0, mx + 1, p.shape).astype(np.int32)
                     for k, p in (("mc_y", ys), ("mc_cb", cbs),
                                  ("mc_cr", crs))})
    want = _JAX_RECON(ys, cbs, crs, modes, plan, 27, 29, bd, lossless=True,
                      rdpcm=rdpcm, **kw)
    got = reconstruct_frames(_t(ys), _t(cbs), _t(crs), _t(modes), plan, 27,
                             29, bd, lossless=True, rdpcm=rdpcm,
                             **{k: _t(v) for k, v in kw.items()})
    for name, g, wnt in zip(("rec_y", "lv_y", "rec_cb", "lv_cb", "rec_cr",
                             "lv_cr"), got, want):
        _eq(g, wnt, name)
    for rec, src in zip(got[0::2], (ys, cbs, crs)):
        _eq(rec.to(torch.int32), src)


# ---- streams ----

def _stream(cfg_kw, frames, preset=None, pipelined=True):
    """The port's and the JAX package's pictures of one config (a preset
    with keyword overrides, or a Config), equal picture by picture;
    returns (port encoder, port results)."""
    if preset is None:
        enc, jenc = Encoder(Config(**cfg_kw), device="cpu"), \
            japi.Encoder(JaxConfig(**cfg_kw))
    else:
        enc = Encoder(config_from_preset(preset, **cfg_kw), device="cpu")
        jenc = japi.Encoder(jax_preset(preset, **cfg_kw))
    assert enc.can_pipeline() == pipelined
    got = list(enc.encode_stream(frames, need_recon=True))
    _same_streams(got, list(jenc.encode_stream(frames, need_recon=True)))
    return enc, got


def _lossless(enc, got, frames):
    """Every picture's recon and the oracle decode of the stream are the
    source; the parameter sets signal transquant bypass, deblocking is
    off and each FrameInfo reports an exact picture.  Returns the
    decoded FrameData in decoding order."""
    p = enc._intra.params
    assert p.transquant_bypass and not p.deblock_enabled
    assert not enc.cfg.deblock
    by_poc = {r[1].poc: r for r in got}
    for poc, f in enumerate(frames):
        _c, info, rec = by_poc[poc]
        for r, s in zip(rec, f):
            _eq(r, s, f"POC {poc}")
        assert (info.psnr_y, info.psnr_u, info.psnr_v) == (999.99,) * 3
    dec = oracle_decode(b"".join(r[0] for r in got), p)
    assert len(dec) == len(frames)
    for ((dy, dcb, dcr), _fd), (_c, info, _r) in zip(dec, got):
        h, w = frames[0][0].shape
        for d, s in zip((dy[:h, :w], dcb[:h // 2, :w // 2],
                         dcr[:h // 2, :w // 2]), frames[info.poc]):
            _eq(d, s, f"decoded POC {info.poc}")
    return [fd for _r, fd in dec]


def _random_frames(n, w, h, seed, bd=8):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if bd == 8 else np.uint16
    return [tuple(rng.integers(0, 1 << bd, s).astype(dt)
                  for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
            for _ in range(n)]


def _gradient(w=64, h=64):
    """test_lossless_10bit.py's RDPCM picture: strong horizontal and
    vertical gradients, so that modes 10 and 26 win often."""
    yy, xx = np.mgrid[0:h, 0:w]
    return tuple(p.astype(np.uint8) for p in (
        (xx * 3 + yy // 8) % 256, (xx[::2, ::2] * 2) % 256,
        (yy[::2, ::2] * 2) % 256))


def test_lossless_all_intra_stream_matches_jax():
    """(a) 64x64, fixed cu 16, all-intra, random samples: the residual
    of every block is coded as it is."""
    frames = _random_frames(2, 64, 64, seed=0)
    enc, got = _stream(dict(width=64, height=64, qp=27, intra_max_cu=16,
                            intra_min_cu=16, intra_period=1,
                            lossless=True), frames)
    _lossless(enc, got, frames)


def test_rdpcm_gradient_stream_matches_jax():
    """(b) the gradient picture with implicit RDPCM: the SPS range
    extension, and horizontal / vertical blocks coding their residual's
    differences; the stream differs from plain lossless."""
    frames = [_gradient()]
    kw = dict(width=64, height=64, qp=27, intra_max_cu=16, intra_min_cu=16,
              intra_period=1, lossless=True)
    enc, got = _stream(dict(kw, implicit_rdpcm=True), frames)
    fds = _lossless(enc, got, frames)
    assert ((fds[0].mode4 == 10) | (fds[0].mode4 == 26)).any()
    plain = list(Encoder(Config(**kw), device="cpu").encode_stream(frames))
    assert plain[0][0] != got[0][0]


def test_baseline5_lossless_stream_matches_jax():
    """(c) BASELINE #5's `--lossless` bit-exact check: Config() (cu 32)
    at 96x64, two all-intra frames of its own clip."""
    frames = baseline_clip(2, 96, 64, seed=5)
    enc, got = _stream(dict(width=96, height=64, qp=30, lossless=True,
                            deblock=False, intra_period=1), frames)
    _lossless(enc, got, frames)


def test_lossless_rdpcm_ippp_stream_matches_jax():
    """(d) fixed cu 16 IPPP with implicit RDPCM, 64x48, pipelined: the I
    picture's hor/ver blocks code DPCM, the P pictures' intra blocks do
    not (the JAX package's quirk, copied), inter blocks never do."""
    frames = _clip(3, 64, 48, seed=31)
    enc, got = _stream(dict(width=64, height=48, qp=27, intra_max_cu=16,
                            intra_min_cu=16, intra_period=0, lossless=True,
                            implicit_rdpcm=True), frames)
    fds = _lossless(enc, got, frames)
    assert any(fd.inter8.any() for fd in fds[1:])
    assert [i.slice_type for _c, i, _r in got] == [2, 1, 1]


def _stripes(rng, w, h, bd):
    """Random vertical stripes on the left half and horizontal ones on
    the right (modes 26 and 10 predict them exactly), with mild noise."""
    v = rng.integers(0, 1 << bd, w)[None, :].repeat(h, 0)
    hz = rng.integers(0, 1 << bd, h)[:, None].repeat(w, 1)
    p = np.where(np.arange(w)[None, :] < w // 2, v, hz)
    p = np.clip(p + rng.integers(-2, 3, (h, w)), 0, (1 << bd) - 1)
    return p.astype(np.uint16 if bd > 8 else np.uint8)


def test_lossless_rdpcm_10bit_stream_matches_jax():
    """(e) 10-bit lossless with implicit RDPCM, all-intra 64x64: a
    picture of stripes and a random one, 16-bit samples through the
    bypass residual and its DPCM."""
    rng = np.random.default_rng(35)
    frames = [tuple(_stripes(rng, w, h, 10) for w, h in ((64, 64),
                                                         (32, 32),
                                                         (32, 32))),
              _random_frames(1, 64, 64, 3, bd=10)[0]]
    enc, got = _stream(dict(width=64, height=64, qp=27, intra_max_cu=16,
                            intra_min_cu=16, intra_period=1,
                            input_bitdepth=10, lossless=True,
                            implicit_rdpcm=True), frames)
    fds = _lossless(enc, got, frames)
    assert all(r.dtype == np.uint16 for _c, _i, rec in got for r in rec)
    assert ((fds[0].mode4 == 10) | (fds[0].mode4 == 26)).any()


def test_lossless_var_trees_stream_matches_jax():
    """(f) the medium preset at --gop 0, lossless (RDOQ and SAO off, as
    the config demands): a variable I tree, then a variable P tree with
    its direct inter pass, 64x64."""
    frames = _clip(2, 64, 64, seed=32)
    enc, got = _stream(dict(width=64, height=64, qp=27, lossless=True,
                            rdoq=False, sao=False, intra_period=0,
                            gop_len=1, ref_frames=1), frames,
                       preset="medium", pipelined=False)
    assert tfe.var_inter(enc.cfg) and enc._intra.var
    fds = _lossless(enc, got, frames)
    assert any(len(np.unique(fd.depth8)) > 1 for fd in fds)
    assert fds[1].inter8.any()


def test_lossless_gop4_stream_matches_jax():
    """(g) a fixed-grid GOP-4 B pyramid, lossless: the IDR, the P anchor
    and three B pictures (bi-averaged MC planes through the bypass)."""
    frames = _clip(5, 64, 48, seed=33)
    enc, got = _stream(dict(width=64, height=48, qp=27, intra_max_cu=16,
                            intra_min_cu=16, gop_len=4, intra_period=0,
                            lossless=True), frames, pipelined=False)
    assert [r[1].poc for r in got] == [0, 4, 2, 1, 3]
    _lossless(enc, got, frames)


def test_bypass_kernel_is_launched_or_refused(tmp_path, monkeypatch):
    """A lossless launch on a device tensor goes to the kernel's bypass
    instance: off the CPU and CUDA it is refused, the checks refuse a QP
    map with lossless and RDPCM without it, and without nvcc the launch
    raises instead of computing the plain version; no launch is
    counted."""
    plan = make_intra_plan(32, 32, 16, chroma=False)
    modes = torch.zeros((1, 2, 2), dtype=torch.int32)
    orig = torch.zeros((1, 32, 32), dtype=torch.int32)
    before = dict(wavefront.BYPASS_LAUNCHES)
    with pytest.raises(ValueError, match="unsupported device"):
        wavefront.wavefront_recon_planes(
            orig.to("meta"), None, None, modes.to("meta"), plan, 22, 22,
            lossless=True, rdpcm=True)
    with pytest.raises(ValueError, match="QP map"):
        wavefront._check(orig, modes, plan, 16, True, 8,
                         qp_map=modes.clone(), lossless=True)
    with pytest.raises(ValueError, match="needs lossless"):
        wavefront._check(orig, modes, plan, 16, True, 8, rdpcm=True)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(wavefront, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(wavefront, "library_path",
                        lambda: tmp_path / "kernels" / "missing.so")
    wavefront._library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wavefront._launch([(orig, None, 16, True, 22, None)], modes, plan,
                          None, 8, lossless=True, rdpcm=True)
    assert wavefront.BYPASS_LAUNCHES == before


# ---- the gates ----

_STRUCTURES = {
    "fixed cu 8 --period 1": lambda kw: Config(
        **kw, intra_min_cu=8, intra_max_cu=8, intra_period=1),
    "Config() IPPP": lambda kw: Config(**kw),
    "lp-GOP (ultrafast)": lambda kw: config_from_preset(
        "ultrafast", **kw),
    "medium --period 1": lambda kw: config_from_preset(
        "medium", **kw, rdoq=False, sao=False, intra_period=1),
    "medium GOP 8": lambda kw: config_from_preset(
        "medium", **kw, rdoq=False, sao=False),
    "fixed GOP 8": lambda kw: Config(**kw, gop_len=8, intra_period=0),
    "--bitrate": lambda kw: Config(**kw, bitrate=1_000_000),
    "10-bit": lambda kw: Config(**kw, input_bitdepth=10),
}


@pytest.mark.parametrize("name", list(_STRUCTURES))
def test_lossless_passes_the_gates(name):
    """Every structure takes lossless; implicit RDPCM goes with the fixed
    grid (the config refuses it with variable trees)."""
    kw = dict(width=64, height=64, lossless=True)
    cfg = _STRUCTURES[name](kw)
    cfg.sao = False
    if not tfe.var_tree(cfg) and not tfe.var_inter(cfg):
        cfg.implicit_rdpcm = True
    cfg.validate()
    assert tfe.unsupported(cfg) == []
    Encoder(cfg, device="cpu").close()


def test_frame_level_bitrate_lossless_stream_matches_jax():
    """--bitrate with lossless runs the frame-level controller (per-CTU
    QP is off under lossless), a frame encoder per QP: an IPPP stream of
    3 pictures equals the JAX package's and comes back exact."""
    frames = _clip(3, 64, 48, seed=34)
    enc, got = _stream(dict(width=64, height=48, qp=30, lossless=True,
                            bitrate=300_000, intra_period=0), frames,
                       pipelined=False)
    assert enc._rc is not None and not enc.cfg.cu_qp_delta_active
    _lossless(enc, got, frames)


@pytest.mark.parametrize("change", [
    dict(rdoq=True), dict(sao=True), dict(scaling_list="default"),
    dict(transform_skip=True, intra_min_cu=4, intra_max_cu=4),
    dict(tr_depth_intra=1, intra_min_cu=8), dict(aq=1.0),
    dict(lossless=False, implicit_rdpcm=True),
    dict(implicit_rdpcm=True, intra_min_cu=8),
    dict(implicit_rdpcm=True, intra_min_cu=4, intra_max_cu=4)],
    ids=["rdoq", "sao", "scaling", "tskip", "tr-depth", "aq",
         "rdpcm-needs-lossless", "rdpcm-var-tree", "rdpcm-cu4"])
def test_lossless_refusals_match_the_config(change):
    """What the JAX config refuses with lossless (or RDPCM) raises
    ValueError in both packages."""
    for config in (Config, JaxConfig):
        cfg = config(width=64, height=64, intra_period=1, sao=False,
                     lossless=True)
        for k, v in change.items():
            setattr(cfg, k, v)
        with pytest.raises(ValueError):
            cfg.validate()
