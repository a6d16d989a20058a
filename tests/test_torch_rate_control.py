"""The port's rate control and per-CTU QP == the JAX encoder's.

kvazaar_tpu_torch (CPU tensors, plain paths) against kvazaar_tpu (CPU
backend, jitted) with tolerance 0:

- the copied R-lambda controller (``encoder/rate_control.py``) over a
  sequence of frame, GOP and per-CTU allocations and updates;
- the array-QP quantizer and dequantizer, the wavefront reconstruction
  with a per-block QP map (cu 16 and 32, intra and inter; the JAX
  package reconstructs such frames with its XLA scan), deblocking with a
  per-block QP map (a uniform map equals the scalar QP) and the
  effective-QP chain of CTUs without coded coefficients, WPP on and off;
- whole streams through the public ``Encoder``: (a) LCU rate control on
  ``Config()``'s IPPP, (b) ROI + AQ all-intra, (c) a GOP-4 B pyramid
  with frame-level rate control, (d) the medium preset's variable P
  trees at --gop 0 with --bitrate (a frame encoder per QP, in both
  packages) and (e) the ultrafast preset's low-delay GOP with --bitrate:
  bytes, reconstruction and FrameInfo equal to the JAX ``Encoder``'s,
  and the JAX oracle decoder turns each stream into the port's
  reconstruction and, where cu_qp_delta is on, its per-CTU QPs;
- the CLI with --bitrate, --roi and --aq writes the API's stream, and
  the kernel wrapper refuses a per-block QP map it cannot launch.

One test per JAX reference stream, so an xdist worker compiles each
once.  The JAX fixed grid compiles a program per QP; the JAX encoders of
(d) share their compiled variable-tree programs (QP is data in them),
and (b) runs the traced-QP I-frame program that (a) compiled, where
this process has compiled it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvazaar_tpu.api as japi
from kvazaar_tpu.config import Config as JaxConfig
from kvazaar_tpu.config import config_from_preset as jax_preset
from kvazaar_tpu.encoder import frame_encoder as jfe
from kvazaar_tpu.encoder import rate_control as jrc
from kvazaar_tpu.encoder.intra_recon import \
    reconstruct_frames as jax_reconstruct_frames
from kvazaar_tpu.ops import deblock as jdeblock
from kvazaar_tpu.ops import quant as jquant
from kvazaar_tpu_torch import Config
from kvazaar_tpu_torch.api import Encoder
from kvazaar_tpu_torch.bitstream.syntax import FrameData
from kvazaar_tpu_torch.config import config_from_preset
from kvazaar_tpu_torch.encoder import frame_encoder as tfe
from kvazaar_tpu_torch.encoder import rate_control as trc
from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
from kvazaar_tpu_torch.encoder.intra_recon import reconstruct_frames
from kvazaar_tpu_torch.ops import deblock as tdeblock
from kvazaar_tpu_torch.ops import quant as tquant
from kvazaar_tpu_torch.ops import wavefront
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


# ---- The controller and the ops ----

def test_rate_controller_matches_jax():
    """A run of frame-level, GOP and per-CTU allocations with updates
    from seeded bit counts: every lambda, QP, target, map and the state
    equal the JAX package's, float for float."""
    rng = np.random.default_rng(0)
    gop = japi.GOP_TABLES[8]
    ctrls = [m.RateController(1_500_000, 25.0, 416, 240) for m in (trc, jrc)]
    for i in range(24):
        weights = rng.gamma(2.0, 50.0, (4, 7)) if i % 3 else None
        target = float(rng.integers(0, 3)) * 9000.0
        bits = int(rng.integers(200, 200_000))
        outs = []
        for c in ctrls:
            outs.append([c.frame_lambda_qp(i % 5 == 0), c.allocate_gop(gop),
                         c.pic_lambda_qp(target),
                         c.lcu_qp_map(30 + i % 7, (4, 7), weights)])
            c.update(bits, outs[-1][0][0])
        for got, want in zip(*outs):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert dataclasses.asdict(ctrls[0].s) == dataclasses.asdict(
            ctrls[1].s)
    fd = FrameData.empty(128, 64, True)
    fd.coeff_y[:] = rng.integers(-40, 40, fd.coeff_y.shape)
    np.testing.assert_array_equal(
        trc.RateController.ctu_weights_from_levels(fd, 128, 64),
        jrc.RateController.ctu_weights_from_levels(fd, 128, 64))


@pytest.mark.parametrize("intra", ["intra", "inter", "mixed"])
def test_array_qp_quant_matches_jax(intra):
    rng = np.random.default_rng(1)
    n = 24
    coeff = rng.integers(-32000, 32000, (n, 8, 8)).astype(np.int32)
    qps = rng.integers(0, 52, (n,)).astype(np.int32)
    flag = {"intra": True, "inter": False,
            "mixed": rng.integers(0, 2, (n,)).astype(bool)}[intra]
    tflag = flag if isinstance(flag, bool) else _t(flag)
    jflag = flag if isinstance(flag, bool) else jnp.asarray(flag)
    lv = tquant.quantize(_t(coeff), _t(qps), 8, 8, intra=tflag)
    _eq(lv, jquant.quantize(jnp.asarray(coeff), jnp.asarray(qps), 8, 8,
                            intra=jflag))
    _eq(tquant.dequantize(lv, _t(qps), 8, 8),
        jquant.dequantize(jnp.asarray(lv.numpy()), jnp.asarray(qps), 8, 8))
    _eq(tquant.quantize_rdoq(_t(coeff), _t(qps), 8, 8),
        jquant.quantize_rdoq(jnp.asarray(coeff), jnp.asarray(qps), 8, 8))


_JAX_RECON = _jit_whole(jax_reconstruct_frames)


@pytest.mark.parametrize("cu", [16, 32])
@pytest.mark.parametrize("inter", [False, True])
def test_reconstruct_frames_qp_map_matches_jax(cu, inter):
    """Two frames, seeded modes, a non-uniform per-block map from -3 to
    54 (clipped to 0..51 inside), intra or with a random inter map and
    MC planes."""
    rng = np.random.default_rng(cu + inter)
    w, h = 96, 64
    plan = make_intra_plan(w, h, cu, chroma=True)
    frames = _clip(2, w, h, seed=cu)
    ys, cbs, crs = (np.stack([f[k] for f in frames]).astype(np.int32)
                    for k in range(3))
    shape = (2, plan.blocks_y, plan.blocks_x)
    modes = rng.integers(0, 35, shape).astype(np.int32)
    qmap = rng.integers(-3, 55, shape).astype(np.int32)
    kw = {}
    if inter:
        kw = dict(is_inter=rng.integers(0, 2, shape).astype(bool),
                  mc_y=np.roll(ys, 3, axis=2), mc_cb=np.roll(cbs, 1, axis=1),
                  mc_cr=np.roll(crs, -2, axis=2))
    want = _JAX_RECON(ys, cbs, crs, modes, plan, 27, 29, 8,
                      qp_map=qmap, **kw)
    got = reconstruct_frames(_t(ys), _t(cbs), _t(crs), _t(modes), plan, 27,
                             29, 8, qp_map=_t(qmap),
                             **{k: _t(v) for k, v in kw.items()})
    for name, g, wnt in zip(("rec_y", "lv_y", "rec_cb", "lv_cb", "rec_cr",
                             "lv_cr"), got, want):
        _eq(g, wnt, name)


_JAX_DEBLOCK = _jit_whole(jdeblock.deblock_frame)


@pytest.mark.parametrize("bs", ["all-intra", "bs-maps"])
def test_deblock_qp_map_matches_jax(bs):
    """A blocky frame (edges the filter touches at every QP in the map)
    with a per-block map from 10 to 51, with and without bS maps; a
    uniform map equals the scalar QP."""
    rng = np.random.default_rng(4)
    h, w, s = 64, 96, 16
    frame = _clip(1, w, h, seed=4)[0]
    planes = [(p.astype(np.int32) // 6) * 6 for p in frame]
    qmap = rng.integers(10, 52, (h // s, w // s)).astype(np.int32)
    kw = {}
    if bs == "bs-maps":
        kw = dict(bs_v=rng.integers(0, 3, qmap.shape).astype(np.int32),
                  bs_h=rng.integers(0, 3, qmap.shape).astype(np.int32))
    got = tdeblock.deblock_frame(*(_t(p) for p in planes), 30, s,
                                 qp_map=_t(qmap),
                                 **{k: _t(v) for k, v in kw.items()})
    want = _JAX_DEBLOCK(*planes, 30, s, qp_map=qmap, **kw)
    for g, wnt in zip(got, want):
        _eq(g, wnt)
    scalar = tdeblock.deblock_frame(*(_t(p) for p in planes), 37, s,
                                    **{k: _t(v) for k, v in kw.items()})
    uniform = tdeblock.deblock_frame(
        *(_t(p) for p in planes), 30, s,
        qp_map=torch.full(qmap.shape, 37, dtype=torch.int32),
        **{k: _t(v) for k, v in kw.items()})
    for a, b in zip(scalar, uniform):
        _eq(a, b)
    assert not torch.equal(got[0], scalar[0])


@pytest.mark.parametrize("wpp", [True, False])
def test_effective_qp_chain_matches_jax(wpp):
    """Levels with whole CTUs (and a CTU row) coding nothing: the
    per-CTU cbf and the effective map (the predictor chain from the
    slice QP, restarted per CTU row under WPP) equal JAX's."""
    rng = np.random.default_rng(5)
    w, h, cu = 192, 160, 16
    kw = dict(width=w, height=h, qp=30, intra_min_cu=cu, intra_max_cu=cu,
              intra_period=0, wpp=wpp, aq=1.0)
    port = tfe.IntraFrameEncoder(Config(**kw).validate(), "cpu")
    jax_enc = jfe.IntraFrameEncoder(JaxConfig(**kw).validate())
    plan = port.plan
    nblk = plan.blocks_y * plan.blocks_x
    lv = []
    for s in (cu, cu // 2, cu // 2):
        a = rng.integers(-2, 3, (2, nblk, s, s)) * (
            rng.random((2, nblk, 1, 1)) < 0.3)
        a = a.reshape(2, plan.blocks_y, plan.blocks_x, s, s)
        a[0, 4:8, :, :, :] = 0                # CTU row 1 codes nothing
        a[1, :4, 4:8] = 0                     # CTU (0, 1)
        a[1, 8:, :4] = 0                      # CTU (2, 0)
        lv.append(a.reshape(2, nblk, s, s).astype(np.int16))
    qp_ctu = rng.integers(20, 45, (2, 3, 3)).astype(np.int32)
    cbf = port._cbf_ctu_of(*(_t(a) for a in lv))
    want_cbf = jax_enc._cbf_ctu_of(*(jnp.asarray(a) for a in lv))
    _eq(cbf, want_cbf)
    assert not cbf.all()
    eff = port._effective_qp_ctu(_t(qp_ctu), cbf)
    _eq(eff, jax_enc._effective_qp_ctu(jnp.asarray(qp_ctu), want_cbf))
    _eq(port._qp_blk_of(eff), jax_enc._qp_blk_of(jnp.asarray(eff.numpy())))


# ---- Streams ----

def _encode(enc, frames):
    out = []
    for f in frames:
        out += enc.encode(*f)
    return out + enc.flush()


def _same_streams(got, want):
    assert len(got) == len(want)
    for i, ((gc, gi, gr), (wc, wi, wr)) in enumerate(zip(got, want)):
        assert gc == wc, f"picture {i}: bytes differ"
        assert dataclasses.astuple(gi) == dataclasses.astuple(wi), i
        for a, b in zip(gr, wr):
            np.testing.assert_array_equal(a, b, err_msg=f"picture {i}")


def _decodes_to(port_enc, results, n_frames):
    """The JAX oracle decoder turns the port's stream into the port's
    reconstruction (decoding order) and, with cu_qp_delta, into the
    port's effective per-CTU QPs."""
    stream = b"".join(r[0] for r in results)
    dec = oracle_decode(stream, port_enc._intra.params)
    assert len(dec) == n_frames
    h, w = results[0][2][0].shape
    for ((dy, dcb, dcr), fd), (_c, info, rec) in zip(dec, results):
        _eq(dy[:h, :w], rec[0], f"POC {info.poc}")
        _eq(dcb[:h // 2, :w // 2], rec[1])
        _eq(dcr[:h // 2, :w // 2], rec[2])
    return [fd for _r, fd in dec]


# The JAX traced-QP I-frame program of (a) and (b) (the same config but
# the rate control, ROI and AQ fields, which the program does not read).
_QP_PROGRAM = {}


def _share_qp_program(jax_intra):
    if "prog" in _QP_PROGRAM:
        jax_intra._device_encode_qp = _QP_PROGRAM["prog"]


def _keep_qp_program(jax_intra):
    _QP_PROGRAM.setdefault("prog", jax_intra._device_encode_qp)


def _with_qp_maps(enc):
    """Records the intended per-CTU map of every frame the encoder codes
    (None where per-CTU QP is off)."""
    maps = []
    qp_ctu_for = enc._qp_ctu_for

    def keep(*a):
        m = qp_ctu_for(*a)
        maps.append(None if m is None else m.copy())
        return m

    enc._qp_ctu_for = keep
    return maps


def test_lcu_rc_ippp_stream_matches_jax():
    """(a) Config() at 128x128 (fixed cu 32, IPPP) with --bitrate: the
    frame QP rides a per-CTU map allocated by the previous frame's
    complexity; one frame encoder, QP as data."""
    w = h = 128
    kw = dict(width=w, height=h, qp=30, bitrate=600_000, intra_period=0)
    frames = _clip(6, w, h, seed=11)
    enc = Encoder(Config(**kw), device="cpu")
    assert enc.cfg.cu_qp_delta_active and not enc.can_pipeline()
    maps = _with_qp_maps(enc)
    got = _encode(enc, frames)
    jax_enc = japi.Encoder(JaxConfig(**kw))
    _share_qp_program(jax_enc._intra)
    jmaps = _with_qp_maps(jax_enc)
    _same_streams(got, _encode(jax_enc, frames))
    _keep_qp_program(jax_enc._intra)
    for m, jm in zip(maps, jmaps):
        _eq(m, jm)
    assert len({m.tobytes() for m in maps}) > 1
    assert enc._rc_wts and dataclasses.asdict(enc._rc.s) == \
        dataclasses.asdict(jax_enc._rc.s)
    fds = _decodes_to(enc, got, len(frames))
    for fd, (_c, _i, _r) in zip(fds, got):
        assert fd.qp_ctu is not None


def test_roi_aq_all_intra_stream_matches_jax(tmp_path):
    """(b) ROI offsets and variance AQ on all-intra cu 32 frames: the
    decoded per-CTU QPs carry the ROI's offsets (its lower left region
    lower than its upper right)."""
    w = h = 128
    roi = tmp_path / "roi.txt"
    roi.write_text("2 2\n-4 3 0 2\n")
    kw = dict(width=w, height=h, qp=30, roi=str(roi), aq=1.0,
              intra_period=1)
    frames = _clip(2, w, h, seed=12)
    enc = Encoder(Config(**kw), device="cpu")
    got = _encode(enc, frames)
    jax_enc = japi.Encoder(JaxConfig(**kw))
    _share_qp_program(jax_enc._intra)
    _same_streams(got, _encode(jax_enc, frames))
    _keep_qp_program(jax_enc._intra)
    fds = _decodes_to(enc, got, len(frames))
    assert fds[0].qp_ctu[0, 0] < fds[0].qp_ctu[0, 1]


def test_gop4_frame_rc_stream_matches_jax():
    """(c) A GOP-4 B pyramid on the fixed grid with --bitrate: LCU rate
    control degrades to frame-level, the GOP's allocation gives each
    picture its QP (within 3 of the last), one frame encoder per QP;
    the IDR and one GOP.  The rate keeps the three B pictures at one QP,
    so the JAX package compiles three programs."""
    w = h = 64
    kw = dict(width=w, height=h, qp=32, bitrate=65_000, gop_len=4,
              intra_period=0)
    frames = _clip(5, w, h, seed=13)
    enc = Encoder(Config(**kw), device="cpu")
    assert not enc.cfg.cu_qp_delta_active
    got = _encode(enc, frames)
    assert [r[1].poc for r in got] == [0, 4, 2, 1, 3]
    assert [r[1].qp for r in got] == [29, 26, 23, 23, 23]
    jax_enc = japi.Encoder(JaxConfig(**kw))
    _same_streams(got, _encode(jax_enc, frames))
    assert enc._rc.s.frames_coded == jax_enc._rc.s.frames_coded == 5
    _decodes_to(enc, got, len(frames))


_VAR_PROGRAMS = ("_qt_search", "_qt_search_spec", "_qt_search_p",
                 "_qt_search_p_spec", "_merge_rd_jit_p", "_sao_dev_jit")


def test_var_p_bitrate_stream_matches_jax(monkeypatch):
    """(d) The medium preset at --gop 0 (variable P trees, RDOQ; SAO off,
    whose JAX program alone would compile for about 50 s) with
    --bitrate: a frame encoder per QP in both packages; the JAX ones
    share their compiled programs, which take QP as data."""
    w = h = 64
    kw = dict(width=w, height=h, qp=30, bitrate=300_000, intra_period=0,
              gop_len=1, ref_frames=1, sao=False)
    frames = _clip(3, w, h, seed=14)
    enc = Encoder(config_from_preset("medium", **kw), device="cpu")
    assert tfe.var_inter(enc.cfg) and not enc.cfg.cu_qp_delta_active
    got = _encode(enc, frames)
    assert len({r[1].qp for r in got}) == 3

    encoder_for_qp = japi.Encoder._encoder_for_qp

    def shared(self, qp):
        fresh = qp not in self._encoders
        out = encoder_for_qp(self, qp)
        if fresh:
            for other in list(self._encoders.values()):
                for attr in _VAR_PROGRAMS:
                    if attr in vars(other) and attr not in vars(out):
                        setattr(out, attr, getattr(other, attr))
                if other is not out and other is not self._intra:
                    out._var_recon_fn = other._var_recon_fn
                    out._var_recon_inter_fn = other._var_recon_inter_fn
        return out

    monkeypatch.setattr(japi.Encoder, "_encoder_for_qp", shared)
    jax_enc = japi.Encoder(jax_preset("medium", **kw))
    _same_streams(got, _encode(jax_enc, frames))
    _decodes_to(enc, got, len(frames))


def test_lowdelay_gop_bitrate_stream_matches_jax():
    """(e) The ultrafast preset (low-delay GOP lp-g4d4t1, fixed grid)
    with --bitrate: frame-level rate control replaces the positions' QP
    offsets, a frame encoder per QP (the rate keeps both P frames at one
    QP: two JAX programs)."""
    w = h = 64
    kw = dict(width=w, height=h, qp=30, bitrate=55_000)
    frames = _clip(3, w, h, seed=15)
    enc = Encoder(config_from_preset("ultrafast", **kw), device="cpu")
    got = _encode(enc, frames)
    assert [r[1].qp for r in got] == [27, 24, 24]
    jax_enc = japi.Encoder(jax_preset("ultrafast", **kw))
    _same_streams(got, _encode(jax_enc, frames))
    _decodes_to(enc, got, len(frames))


# ---- The CLI, the gates and the kernel wrapper ----

def test_cli_bitrate_roi_aq_writes_the_api_stream(tmp_path):
    from kvazaar_tpu_torch import cli
    w, h = 64, 48
    frames = _clip(3, w, h, seed=16)
    src = tmp_path / "in.yuv"
    src.write_bytes(b"".join(p.tobytes() for f in frames for p in f))
    roi = tmp_path / "roi.txt"
    roi.write_text("2 1\n3 -2\n")
    argv = ["-i", str(src), "--input-res", f"{w}x{h}", "-o",
            str(tmp_path / "out.hevc"), "--period", "0", "--gop", "0",
            "--set", "inter-min-cu=16", "--bitrate", "300000", "--roi",
            str(roi), "--aq", "1", "--device", "cpu", "--no-psnr"]
    assert cli.main(argv) == 0
    cfg = cli.config_from_args(cli.build_argparser().parse_args(argv))
    assert cfg.bitrate == 300000 and cfg.aq == 1.0 and cfg.roi == str(roi)
    assert cfg.cu_qp_delta_active
    want = b"".join(c for c, _, _ in
                    Encoder(cfg, device="cpu").encode_stream(frames))
    assert (tmp_path / "out.hevc").read_bytes() == want


@pytest.mark.parametrize("name", ["Config()", "--period 1", "--gop 0",
                                  "ultrafast", "superfast", "veryfast",
                                  "faster", "fast", "medium", "slow",
                                  "slower", "veryslow", "placebo"])
def test_bitrate_passes_the_gates(name):
    """--bitrate on Config(), every preset's default, --period 1 and
    --gop 0 builds an encoder; per-CTU QP where the config makes it
    active."""
    if name == "Config()":
        cfg = Config(width=64, height=64, bitrate=500_000)
    elif name.startswith("--"):
        change = (dict(intra_period=1) if name == "--period 1"
                  else dict(intra_period=0, gop_len=1, ref_frames=1))
        cfg = config_from_preset("medium", width=64, height=64,
                                 bitrate=500_000, **change)
    else:
        cfg = config_from_preset(name, width=64, height=64,
                                 bitrate=500_000)
    enc = Encoder(cfg, device="cpu")
    assert enc._rc is not None and not enc.can_pipeline()
    assert enc.cfg.cu_qp_delta_active == (name == "Config()")


@pytest.mark.parametrize("change", [dict(gop_len=8), dict(ref_frames=2),
                                    dict(lossless=True)])
def test_roi_aq_refusals_match_the_config(change):
    """ROI / AQ on a B pyramid, multi-reference or lossless: the config
    refuses them with ValueError, in both packages."""
    for config in (Config, JaxConfig):
        cfg = config(width=64, height=64, aq=1.0, intra_period=0,
                     **change)
        with pytest.raises(ValueError):
            cfg.validate()


def test_qp_map_kernel_is_launched_or_refused(tmp_path, monkeypatch):
    """A per-block QP map on a device tensor goes to the kernel: off the
    CPU and CUDA it is refused, and without nvcc the launch raises
    instead of computing the plain version."""
    plan = make_intra_plan(32, 32, 16, chroma=False)
    qmap = torch.full((1, 2, 2), 30, dtype=torch.int32)
    before = dict(wavefront.QP_MAP_LAUNCHES)
    with pytest.raises(ValueError, match="unsupported device"):
        wavefront.wavefront_recon_planes(
            torch.zeros((1, 32, 32), dtype=torch.int32, device="meta"),
            None, None, torch.zeros((1, 2, 2), dtype=torch.int32,
                                    device="meta"),
            plan, 22, 22, qp_map=qmap.to("meta"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(wavefront, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(wavefront, "library_path",
                        lambda: tmp_path / "kernels" / "missing.so")
    wavefront._library.cache_clear()
    orig = torch.zeros((1, 32, 32), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wavefront._launch([(orig, None, 16, True, 22, qmap)],
                          torch.zeros((1, 2, 2), dtype=torch.int32), plan,
                          None)
    assert wavefront.QP_MAP_LAUNCHES == before
