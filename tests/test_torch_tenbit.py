"""10-bit (Main 10) streams of the port == the JAX package's, byte for byte.

kvazaar_tpu_torch's public ``Encoder`` on CPU tensors (plain paths)
against kvazaar_tpu's on its CPU backend, at ``input_bitdepth=10`` with
uint16 pictures whose low two bits carry content: each picture's bytes,
FrameInfo and reconstruction are equal, and the JAX oracle decoder
turns the port's stream back into the port's reconstruction.  One test
per JAX reference stream, so that an xdist worker compiles its programs
once:

(a) the superfast preset at --period 1 (fixed cu 16 grid, rd 0, SAO);
(b) BASELINE config #5 (``tests/test_baseline_configs.py``
    ``test_config5_10bit_gop8_bitrate``): ``Config()`` with a GOP-8 B
    pyramid and --bitrate (fixed cu 32, frame-level rate control, a
    frame encoder per QP), its own clip at 96x64, at a bitrate that keeps
    the distinct QPs few (each fixed-grid QP compiles a JAX program);
(c) ``Config()``'s IPPP with --bitrate: LCU rate control through a
    per-CTU QP map, reconstructed with per-block QPs;
(d) the medium preset at --gop 0 (variable I and P trees, RDOQ, SAO),
    IDR + 2 P.

The SAO streams run at one frame shape and share one compiled 10-bit JAX
SAO program (``jax_sao_program_10``).  Both packages quantize 10-bit
samples without a QpBdOffset and cap SAO offsets at 7 (ROADMAP §3): the
bytes equal, and the oracle decoder, which dequantizes the same way,
decodes them.  Cheap cases pin the gates: every structure accepts 10-bit,
lossless and RDPCM among them, an 8-bit encoder refuses uint16
pictures, and the CLI reads and writes 16-bit files.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvazaar_tpu.api as japi
from kvazaar_tpu.config import Config as JaxConfig
from kvazaar_tpu.config import config_from_preset as jax_preset
from kvazaar_tpu.encoder import frame_encoder as jfe
from kvazaar_tpu_torch import Config
from kvazaar_tpu_torch.api import Encoder
from kvazaar_tpu_torch.config import config_from_preset
from kvazaar_tpu_torch.encoder import frame_encoder as tfe
from test_baseline_configs import _clip as baseline_clip
from test_torch_rate_control import (_decodes_to, _encode, _same_streams,
                                     _with_qp_maps)
from test_torch_slice import _clip

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

# Small CPU shapes: one intra-op thread each, so that the xdist
# workers sharing the cores do not oversubscribe them.
torch.set_num_threads(1)

# The one frame shape of the SAO streams.
W, H = 96, 64


def clip10(n, w, h, seed):
    """The seeded 8-bit clip of test_torch_slice shifted to 10-bit, its
    low two bits seeded noise: (y, cb, cr) uint16 in 0..1023."""
    rng = np.random.default_rng(seed + 1000)
    return [tuple((p.astype(np.uint16) << 2)
                  + rng.integers(0, 4, p.shape).astype(np.uint16)
                  for p in f) for f in _clip(n, w, h, seed)]


@functools.lru_cache(maxsize=None)
def jax_sao_program_10():
    """The JAX package's fused device SAO program for 10-bit W x H
    frames, compiled once per process; sources go in as int32 (one
    input type, one compile: the JAX fixed grid passes uint16 sources,
    its variable trees int32)."""
    prog = jfe.IntraFrameEncoder(JaxConfig(
        width=W, height=H, input_bitdepth=10, intra_period=1,
        intra_min_cu=16, intra_max_cu=16))._sao_device_fn()

    def run(ys, recs_y, cbs, recs_cb, crs, recs_cr, lam):
        return prog(jnp.asarray(ys, jnp.int32), recs_y,
                    jnp.asarray(cbs, jnp.int32), recs_cb,
                    jnp.asarray(crs, jnp.int32), recs_cr, lam)
    return run


def _share_sao(jax_enc):
    assert jax_enc.bitdepth == 10 and (jax_enc.cfg.width,
                                       jax_enc.cfg.height) == (W, H)
    jax_enc._sao_dev_jit = jax_sao_program_10()


def _ten_bit(got):
    """Every reconstruction is 16-bit and uses more than 8 bits."""
    for _c, _i, rec in got:
        assert all(r.dtype == np.uint16 for r in rec)
    assert max(int(r[2][0].max()) for r in got) > 255


def test_superfast_10bit_stream_matches_jax():
    """(a) superfast --period 1: the fixed grid's 10-bit reconstruction
    (the kernel's plain version here), deblocking and SAO at 10-bit."""
    kw = dict(width=W, height=H, qp=27, input_bitdepth=10, intra_period=1)
    frames = clip10(2, W, H, seed=21)
    enc = Encoder(config_from_preset("superfast", **kw), device="cpu")
    got = _encode(enc, frames)
    jax_enc = japi.Encoder(jax_preset("superfast", **kw))
    _share_sao(jax_enc._intra)
    _same_streams(got, _encode(jax_enc, frames))
    _ten_bit(got)
    fds = _decodes_to(enc, got, len(frames))
    assert any(fd.sao_type.any() for fd in fds)


def test_baseline5_10bit_gop8_bitrate_stream_matches_jax():
    """(b) BASELINE #5: a 10-bit GOP-8 B pyramid with --bitrate on the
    fixed cu 32 grid (IDR, P anchor, seven B pictures at their
    allocated QPs)."""
    kw = dict(width=W, height=H, qp=30, input_bitdepth=10, gop_len=8,
              intra_period=0, bitrate=130_000)
    frames = baseline_clip(9, W, H, seed=4, depth=10)
    enc = Encoder(Config(**kw), device="cpu")
    assert not tfe.var_inter(enc.cfg)
    got = _encode(enc, frames)
    assert [r[1].poc for r in got] == [0, 8, 4, 2, 1, 3, 6, 5, 7]
    assert len({r[1].qp for r in got}) > 2
    jax_enc = japi.Encoder(JaxConfig(**kw))
    _same_streams(got, _encode(jax_enc, frames))
    _ten_bit(got)
    _decodes_to(enc, got, len(frames))


def test_lcu_rc_10bit_stream_matches_jax():
    """(c) Config() IPPP with --bitrate: the per-CTU QP map of each frame
    (the last frame's complexity), the 10-bit per-block-QP
    reconstruction, cu_qp_delta, deblocking at the effective QPs."""
    w = h = 128
    kw = dict(width=w, height=h, qp=30, bitrate=600_000, intra_period=0,
              input_bitdepth=10)
    frames = clip10(4, w, h, seed=23)
    enc = Encoder(Config(**kw), device="cpu")
    assert enc.cfg.cu_qp_delta_active
    maps = _with_qp_maps(enc)
    got = _encode(enc, frames)
    jax_enc = japi.Encoder(JaxConfig(**kw))
    jmaps = _with_qp_maps(jax_enc)
    _same_streams(got, _encode(jax_enc, frames))
    for m, jm in zip(maps, jmaps):
        np.testing.assert_array_equal(m, jm)
    assert len({m.tobytes() for m in maps}) > 1
    _ten_bit(got)
    fds = _decodes_to(enc, got, len(frames))
    assert all(fd.qp_ctu is not None for fd in fds)


def test_medium_gop0_10bit_stream_matches_jax():
    """(d) medium --gop 0: variable I and P trees at 10-bit (the search's
    float32 RD costs of 10-bit residuals, RDOQ, the direct inter pass,
    the MC-aware var wavefront), SAO on every frame."""
    kw = dict(width=W, height=H, qp=27, input_bitdepth=10, intra_period=0,
              gop_len=1, ref_frames=1)
    frames = clip10(3, W, H, seed=24)
    enc = Encoder(config_from_preset("medium", **kw), device="cpu")
    assert tfe.var_inter(enc.cfg) and enc.cfg.sao
    got = _encode(enc, frames)
    jax_enc = japi.Encoder(jax_preset("medium", **kw))
    _share_sao(jax_enc._intra)
    _same_streams(got, _encode(jax_enc, frames))
    _ten_bit(got)
    fds = _decodes_to(enc, got, len(frames))
    assert any(fd.inter8.any() for fd in fds[1:])
    assert any(len(np.unique(fd.depth8)) > 1 for fd in fds)


# ---- The gates, the API and the CLI ----

_STRUCTURES = {
    "Config()": lambda kw: Config(**kw),
    "--period 1": lambda kw: Config(**kw, intra_period=1),
    "superfast --period 1": lambda kw: config_from_preset(
        "superfast", **kw, intra_period=1),
    "ultrafast": lambda kw: config_from_preset("ultrafast", **kw),
    "medium": lambda kw: config_from_preset("medium", **kw),
    "medium --gop 0": lambda kw: config_from_preset(
        "medium", **kw, intra_period=0, gop_len=1, ref_frames=1),
    "gop 8 fixed": lambda kw: Config(**kw, gop_len=8, intra_period=0),
    "--bitrate": lambda kw: Config(**kw, bitrate=1_000_000),
}


@pytest.mark.parametrize("name", list(_STRUCTURES))
def test_10bit_passes_the_gates(name):
    cfg = _STRUCTURES[name](dict(width=W, height=H, input_bitdepth=10))
    assert tfe.unsupported(cfg) == []
    Encoder(cfg, device="cpu").close()


@pytest.mark.parametrize("change,match", [
    (dict(lossless=True, intra_period=1), "lossless"),
    (dict(lossless=True, implicit_rdpcm=True, intra_period=1),
     "implicit RDPCM")])
def test_lossless_and_rdpcm_still_raise_at_10bit(change, match):
    """Lossless and implicit RDPCM were the last features the 10-bit
    gates named; they are ported now (tests/test_torch_lossless.py holds
    their streams against the JAX package's): no gate names them, and a
    10-bit picture comes back exact."""
    cfg = Config(width=W, height=H, input_bitdepth=10, **change)
    assert not any(match in name for name in tfe.unsupported(cfg))
    frame = clip10(1, W, H, seed=28)[0]
    (_c, info, rec), = Encoder(cfg, device="cpu").encode(*frame)
    for r, src in zip(rec, frame):
        np.testing.assert_array_equal(r, src)
    assert info.psnr_y == 999.99


def test_8bit_encoder_refuses_uint16_pictures():
    frame = clip10(1, W, H, seed=25)[0]
    enc = Encoder(Config(width=W, height=H, intra_period=1), device="cpu")
    with pytest.raises(ValueError, match="input_bitdepth=10"):
        enc.encode(*frame)


def test_cli_reads_and_writes_16bit_files(tmp_path):
    """--bitdepth 10 on a 16-bit little-endian file writes the API's
    stream and a 16-bit reconstruction (--debug) equal to its recon; an
    8-bit file read up to 10-bit codes as its shifted samples."""
    from kvazaar_tpu_torch import cli
    w, h = 64, 48
    frames = clip10(2, w, h, seed=26)
    src = tmp_path / "in.yuv"
    src.write_bytes(b"".join(p.astype("<u2").tobytes()
                             for f in frames for p in f))
    argv = ["-i", str(src), "--input-res", f"{w}x{h}", "-o",
            str(tmp_path / "out.hevc"), "-q", "27", "--period", "1",
            "--bitdepth", "10", "--device", "cpu", "--no-psnr",
            "--debug", str(tmp_path / "rec.yuv")]
    assert cli.main(argv) == 0
    cfg = cli.config_from_args(cli.build_argparser().parse_args(argv))
    assert cfg.input_bitdepth == 10
    want = list(Encoder(cfg, device="cpu").encode_stream(
        frames, need_recon=True))
    assert (tmp_path / "out.hevc").read_bytes() == b"".join(
        c for c, _, _ in want)
    rec = np.frombuffer((tmp_path / "rec.yuv").read_bytes(), "<u2")
    np.testing.assert_array_equal(
        rec, np.concatenate([p.reshape(-1) for _c, _i, r in want
                             for p in r]))
    src8 = tmp_path / "in8.yuv"
    src8.write_bytes(b"".join((p >> 2).astype(np.uint8).tobytes()
                              for f in frames for p in f))
    argv8 = argv[:1] + [str(src8)] + argv[2:-2] + ["--input-bitdepth", "8"]
    assert cli.main(argv8) == 0
    up = [tuple((p >> 2) << 2 for p in f) for f in frames]
    assert (tmp_path / "out.hevc").read_bytes() == b"".join(
        c for c, _, _ in Encoder(cfg, device="cpu").encode_stream(up))


def test_frame_info_psnr_at_peak_1023():
    """PSNR at 10-bit is taken against the peak 1023: the API's PSNR of
    a picture equals 10 log10(1023^2 / MSE) of its recon."""
    frames = clip10(1, W, H, seed=27)
    enc = Encoder(Config(width=W, height=H, qp=32, intra_period=1,
                         input_bitdepth=10), device="cpu")
    (_c, info, rec), = enc.encode(*frames[0])
    mse = np.mean((rec[0].astype(np.float64) - frames[0][0]) ** 2)
    assert info.psnr_y == pytest.approx(10 * np.log10(1023 ** 2 / mse),
                                        abs=1e-9)
    assert info.poc == 0 and info.psnr_y < 99
