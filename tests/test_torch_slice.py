"""The port's all-intra slice == the JAX encoder, byte for byte.

kvazaar_tpu_torch's IntraFrameEncoder(cfg, device="cpu") (plain paths)
against kvazaar_tpu's IntraFrameEncoder(cfg) on 2 frames at 128x64
(cu 16) and 64x48 (cu 8), same QP, deblocking on, WPP on: headers,
every frame's NAL bytes and the reconstruction must be identical, and
the JAX oracle decoder must turn the port's stream into the port's
reconstruction.  One case also runs the public Encoder.encode_stream.
"""

import functools

import numpy as np
import pytest

from kvazaar_tpu.bitstream.decoder import decode_stream
from kvazaar_tpu.config import Config as JaxConfig
from kvazaar_tpu.encoder.frame_encoder import \
    IntraFrameEncoder as JaxIntraFrameEncoder
from kvazaar_tpu_torch import Config
from kvazaar_tpu_torch.api import Encoder
from kvazaar_tpu_torch.encoder.frame_encoder import IntraFrameEncoder

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

CASES = {"cu16": (128, 64, 16, 22), "cu8": (64, 48, 8, 30)}


def _clip(n, w, h, seed):
    """Seeded video-like frames: smooth gradients, edges, texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    frames = []
    for i in range(n):
        y = (120 + 50 * np.sin((xx + 3 * i) / 9.0) * np.cos(yy / 7.0)
             + 30 * (((xx + 5 * i) // 24 + yy // 16) % 2)
             + rng.normal(0, 6, (h, w)))
        cb = 118 + 25 * np.sin(xx[::2, ::2] / 11.0) + rng.normal(
            0, 3, (h // 2, w // 2))
        cr = 132 + 20 * np.cos(yy[::2, ::2] / 5.0) + rng.normal(
            0, 3, (h // 2, w // 2))
        frames.append(tuple(np.clip(p, 0, 255).astype(np.uint8)
                            for p in (y, cb, cr)))
    return frames


def _cfg(w, h, cu, qp, config=Config):
    return config(width=w, height=h, qp=qp, intra_max_cu=cu,
                  intra_min_cu=cu, intra_period=1, deblock=True, wpp=True)


@functools.lru_cache(maxsize=None)
def _encoded(name):
    """(frames, JAX encoder, JAX results, port encoder, port results),
    shared by the tests of one case."""
    w, h, cu, qp = CASES[name]
    frames = _clip(2, w, h, seed=cu)
    jax_enc = JaxIntraFrameEncoder(_cfg(w, h, cu, qp, JaxConfig))
    port = IntraFrameEncoder(_cfg(w, h, cu, qp), device="cpu")
    return (frames, jax_enc, jax_enc.encode_frames(frames), port,
            port.encode_frames(frames))


@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_and_recon_match_jax(name):
    _frames, jax_enc, want, port, got = _encoded(name)
    assert port.headers() == jax_enc.headers()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.nals == w.nals
        for a, b in ((g.recon_y, w.recon_y), (g.recon_cb, w.recon_cb),
                     (g.recon_cr, w.recon_cr)):
            np.testing.assert_array_equal(a, b)
        assert g.sse == w.sse


def test_oracle_decoder_reproduces_port_recon():
    """Decoded once, on the cu 8 stream, to bound the runtime."""
    _frames, _jax_enc, _want, port, got = _encoded("cu8")
    stream = port.headers() + b"".join(r.nals for r in got)
    dec = decode_stream(stream, port.params)
    assert len(dec) == len(got)
    for ((dy, dcb, dcr), _fd), r in zip(dec, got):
        np.testing.assert_array_equal(dy, r.recon_y)
        np.testing.assert_array_equal(dcb, r.recon_cb)
        np.testing.assert_array_equal(dcr, r.recon_cr)


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_stream_matches_frame_encoder(name):
    """Public API, pipelined: chunk i = AU prefix + the JAX encoder's
    slice NAL of frame i; PSNR from device SSEs = PSNR from recon."""
    frames, jax_enc, want, _port, _got = _encoded(name)
    w, h, cu, qp = CASES[name]
    enc = Encoder(_cfg(w, h, cu, qp), device="cpu")
    out = list(enc.encode_stream(frames, need_recon=True))
    ref = Encoder(_cfg(w, h, cu, qp), device="cpu")
    per_frame = [ref.encode(*f)[0] for f in frames]
    assert [o[0] for o in out] == [p[0] for p in per_frame]
    assert out[0][0].startswith(jax_enc.headers())
    for (chunk, info, rec), r, (y, _, _) in zip(out, want, frames):
        assert chunk.endswith(r.nals)
        assert info.bits == len(r.nals) * 8
        np.testing.assert_array_equal(rec[0], r.recon_y[:h, :w])
    for (_, si, _), (_, fi, _) in zip(out, per_frame):
        assert si.psnr_y == pytest.approx(fi.psnr_y, abs=1e-9)


@pytest.mark.parametrize("change", [
    dict(intra_max_cu=32, intra_min_cu=32), dict(sao=True),
    dict(intra_min_cu=8), dict(rdoq=True), dict(rd=2)])
def test_unported_configs_raise(change):
    cfg = _cfg(64, 48, 16, 22)
    for k, v in change.items():
        setattr(cfg, k, v)
    with pytest.raises(NotImplementedError):
        Encoder(cfg, device="cpu")


def test_unported_structures_raise():
    """IPPP with one reference is ported; B-frame GOPs, more references,
    SMP, TMVP and rate control still raise."""
    for change, match in ((dict(gop_len=8), "GOP"),
                          (dict(ref_frames=2), "reference"),
                          (dict(smp=True), "SMP"),
                          (dict(tmvp=True), "TMVP"),
                          (dict(bitrate=100000), "rate control")):
        cfg = _cfg(64, 48, 16, 22)
        cfg.intra_period = 0
        for k, v in change.items():
            setattr(cfg, k, v)
        with pytest.raises(NotImplementedError, match=match):
            Encoder(cfg, device="cpu")


def test_cli_writes_the_api_stream(tmp_path):
    """python -m kvazaar_tpu_torch --period 1 --device cpu writes what
    Encoder.encode_stream yields for the Config its flags build."""
    from kvazaar_tpu_torch import cli
    frames = _clip(3, 64, 48, seed=3)
    src = tmp_path / "in.yuv"
    src.write_bytes(b"".join(p.tobytes() for f in frames for p in f))
    argv = ["-i", str(src), "--input-res", "64x48", "-o",
            str(tmp_path / "out.hevc"), "-q", "27", "--period", "1",
            "--device", "cpu", "--no-psnr"]
    assert cli.main(argv) == 0
    cfg = cli.config_from_args(cli.build_argparser().parse_args(argv))
    want = b"".join(c for c, _, _ in
                    Encoder(cfg, device="cpu").encode_stream(frames))
    assert (tmp_path / "out.hevc").read_bytes() == want


@pytest.mark.parametrize("flags", [[], ["--period", "1", "--lossless"],
                                   ["--period", "1", "--slices", "wpp"]])
def test_cli_rejects_unported_configs(tmp_path, flags):
    from kvazaar_tpu_torch import cli
    src = tmp_path / "in.yuv"
    src.write_bytes(bytes(64 * 48 * 3 // 2))
    with pytest.raises(NotImplementedError):
        cli.main(["-i", str(src), "--input-res", "64x48", "-o",
                  str(tmp_path / "out.hevc"), "--device", "cpu", *flags])
