"""The port's low-delay IPPP slice == the JAX encoder, byte for byte.

kvazaar_tpu_torch's IntraFrameEncoder(cfg, device="cpu") (plain paths)
against kvazaar_tpu's sequential chain encode_frame + encode_p_frame on
an IDR and 2 P frames at 128x64 (cu 16, QP 22) and 64x48 (cu 8, QP 30),
deblocking and WPP on, one reference, +-16 px search with quarter-pel
refinement: headers, every frame's NAL bytes and the reconstruction must
be identical; the JAX oracle decoder must turn the port's stream into
the port's reconstruction; and the port's pipelined encode_stream must
yield its per-frame encode chunks.
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
from test_torch_slice import _clip

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

CASES = {"cu16": (128, 64, 16, 22), "cu8": (64, 48, 8, 30)}


def _frames(w, h, seed):
    """Three moving frames; the last one gains a patch of fresh noise
    that no reference block matches, so its P frame mixes intra and
    inter blocks."""
    frames = _clip(3, w, h, seed)
    rng = np.random.default_rng(seed + 1)
    y, cb, cr = (p.copy() for p in frames[2])
    y[8:40, 16:48] = rng.integers(0, 256, (32, 32))
    frames[2] = (y, cb, cr)
    return frames


def _kw(w, h, cu, qp):
    return dict(width=w, height=h, qp=qp, intra_max_cu=cu, intra_min_cu=cu,
                intra_period=0, deblock=True, wpp=True, me_range=16,
                me_subpel=True)


@functools.lru_cache(maxsize=None)
def _encoded(name):
    """(frames, JAX encoder, JAX results, port encoder, port results),
    shared by the tests of one case."""
    w, h, cu, qp = CASES[name]
    frames = _frames(w, h, seed=cu)
    jax_enc = JaxIntraFrameEncoder(JaxConfig(**_kw(w, h, cu, qp)))
    port = IntraFrameEncoder(Config(**_kw(w, h, cu, qp)), device="cpu")
    want = [jax_enc.encode_frame(*frames[0])]
    got = [port.encode_frame(*frames[0])]
    for poc in (1, 2):
        want.append(jax_enc.encode_p_frame(*frames[poc], poc=poc,
                                           ref_poc=poc - 1))
        got.append(port.encode_p_frame(*frames[poc], poc=poc,
                                       ref_poc=poc - 1))
    return frames, jax_enc, want, port, got


@pytest.mark.parametrize("name", sorted(CASES))
def test_ippp_matches_jax(name):
    """One test per case, so that each case's JAX chain is compiled and
    run once: the frame encoder's NALs, recon and SSEs == the JAX
    chain's; the public encode_stream chunks == the per-frame encode
    chunks == AU prefix + those NALs; (cu 8) the JAX oracle decoder
    turns the stream into the port's recon."""
    frames, jax_enc, want, port, got = _encoded(name)
    w, h, cu, qp = CASES[name]
    assert port.headers() == jax_enc.headers()
    assert len(got) == len(want) == 3
    for g, r in zip(got, want):
        assert g.nals == r.nals
        for a, b in ((g.recon_y, r.recon_y), (g.recon_cb, r.recon_cb),
                     (g.recon_cr, r.recon_cr)):
            np.testing.assert_array_equal(a, b)
        assert g.sse == r.sse
    # Both block kinds reach the P path.
    inter = np.concatenate([r.frame_data.inter8.ravel() for r in got[1:]])
    assert inter.any() and not inter.all()

    out = list(Encoder(Config(**_kw(w, h, cu, qp)),
                       device="cpu").encode_stream(frames, need_recon=True))
    ref = Encoder(Config(**_kw(w, h, cu, qp)), device="cpu")
    per_frame = [ref.encode(*f)[0] for f in frames]
    assert [o[0] for o in out] == [p[0] for p in per_frame]
    assert out[0][0].startswith(jax_enc.headers())
    for (chunk, info, rec), r in zip(out, want):
        assert chunk.endswith(r.nals)
        assert info.bits == len(r.nals) * 8
        np.testing.assert_array_equal(rec[0], r.recon_y[:h, :w])
    assert [o[1].slice_type for o in out] == [2, 1, 1]
    for (_, si, _), (_, fi, _) in zip(out, per_frame):
        assert si.psnr_y == pytest.approx(fi.psnr_y, abs=1e-9)

    if name == "cu8":        # one decode bounds the runtime
        dec = decode_stream(port.headers() + b"".join(r.nals for r in got),
                            port.params)
        assert len(dec) == len(got)
        for ((dy, dcb, dcr), _fd), r in zip(dec, got):
            np.testing.assert_array_equal(dy, r.recon_y)
            np.testing.assert_array_equal(dcb, r.recon_cb)
            np.testing.assert_array_equal(dcr, r.recon_cr)


def test_cli_ippp_writes_the_api_stream(tmp_path):
    """python -m kvazaar_tpu_torch --period 0|2 --device cpu writes what
    Encoder.encode_stream yields for the Config its flags build: P
    frames after one IDR, or an IDR every 2 frames with the POC
    restarting at each IDR (so the second IDR + P pair repeats the
    first one's NALs)."""
    from kvazaar_tpu_torch import cli
    frames = _clip(2, 64, 48, seed=4) * 2
    src = tmp_path / "in.yuv"
    src.write_bytes(b"".join(p.tobytes() for f in frames for p in f))
    for period, kinds in (("0", [2, 1, 1, 1]), ("2", [2, 1, 2, 1])):
        argv = ["-i", str(src), "--input-res", "64x48", "-o",
                str(tmp_path / f"out{period}.hevc"), "-q", "30",
                "--period", period, "--set", "intra-min-cu=16", "--set",
                "inter-min-cu=16", "--ref", "1", "--set", "gop=0",
                "--device", "cpu", "--no-psnr"]
        assert cli.main(argv) == 0
        cfg = cli.config_from_args(cli.build_argparser().parse_args(argv))
        out = list(Encoder(cfg, device="cpu").encode_stream(frames))
        assert [o[1].slice_type for o in out] == kinds
        assert [o[1].poc for o in out] == [0, 1, 2, 3]
        assert (tmp_path / f"out{period}.hevc").read_bytes() == b"".join(
            c for c, _, _ in out)
    assert out[2][0] == out[0][0][-len(out[2][0]):]
    assert out[3][0] == out[1][0]
