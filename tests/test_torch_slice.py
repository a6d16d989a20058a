"""The port's all-intra slice == the JAX encoder, byte for byte.

kvazaar_tpu_torch's IntraFrameEncoder(cfg, device="cpu") (plain paths)
against kvazaar_tpu's IntraFrameEncoder(cfg) on 2 frames at 128x64
(cu 16) and 64x48 (cu 8), same QP, deblocking on, WPP on: headers,
every frame's NAL bytes and the reconstruction must be identical, and
the JAX oracle decoder must turn the port's stream into the port's
reconstruction.  One case also runs the public Encoder.encode_stream.

``oracle_decode`` (shared by the port's stream tests) runs the JAX
oracle decoder with its tensor stages (reconstruction, motion
compensation per block and per 8x8 cell, bi-prediction, boundary
strengths, deblocking, SAO) each jitted whole: the same integer
functions, compiled once per shape instead of one XLA compile per
primitive call, which made the decode of three 64x48 P frames take
about 22 s (and the cell MC of two variable-tree P frames about 9 s).
"""

import contextlib
import functools
import importlib
import inspect

import jax
import numpy as np
import pytest
import torch

from kvazaar_tpu.bitstream.decoder import decode_stream
from kvazaar_tpu.config import Config as JaxConfig
from kvazaar_tpu.encoder.frame_encoder import \
    IntraFrameEncoder as JaxIntraFrameEncoder
from kvazaar_tpu_torch import Config
from kvazaar_tpu_torch.api import Encoder
from kvazaar_tpu_torch.encoder.frame_encoder import IntraFrameEncoder

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

# Small CPU shapes: one intra-op thread each, so that the xdist
# workers sharing the cores do not oversubscribe them.
torch.set_num_threads(1)

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


class _ById:
    """A static jit argument hashed by identity (plans hold numpy arrays
    and are cached: one object per geometry)."""

    def __init__(self, v):
        self.v = v

    def __hash__(self):
        return id(self.v)

    def __eq__(self, other):
        return isinstance(other, _ById) and other.v is self.v


def _is_array(v) -> bool:
    return isinstance(v, (np.ndarray, jax.Array))


def _jit_whole(fn):
    """fn jitted as a whole: arrays and tuples of arrays (None entries
    allowed) are traced, every other argument (numbers, None, plans,
    scaling tables) is static."""
    sig = inspect.signature(fn)

    @functools.lru_cache(maxsize=None)
    def compiled(static):
        fixed = {n: v.v if isinstance(v, _ById) else v for n, v in static}
        return jax.jit(lambda dyn: fn(**fixed, **dyn))

    def call(*args, **kw):
        bound = sig.bind(*args, **kw)
        bound.apply_defaults()
        dyn, static = {}, []
        for n, v in bound.arguments.items():
            if _is_array(v) or (
                    isinstance(v, tuple) and any(map(_is_array, v))
                    and all(x is None or _is_array(x) for x in v)):
                dyn[n] = v
            else:
                try:
                    hash(v)
                except TypeError:
                    v = _ById(v)
                static.append((n, v))
        return compiled(tuple(static))(dyn)

    return call


# The oracle decoder's tensor stages, looked up at call time.
_ORACLE_STAGES = (("kvazaar_tpu.ops.deblock", "deblock_frame"),
                  ("kvazaar_tpu.encoder.inter_search", "mc_planes"),
                  ("kvazaar_tpu.encoder.inter_search", "bi_mc_planes"),
                  ("kvazaar_tpu.encoder.inter_search", "mc_planes_cells"),
                  ("kvazaar_tpu.encoder.inter_search",
                   "bi_mc_planes_cells"),
                  ("kvazaar_tpu.encoder.frame_encoder", "compute_bs_maps"),
                  ("kvazaar_tpu.encoder.frame_encoder",
                   "compute_bs_maps_b"),
                  ("kvazaar_tpu.encoder.frame_encoder",
                   "compute_bs_maps_smp"),
                  ("kvazaar_tpu.ops.sao", "apply_sao_plane"),
                  ("kvazaar_tpu.bitstream.decoder", "_decode_recon_impl"))
_JITTED = {}


@contextlib.contextmanager
def _whole_jit_stages():
    saved = []
    for mod_name, name in _ORACLE_STAGES:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, name)
        if (mod_name, name) not in _JITTED:
            _JITTED[(mod_name, name)] = _jit_whole(fn)
        saved.append((mod, name, fn))
        setattr(mod, name, _JITTED[(mod_name, name)])
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def oracle_decode(stream, params):
    """The JAX oracle decoder's decode_stream, its tensor stages jitted
    whole (see the module docstring)."""
    with _whole_jit_stages():
        return decode_stream(stream, params)


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
    dec = oracle_decode(stream, port.params)
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
    dict(tmvp=True, intra_period=0, crypto="k"),
    dict(gop_len=8, intra_period=0, crypto="k"),
    dict(intra_min_cu=8, intra_period=0, crypto="k"),
    dict(inter_min_cu=8, intra_period=0, gop_len=8, crypto="k"),
    dict(source_scan_type=2),
    dict(intra_min_cu=4, intra_max_cu=4, crypto="k")])
def test_unported_configs_raise(change):
    cfg = _cfg(64, 48, 16, 22)
    for k, v in change.items():
        setattr(cfg, k, v)
    with pytest.raises(NotImplementedError):
        Encoder(cfg, device="cpu")


def test_unported_structures_raise():
    """Low-delay P frames and B pyramids are ported (one or more
    references on the fixed grid, variable trees with one per list), and
    so are tiles and slices, scaling lists, SMP and TMVP; selective
    encryption on a B pyramid (fixed grid), on one of variable trees,
    with SMP, with TMVP and on IPPP still raises."""
    for change, match in ((dict(gop_len=8, crypto="k"),
                           "selective encryption"),
                          (dict(intra_min_cu=8, inter_min_cu=8, gop_len=8,
                                crypto="k"), "selective encryption"),
                          (dict(smp=True, crypto="k"),
                           "selective encryption"),
                          (dict(tmvp=True, crypto="k"),
                           "selective encryption"),
                          (dict(crypto="k"), "selective encryption")):
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


@pytest.mark.parametrize("flags", [["--preset", "medium", "--crypto",
                                    "k"],
                                   ["--preset", "medium", "--period",
                                    "1", "--source-scan-type", "tff"],
                                   ["--period", "1", "--crypto", "k"]])
def test_cli_rejects_unported_configs(tmp_path, flags):
    from kvazaar_tpu_torch import cli
    src = tmp_path / "in.yuv"
    src.write_bytes(bytes(64 * 48 * 3 // 2))
    with pytest.raises(NotImplementedError):
        cli.main(["-i", str(src), "--input-res", "64x48", "-o",
                  str(tmp_path / "out.hevc"), "--device", "cpu", *flags])
