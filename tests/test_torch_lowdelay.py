"""The port's low-delay default operating points == the JAX encoder's.

kvazaar_tpu_torch (CPU tensors, plain paths) against kvazaar_tpu (CPU
backend, jitted) with tolerance 0:

- ``mc_planes`` with stacked references and a per-block reference index,
  and the multi-reference P decision of one frame against 2 references
  (the JAX encoder's fused P program): ref_sel, MVs, inter map, levels
  and reconstruction;
- the multi-reference merge and AMVP candidate lists (copies of the JAX
  module's functions) on seeded random motion fields;
- whole streams through the public ``Encoder``: the ultrafast (low-delay
  GOP lp-g4d4t1, a QP offset per position), veryfast (SAO on the I
  frame only) and fast (variable-tree I frame, 2 references, P frames on
  the fixed cu 32 grid) presets at their defaults, ``Config()`` (fixed
  cu 32, IPPP) and plain IPPP with SAO at cu 16: bytes, reconstruction
  and each frame's QP equal to the JAX ``Encoder``'s; encode_stream ==
  encode; the JAX oracle decoder turns one low-delay GOP stream and the
  cu 32 stream into the port's reconstruction;
- stream options on these paths (md5 hash, AUD with the VPS re-sent at
  every IRAP, a frame size that is not a multiple of the CU, 4:0:0, WPP
  off), and the CLI with no structure flags (the ultrafast preset);
- the gates: the low-delay presets' defaults, Config() and 3 references
  pass them, and TMVP on them; selective encryption still raises.

Each JAX reference stream is encoded once per process (cached) and only
by the tests that compare against it (the others take the port's
stream alone); frames are small because each QP of a low-delay GOP
compiles its own JAX P program.  The fast case's I frame runs the
JAX SAO program compiled once per process for every SAO test of the
port (``test_torch_sao.share_sao_program``, one 96x96 frame shape).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvazaar_tpu.api import Encoder as JaxEncoder
from kvazaar_tpu.config import Config as JaxConfig
from kvazaar_tpu.config import config_from_preset as jax_preset
from kvazaar_tpu.encoder import inter_cands as jcands
from kvazaar_tpu.encoder.frame_encoder import \
    IntraFrameEncoder as JaxIntraFrameEncoder
from kvazaar_tpu.encoder.inter_search import mc_planes as jax_mc_planes
from kvazaar_tpu_torch import Config
from kvazaar_tpu_torch.api import Encoder, _unsupported_structure
from kvazaar_tpu_torch.config import config_from_preset
from kvazaar_tpu_torch.encoder import inter_cands as tcands
from kvazaar_tpu_torch.encoder.frame_encoder import (IntraFrameEncoder,
                                                    unsupported)
from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
from kvazaar_tpu_torch.encoder.inter_search import mc_planes
from test_torch_sao import share_sao_program
from test_torch_slice import _clip, _jit_whole, oracle_decode

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

# Small CPU shapes: one intra-op thread each, so that the xdist
# workers sharing the cores do not oversubscribe them.
torch.set_num_threads(1)

QP = 27

# name -> (width, height, frames, config fields, preset or None).  The
# SAO streams are 96x96, the frame shape of the shared JAX SAO program.
STREAMS = {
    "ultrafast": (64, 48, 6, {}, "ultrafast"),
    "veryfast": (96, 96, 6, {}, "veryfast"),
    "fast": (96, 96, 3, {}, "fast"),
    "config": (96, 64, 3, {}, None),
    "ippp-sao-cu16": (96, 96, 3, dict(intra_period=0, sao=True,
                                      intra_min_cu=16, intra_max_cu=16),
                      None),
}

# Stream options on these paths: name -> (base stream, field changes).
OPTIONS = {
    "md5": ("ultrafast", dict(hash="md5")),
    "aud-vps1-period2": ("ultrafast", dict(aud=True, vps_period=1,
                                           intra_period=2)),
    "72x40": ("config", dict(width=72, height=40)),
    "400": ("config", dict(chroma_format=400)),
    "no-wpp": ("config", dict(wpp=False)),
}


def _configs(base, changes=None):
    """(JAX config, port config) of a stream case with field changes."""
    w, h, _n, fields, preset = STREAMS[base]
    kw = dict(width=w, height=h, qp=QP, **fields)
    kw.update(changes or {})
    if preset is None:
        return JaxConfig(**kw), Config(**kw)
    return jax_preset(preset, **kw), config_from_preset(preset, **kw)


def _frames(base, changes=None):
    w, h, n, _fields, _preset = STREAMS[base]
    kw = changes or {}
    w, h = kw.get("width", w), kw.get("height", h)
    frames = _clip(n if not changes else 3, w, h, seed=w + h)
    if kw.get("chroma_format") == 400:
        frames = [(y, None, None) for y, _cb, _cr in frames]
    return frames


def _encode(enc, frames):
    out = []
    for f in frames:
        out += enc.encode(*f)
    return out + enc.flush()


@functools.lru_cache(maxsize=None)
def _port_stream(base, option=None):
    """(frames, port results, port config) of one case, each result a
    list of (chunk, FrameInfo, recon)."""
    changes = OPTIONS[option][1] if option else None
    port_cfg = _configs(base, changes)[1]
    frames = _frames(base, changes)
    return frames, _encode(Encoder(port_cfg, device="cpu"), frames), \
        port_cfg


# The JAX Encoder of each base stream that ran in this process, and the
# options that change host-side fields only (the hash SEI, AUD, VPS and
# IDR periods, WPP): their frame encoders can run the base's compiled I
# and P programs of the same QP.
_JAX_BASE_ENCODERS = {}
_HOST_SIDE_OPTIONS = ("md5", "aud-vps1-period2", "no-wpp")


def _share_programs(jax_enc, donor):
    """Point jax_enc's frame encoders (one per QP, made at first use) at
    donor's compiled I and P programs of the same QP (a wrong share
    would show as a byte mismatch)."""
    def link(enc, qp):
        if qp in donor._encoders:
            enc._device_encode_batch = donor._encoders[qp]._device_encode_batch
            enc._p_fused_cache = donor._encoders[qp]._p_fused_cache

    link(jax_enc._intra, jax_enc.cfg.qp)
    make = jax_enc._encoder_for_qp

    def encoder_for_qp(qp):
        fresh = qp not in jax_enc._encoders
        enc = make(qp)
        if fresh:
            link(enc, qp)
        return enc

    jax_enc._encoder_for_qp = encoder_for_qp


@functools.lru_cache(maxsize=None)
def _jax_stream(base, option=None):
    """The JAX Encoder's results of one case (the expensive part: its
    compiles), for the tests that compare against it."""
    changes = OPTIONS[option][1] if option else None
    jax_cfg = _configs(base, changes)[0]
    jax_enc = JaxEncoder(jax_cfg)
    if jax_cfg.sao:
        share_sao_program(jax_enc._intra)
    if option is None:
        _JAX_BASE_ENCODERS[base] = jax_enc
    elif option in _HOST_SIDE_OPTIONS and base in _JAX_BASE_ENCODERS:
        _share_programs(jax_enc, _JAX_BASE_ENCODERS[base])
    return _encode(jax_enc, _frames(base, changes))


def _same_streams(got, want):
    assert len(got) == len(want)
    for i, ((gc, gi, gr), (wc, wi, wr)) in enumerate(zip(got, want)):
        assert gc == wc, f"frame {i}: chunks differ"
        for f in ("poc", "qp", "nal_type", "slice_type", "bits"):
            assert getattr(gi, f) == getattr(wi, f), (i, f)
        for a, b in zip(gr, wr):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f"frame {i}")


def _eq(got, want, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def test_mc_planes_with_stacked_references_matches_jax():
    """Each block gathers its luma and chroma prediction from its own
    reference of a (R, H, W) stack, with MVs up to 16 pixels out."""
    rng = np.random.default_rng(3)
    plan = make_intra_plan(64, 48, 16, chroma=True)
    shape = (plan.blocks_y, plan.blocks_x)
    refs = [rng.integers(0, 256, (3, 48 // d, 64 // d)).astype(np.int32)
            for d in (1, 2, 2)]
    mv = rng.integers(-64, 65, shape + (2,)).astype(np.int32)
    ref_grid = rng.integers(0, 3, shape).astype(np.int32)
    want = _jit_whole(jax_mc_planes)(*(jnp.asarray(r) for r in refs),
                                     jnp.asarray(mv), plan, 8,
                                     ref_grid=jnp.asarray(ref_grid))
    got = mc_planes(*(torch.from_numpy(r) for r in refs),
                    torch.from_numpy(mv), plan, 8,
                    ref_grid=torch.from_numpy(ref_grid))
    for g, w, n in zip(got, want, ("y", "cb", "cr")):
        _eq(g, w, n)


def test_multiref_p_decision_matches_jax():
    """One P frame against 2 references (the previous frame with a patch
    of noise, so that blocks there pick the older one): the JAX fused P
    program's modes, inter map, ref_sel, MVs, levels, deblocked recon
    and SSEs == the port's device program's."""
    w, h = 64, 48
    frames = _clip(3, w, h, seed=9)
    rng = np.random.default_rng(9)
    ref0 = tuple(p.copy() for p in frames[1])
    ref0[0][8:40, 24:56] = rng.integers(0, 256, (32, 32))
    refs = (ref0, frames[0])
    kw = dict(width=w, height=h, qp=QP, intra_min_cu=16, intra_max_cu=16,
              intra_period=0, ref_frames=2)
    jax_enc = JaxIntraFrameEncoder(JaxConfig(**kw))
    planes = [tuple(jnp.asarray(p) for p in f) for f in (frames[2],) + refs]
    packed, dense, recs = jax_enc._p_fused_fns(2)(
        *planes[0], *(jnp.stack([r[k] for r in planes[1:]])
                      for k in range(3)))
    lv, modes, inter_map, ref_sel, mv, sses, _part, _mv_pu = \
        jax_enc._p_unpack(np.asarray(packed), dense)

    port = IntraFrameEncoder(Config(**kw), device="cpu")
    src = [torch.from_numpy(p.astype(np.int32)) for p in frames[2]]
    got = port._p_from_planes(*src, [tuple(torch.from_numpy(p) for p in r)
                                     for r in refs])
    g_modes, g_inter, g_ref, g_mv, g_lv, g_recs, g_sses, _part, _mv_pu = \
        got
    assert 0 < ref_sel.sum() < inter_map.sum()   # both references used
    _eq(g_modes, modes, "modes")
    _eq(g_inter, inter_map, "inter map")
    _eq(g_ref, ref_sel, "ref_sel")
    _eq(g_mv, mv, "mv")
    for g, r, n in zip(g_lv, lv, ("y", "cb", "cr")):
        _eq(g.to(torch.int32), r, f"levels {n}")
    for g, r, n in zip(g_recs, recs, ("y", "cb", "cr")):
        _eq(g, r, f"recon {n}")
    _eq(g_sses.host()[0], sses, "sses")


@pytest.mark.parametrize("nref", [2, 3])
def test_multiref_candidates_match_jax(nref):
    """merge_list_p_multiref_at / amvp_pair_p_multiref_at (and the
    single-reference scalar lists) of every block of seeded random
    motion fields, drawn from a few values so that the lists prune."""
    rng = np.random.default_rng(nref)
    plan = make_intra_plan(128, 96, 16, chroma=False)
    shape = (plan.blocks_y, plan.blocks_x)
    ref_pocs = [7 - d for d in (1, 4, 5)[:nref]]
    for _ in range(4):
        inter = rng.random(shape) < 0.7
        refs = rng.integers(0, nref, shape).astype(np.int32)
        mv = rng.choice([-9, -4, 0, 3, 8], shape + (2,)).astype(np.int32)
        for by in range(shape[0]):
            for bx in range(shape[1]):
                args = (inter, refs, mv, plan.avail, by, bx)
                assert (tcands.merge_list_p_multiref_at(
                    *args, nref, ref_pocs=ref_pocs, cu=16)
                    == jcands.merge_list_p_multiref_at(
                        *args, nref, ref_pocs=ref_pocs, cu=16))
                for tgt in range(nref):
                    assert (tcands.amvp_pair_p_multiref_at(
                        *args, tgt, 7, ref_pocs, cu=16)
                        == jcands.amvp_pair_p_multiref_at(
                            *args, tgt, 7, ref_pocs, cu=16))
                one = (inter, mv, plan.avail, by, bx)
                assert tcands.merge_list_at(*one) == \
                    jcands.merge_list_at(*one)
                assert tcands.amvp_pair_at(*one) == \
                    jcands.amvp_pair_at(*one)
    for v in ((13, -7), (-200, 95), (0, 1)):
        for tb, td in ((1, 4), (2, 3), (-3, 5), (4, 1)):
            assert tcands._mv_scale(v, tb, td) == jcands._mv_scale(v, tb,
                                                                   td)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_stream_matches_jax(name):
    """Chunks (AU prefix + slice NAL), every FrameInfo field but the
    PSNRs, and the reconstruction == the JAX Encoder's, frame by frame."""
    frames, got, _cfg = _port_stream(name)
    _same_streams(got, _jax_stream(name))
    kinds = [i.slice_type for _c, i, _r in got]
    assert kinds == [2] + [1] * (len(frames) - 1)
    if name in ("ultrafast", "veryfast"):
        # lp-g4d4t1: QP offsets 4, 3, 4, 1 by position.
        assert [i.qp for _c, i, _r in got] == [27, 31, 30, 31, 28, 31]


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_encode_stream_matches_encode(name):
    """The public encode_stream yields encode's chunks and infos; it is
    pipelined only for streams without multi-reference structure and
    without SAO."""
    frames, got, cfg = _port_stream(name)
    enc = Encoder(cfg, device="cpu")
    assert enc.can_pipeline() == (name == "config")
    out = list(enc.encode_stream(frames, need_recon=True))
    assert [o[0] for o in out] == [g[0] for g in got]
    assert [o[1].qp for o in out] == [g[1].qp for g in got]
    for (_c, oi, orec), (_gc, gi, grec) in zip(out, got):
        np.testing.assert_array_equal(orec[0], grec[0])
        assert oi.psnr_y == pytest.approx(gi.psnr_y, abs=1e-9)


def test_sao_runs_on_i_frames_only():
    """veryfast: the I frame codes SAO parameters and its post-SAO
    reconstruction is the reference; the P frame (QP 31 at position 1)
    codes SAO off in every CTU, and its slice is the stream's."""
    frames, got, cfg = _port_stream("veryfast")
    ife = IntraFrameEncoder(cfg, device="cpu")
    idr = ife.encode_frame(*frames[0])
    assert idr.frame_data.sao_type.any()
    np.testing.assert_array_equal(ife._dpb[0].numpy(), idr.recon_y)
    np.testing.assert_array_equal(idr.recon_y, got[0][2][0])
    p_enc = IntraFrameEncoder(dataclasses.replace(cfg, qp=31),
                              device="cpu")
    p_enc.params.qp = cfg.qp
    res, _recs = p_enc.encode_p_frame_multi(*frames[1], poc=1,
                                            refs=[(0, ife._dpb)])
    assert not res.frame_data.sao_type.any()
    assert got[1][0].endswith(res.nals)


@pytest.mark.parametrize("name", ["ultrafast", "config"])
def test_oracle_decoder_reproduces_port_recon(name):
    _frames_, got, cfg = _port_stream(name)
    port = IntraFrameEncoder(cfg, device="cpu")
    dec = oracle_decode(b"".join(c for c, _i, _r in got), port.params)
    assert len(dec) == len(got)
    for ((dy, dcb, dcr), _fd), (_c, _i, (ry, rcb, rcr)) in zip(dec, got):
        h, w = ry.shape
        np.testing.assert_array_equal(dy[:h, :w], ry)
        np.testing.assert_array_equal(dcb[:h // 2, :w // 2], rcb)
        np.testing.assert_array_equal(dcr[:h // 2, :w // 2], rcr)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_stream_options_match_jax(option):
    base = OPTIONS[option][0]
    _same_streams(_port_stream(base, option)[1], _jax_stream(base, option))


def test_cli_with_no_structure_flags_writes_the_ultrafast_stream(tmp_path):
    """python -m kvazaar_tpu_torch with no preset or structure flag
    encodes the ultrafast preset's low-delay GOP: the bytes the JAX
    Encoder writes for config_from_preset("ultrafast")."""
    from kvazaar_tpu_torch import cli
    frames = _port_stream("ultrafast")[0]
    want = _jax_stream("ultrafast")
    src = tmp_path / "in.yuv"
    src.write_bytes(b"".join(p.tobytes() for f in frames[:4] for p in f))
    out = tmp_path / "out.hevc"
    assert cli.main(["-i", str(src), "--input-res", "64x48", "-o",
                     str(out), "-q", str(QP), "--device", "cpu",
                     "--no-psnr"]) == 0
    assert out.read_bytes() == b"".join(c for c, _i, _r in want[:4])


@pytest.mark.parametrize("name", ["ultrafast", "superfast", "veryfast",
                                  "faster", "fast", "Config()",
                                  "ref_frames=3"])
def test_low_delay_defaults_pass_the_gates(name):
    if name == "Config()":
        cfg = Config(width=64, height=64)
    elif name == "ref_frames=3":
        cfg = Config(width=64, height=64, intra_period=0, ref_frames=3)
    else:
        cfg = config_from_preset(name, width=64, height=64)
    cfg.validate()
    assert unsupported(cfg) == []
    assert _unsupported_structure(cfg) == []


@pytest.mark.parametrize("name,match", [
    pytest.param("medium", "selective encryption",
                 id="medium-GOP structures"),
    pytest.param("ultrafast --gop 0", "selective encryption",
                 id="ultrafast --gop 0-variable P/B CU trees"),
    pytest.param("tmvp", "selective encryption", id="tmvp-TMVP")])
def test_what_stays_unported_raises(name, match):
    """On the B pyramids that are ported (the medium default; the
    ultrafast preset's trees with --gop 0 and a GOP of 8) and on the
    ultrafast default with TMVP (ported), selective encryption still
    raises."""
    if name == "medium":
        cfg = config_from_preset("medium", width=64, height=64,
                                 crypto="k")
    elif name == "tmvp":
        cfg = config_from_preset("ultrafast", width=64, height=64,
                                 tmvp=True, crypto="k")
    else:
        cfg = config_from_preset("ultrafast", width=64, height=64,
                                 lp_gop=None, gop_len=8, intra_period=0,
                                 crypto="k")
    with pytest.raises(NotImplementedError, match=match):
        Encoder(cfg, device="cpu")
