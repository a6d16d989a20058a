"""SMP/AMP inter partitions and TMVP on the port == the JAX package's,
byte for byte.

Streams against JAX, one test per JAX reference stream: kvazaar_tpu_torch's
public ``Encoder`` on CPU tensors against kvazaar_tpu's on its CPU
backend, each picture's bytes, FrameInfo and reconstruction equal, and
the JAX oracle decoder turning the port's stream back into the port's
reconstruction (after ``tests/test_smp.py`` and ``tests/test_tmvp.py``):

(a) SMP IPPP at cu 16 on test_smp.py's half-plane clip, pipelined;
(b) AMP IPPP at cu 32 on its band clip, with RDOQ and sign hiding (an
    IDR and a P frame);
(c) SMP at cu 32 with ``--bitrate`` (rate control at frame level, a frame
    encoder per QP: the config turns per-CTU QP off with SMP), an IDR
    and a P frame at two QPs;
(d) TMVP IPPP at cu 16;
(e) TMVP with ``lp-g4d2t1 --ref 4`` and an IDR every 5 frames (the
    collocated motion resets there).

The SMP streams code non-square partitions (part8 > 0), the AMP stream
asymmetric ones (part8 >= 4).  Streams held to the oracle alone (no JAX
compile): SMP with 10-bit, a scaling list, SAO, ``--slices wpp`` and an
MD5 SEI; SMP lossless; the CLI's ``--smp --amp``.  And the configs the
JAX config refuses still raise ValueError.
"""

import dataclasses

import numpy as np
import pytest
import torch

import kvazaar_tpu.api as japi
from kvazaar_tpu.bitstream.decoder import _motion_of as jax_motion_of
from kvazaar_tpu.config import Config as JaxConfig
from kvazaar_tpu.encoder.frame_encoder import \
    compute_bs_maps_smp as jax_bs_maps_smp
from kvazaar_tpu_torch import Config
from kvazaar_tpu_torch.api import Encoder
from kvazaar_tpu_torch.bitstream.decoder import _motion_of
from kvazaar_tpu_torch.encoder import frame_encoder as tfe
from test_smp import _band_clip
from test_smp import _clip as _split_clip
from test_torch_slice import _clip, oracle_decode

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

# Small CPU shapes: one intra-op thread each, so that the xdist
# workers sharing the cores do not oversubscribe them.
torch.set_num_threads(1)


def _oracle_equals_recon(enc, got, frames):
    """The oracle decodes the port's stream back to the port's recon."""
    dec = oracle_decode(b"".join(r[0] for r in got), enc._intra.params)
    assert len(dec) == len(frames)
    h, w = frames[0][0].shape
    for ((dy, dcb, dcr), _fd), (_c, info, rec) in zip(dec, got):
        for d, r in zip((dy[:h, :w], dcb[:h // 2, :w // 2],
                         dcr[:h // 2, :w // 2]), rec):
            np.testing.assert_array_equal(d, r, err_msg=f"POC {info.poc}")


def _marked_frame_data(enc):
    """The FrameData of every picture enc codes, in coding order."""
    fds = []
    marked = enc._ckpt.mark_frame

    def mark(*a):
        fds.append(a[-1])
        return marked(*a)

    enc._ckpt.mark_frame = mark
    return fds


def _same(got, want):
    assert len(got) == len(want)
    for i, ((gc, gi, gr), (wc, wi, wr)) in enumerate(zip(got, want)):
        assert gc == wc, f"picture {i}: bytes differ"
        assert dataclasses.astuple(gi) == dataclasses.astuple(wi), i
        for a, b in zip(gr, wr):
            np.testing.assert_array_equal(a, b, err_msg=f"picture {i}")


# The JAX package's compiled I-frame program of the cu 16 QP 30 streams
# (a), (d) and (e): their I frames are configured alike, so one compile
# serves the three (a wrong share would show as a byte mismatch).
_JAX_I_PROGRAMS = {}


def _stream(kw, frames, pipelined):
    """The port's and the JAX package's pictures of Config(**kw), equal
    picture by picture, and the oracle decode of the port's stream equal
    to its recon.  Returns (port encoder, port results, the part8 grids
    of its pictures)."""
    enc = Encoder(Config(**kw), device="cpu")
    jenc = japi.Encoder(JaxConfig(**kw))
    if (kw["intra_max_cu"], kw["qp"], kw.get("rdoq")) == (16, 30, None):
        ife = jenc._intra
        ife._device_encode_batch = _JAX_I_PROGRAMS.setdefault(
            (kw["width"], kw["height"]), ife._device_encode_batch)
    assert enc.can_pipeline() == pipelined
    fds = _marked_frame_data(enc)
    got = list(enc.encode_stream(frames, need_recon=True))
    _same(got, list(jenc.encode_stream(frames, need_recon=True)))
    _oracle_equals_recon(enc, got, frames)
    return enc, got, [fd.part8 for fd in fds]


def test_smp_cu16_stream_matches_jax():
    """(a) SMP on the half-plane clip: pipelined, per frame the same."""
    kw = dict(width=64, height=64, qp=30, intra_period=0, intra_min_cu=16,
              intra_max_cu=16, smp=True)
    frames = _split_clip(3, 64, 64)
    _enc, got, parts = _stream(kw, frames, pipelined=True)
    assert sum(int((p > 0).sum()) for p in parts) > 0
    per_frame = Encoder(Config(**kw), device="cpu")
    assert [r[0] for f in frames for r in per_frame.encode(*f)] == \
        [g[0] for g in got]


def test_amp_rdoq_signhide_stream_matches_jax():
    """(b) AMP at cu 32 on the band clip, with RDOQ and sign hiding (the
    kernel's TQ instance on a card)."""
    kw = dict(width=64, height=64, qp=30, intra_period=0, intra_min_cu=32,
              intra_max_cu=32, smp=True, amp=True, rdoq=True,
              signhide=True)
    _enc, _got, parts = _stream(kw, _band_clip(2, 64, 64), pipelined=True)
    assert sum(int((p >= 4).sum()) for p in parts) > 0


def test_smp_bitrate_stream_matches_jax():
    """(c) SMP at cu 32 with --bitrate: frame-level rate control, a frame
    encoder per QP (SMP turns cu_qp_delta off)."""
    kw = dict(width=64, height=64, qp=30, intra_period=0, intra_min_cu=32,
              intra_max_cu=32, smp=True, bitrate=150000)
    assert not Config(**kw).cu_qp_delta_active
    enc, got, parts = _stream(kw, _split_clip(2, 64, 64, seed=5),
                              pipelined=False)
    assert [g[1].qp for g in got] == [27, 24]
    assert sum(int((p > 0).sum()) for p in parts) > 0


def test_tmvp_ippp_stream_matches_jax():
    """(d) TMVP IPPP at cu 16: the multi-reference stream shape with one
    reference, temporal candidates from the previous picture."""
    kw = dict(width=64, height=64, qp=30, intra_period=0, intra_min_cu=16,
              intra_max_cu=16, tmvp=True)
    enc, _got, _parts = _stream(kw, _clip(3, 64, 64, seed=3),
                                pipelined=False)
    col = enc._motion_ld[2]
    assert col["inter"].any() and col["poc"] == 2


def test_tmvp_lp_gop_idr_stream_matches_jax():
    """(e) TMVP with lp-g4d2t1 --ref 4 and an IDR at frame 5: after the
    IDR the collocated motion starts again from nothing."""
    kw = dict(width=64, height=64, qp=30, intra_period=5, intra_min_cu=16,
              intra_max_cu=16, tmvp=True, lp_gop=(4, 2, 1), ref_frames=4)
    enc, got, _parts = _stream(kw, _clip(8, 64, 64, seed=3),
                               pipelined=False)
    assert [g[1].slice_type for g in got] == [2, 1, 1, 1, 1, 2, 1, 1]
    assert set(enc._motion_ld) <= {0, 1, 2}


def test_motion_of_matches_jax():
    """The copied _motion_of on a two-reference P picture's FrameData
    (its ref8 grid seeded)."""
    kw = dict(width=64, height=64, qp=30, intra_period=0, intra_min_cu=16,
              intra_max_cu=16, ref_frames=2)
    enc = Encoder(Config(**kw), device="cpu")
    fds = _marked_frame_data(enc)
    for f in _clip(3, 64, 64, seed=3):
        enc.encode(*f)
    fd = fds[2]
    assert fd.inter8.any()
    # Seeded reference indices, so both of the picture's POCs show.
    fd.ref8[:] = np.random.default_rng(7).integers(0, 2, fd.ref8.shape)
    got = _motion_of(fd, enc._intra.params, 2, [1, 2])
    want = jax_motion_of(fd, enc._intra.params, 2, [1, 2])
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("part", [1, 2, 6])
def test_bs_maps_smp_match_jax(part):
    """compute_bs_maps_smp on seeded 8-cell fields (cu 32)."""
    rng = np.random.default_rng(part)
    by, bx, cells = 3, 4, 4
    inter = rng.random((by, bx)) < 0.7
    cbf = rng.random((by, bx)) < 0.3
    parts = np.where(rng.random((by, bx)) < 0.6, part, 0).astype(np.int32)
    mv = rng.integers(-6, 7, (by * cells, bx * cells, 2)).astype(np.int32)
    up = [np.kron(a, np.ones((cells, cells), a.dtype))
          for a in (inter, cbf, parts)]
    want = jax_bs_maps_smp(*up[:2], mv, 32, part8=up[2])
    got = tfe.compute_bs_maps_smp(*(torch.from_numpy(a) for a in up[:2]),
                                  torch.from_numpy(mv), 32,
                                  torch.from_numpy(up[2]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", ["tenbit-sl-sao-wpp-md5", "lossless"])
def test_smp_tool_streams_decode_to_recon(case):
    """Held to the oracle alone: SMP with 10-bit, the default scaling
    list, SAO (on the I frame), --slices wpp (the Python serializer) and
    an MD5 SEI; SMP lossless (the recon is the source)."""
    kw = dict(width=64, height=64, qp=30, intra_period=0, intra_min_cu=16,
              intra_max_cu=16, smp=True)
    frames = _split_clip(3, 64, 64)
    if case == "lossless":
        kw.update(lossless=True)
    else:
        kw.update(input_bitdepth=10, scaling_list="default", sao=True,
                  slices="wpp", hash="md5")
        frames = [tuple(p.astype(np.uint16) * 4 + 1 for p in f)
                  for f in frames]
    enc = Encoder(Config(**kw), device="cpu")
    fds = _marked_frame_data(enc)
    got = list(enc.encode_stream(frames, need_recon=True))
    assert sum(int((fd.part8 > 0).sum()) for fd in fds) > 0
    _oracle_equals_recon(enc, got, frames)
    if case == "lossless":
        for (_c, _i, rec), f in zip(got, frames):
            for r, s in zip(rec, f):
                np.testing.assert_array_equal(r, s)


def test_smp_amp_cli_encodes(tmp_path):
    """The CLI's --smp --amp (cu 32 IPPP) writes what Encoder.encode_stream
    yields for the Config its flags build, and the oracle decodes it."""
    from kvazaar_tpu_torch import cli
    frames = _band_clip(3, 64, 64)
    src = tmp_path / "in.yuv"
    src.write_bytes(b"".join(p.tobytes() for f in frames for p in f))
    argv = ["-i", str(src), "--input-res", "64x64", "-o",
            str(tmp_path / "out.hevc"), "-q", "30", "--period", "0",
            "--device", "cpu", "--no-psnr", "--smp", "--amp",
            "--set", "gop=0", "--set", "intra-min-cu=32",
            "--set", "intra-max-cu=32", "--set", "inter-min-cu=32",
            "--set", "inter-max-cu=32"]
    assert cli.main(argv) == 0
    cfg = cli.config_from_args(cli.build_argparser().parse_args(argv))
    assert (cfg.smp, cfg.amp, cfg.intra_max_cu) == (True, True, 32)
    enc = Encoder(cfg, device="cpu")
    got = list(enc.encode_stream(frames, need_recon=True))
    assert (tmp_path / "out.hevc").read_bytes() == \
        b"".join(c for c, _, _ in got)
    _oracle_equals_recon(enc, got, frames)


@pytest.mark.parametrize("kw", [
    dict(smp=True, ref_frames=2), dict(smp=True, lp_gop=(4, 1, 1)),
    dict(smp=True, tmvp=True), dict(smp=True, gop_len=8),
    dict(smp=True, intra_min_cu=8, intra_max_cu=8),
    dict(smp=True, intra_min_cu=8, intra_max_cu=32),
    dict(smp=True, tiles_x=2), dict(smp=True, aq=1.0),
    dict(amp=True), dict(smp=True, amp=True, intra_min_cu=16,
                         intra_max_cu=16),
    dict(tmvp=True, gop_len=8), dict(tmvp=True, aq=1.0)],
    ids=["smp-ref2", "smp-lpgop", "smp-tmvp", "smp-gop8", "smp-cu8",
         "smp-var", "smp-tiles", "smp-aq", "amp-no-smp", "amp-cu16",
         "tmvp-gop8", "tmvp-aq"])
def test_refused_configs_raise(kw):
    """What the JAX config refuses, the port's copy refuses the same way
    (ValueError), and the Encoder with it."""
    base = dict(width=64, height=64, qp=30, intra_period=0, intra_min_cu=32,
                intra_max_cu=32)
    base.update(kw)
    with pytest.raises(ValueError):
        JaxConfig(**base).validate()
    with pytest.raises(ValueError):
        Encoder(Config(**base), device="cpu")


def test_smp_and_tmvp_are_ported():
    """No accepted SMP/AMP or TMVP config is listed as unsupported."""
    for kw in (dict(smp=True), dict(smp=True, amp=True),
               dict(tmvp=True), dict(tmvp=True, lp_gop=(4, 2, 1),
                                     ref_frames=4, tiles_x=2)):
        cfg = Config(width=128, height=64, qp=30, intra_period=0,
                     intra_min_cu=32, intra_max_cu=32, **kw).validate()
        assert tfe.unsupported(cfg) == []
        assert not tfe.var_inter(cfg)
