"""Tiles and slices (--tiles, --slices) on the port == the JAX package's,
byte for byte.

Streams, one test per JAX reference stream: kvazaar_tpu_torch's public
``Encoder`` on CPU tensors against kvazaar_tpu's on its CPU backend, each
picture's bytes, FrameInfo and reconstruction equal, and the JAX oracle
decoder turning the port's stream back into the port's reconstruction
(after ``tests/test_tiles.py`` and ``tests/test_slices.py``):

(a) all-intra 128x128 QP 30, fixed cu 16, tiles 2x2, SAO on (the host
    decision, whose merges stop at tile boundaries), pipelined;
(b) 320x64 tiles 3x1: 5 CTU columns in uniform-spacing tiles of 1, 2
    and 2;
(c) IPPP 192x128 tiles 2x2 + WPP: one substream per CTU row of each
    tile (the entry points counted);
(d) --slices tiles: IPPP 192x128, tiles 2x1, WPP off, an independent
    slice per tile;
(e) --slices wpp: IPPP 128x192, the CTU rows as dependent slice
    segments; and the medium preset's variable tree at --period 1;
(f) a fixed-grid GOP-4 B pyramid with tiles 2x2;
(g) Config()'s cu 32 grid at 10-bit with tiles 2x2, all-intra; and a
    lossless all-intra stream with tiles 2x1.

Tiles and slices go to the Python serializer in both packages (the
native CABAC has no tile mode).  Also: the wavefront reconstruction's
plain version (the CUDA kernel's twin, held against it on the card by
``chip_smoke.py``) on tiled plans against JAX's; the copied host SAO
decision against JAX's on seeded statistics with tile maps; the
kernel's tile tables (a ring per tile, 3 rows deep where one ring over
a tiled frame needs 12..16); and the gates.
"""

import dataclasses

import numpy as np
import pytest
import torch

import kvazaar_tpu.api as japi
from kvazaar_tpu.config import Config as JaxConfig
from kvazaar_tpu.config import config_from_preset as jax_preset
from kvazaar_tpu.encoder.intra_recon import \
    reconstruct_frames as jax_reconstruct_frames
from kvazaar_tpu.ops import sao as jsao
from kvazaar_tpu_torch import Config
from kvazaar_tpu_torch.api import Encoder
from kvazaar_tpu_torch.cli import build_argparser, config_from_args
from kvazaar_tpu_torch.config import config_from_preset
from kvazaar_tpu_torch.encoder import frame_encoder as tfe
from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
from kvazaar_tpu_torch.encoder.intra_recon import reconstruct_frames
from kvazaar_tpu_torch.ops import sao as tsao
from kvazaar_tpu_torch.ops import wavefront
from test_torch_slice import _clip, _jit_whole, oracle_decode

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

# Small CPU shapes: one intra-op thread each, so that the xdist
# workers sharing the cores do not oversubscribe them.
torch.set_num_threads(1)


def _same(got, want):
    assert len(got) == len(want)
    for i, ((gc, gi, gr), (wc, wi, wr)) in enumerate(zip(got, want)):
        assert gc == wc, f"picture {i}: bytes differ"
        assert dataclasses.astuple(gi) == dataclasses.astuple(wi), i
        for a, b in zip(gr, wr):
            np.testing.assert_array_equal(a, b, err_msg=f"picture {i}")


def _stream(kw, frames, preset=None, pipelined=True):
    """The port's and the JAX package's pictures of one config (a Config
    or a preset with keyword overrides), equal picture by picture, and
    the oracle decode of the port's stream equal to its recon.  Returns
    (port encoder, port results)."""
    if preset is None:
        enc, jenc = (Encoder(Config(**kw), device="cpu"),
                     japi.Encoder(JaxConfig(**kw)))
    else:
        enc = Encoder(config_from_preset(preset, **kw), device="cpu")
        jenc = japi.Encoder(jax_preset(preset, **kw))
    assert enc.can_pipeline() == pipelined
    got = list(enc.encode_stream(frames, need_recon=True))
    _same(got, list(jenc.encode_stream(frames, need_recon=True)))
    dec = oracle_decode(b"".join(r[0] for r in got), enc._intra.params)
    assert len(dec) == len(frames)
    h, w = frames[0][0].shape
    for ((dy, dcb, dcr), _fd), (_c, info, rec) in zip(dec, got):
        for d, r in zip((dy[:h, :w], dcb[:h // 2, :w // 2],
                         dcr[:h // 2, :w // 2]), rec):
            np.testing.assert_array_equal(d, r, err_msg=f"POC {info.poc}")
    return enc, got


def _slices(stream: bytes) -> int:
    """Slice segment NAL units (VCL, nal_unit_type < 32) of an Annex-B
    stream."""
    return sum((nal[0] >> 1) & 63 < 32
               for nal in stream.split(b"\x00\x00\x01")[1:])


def test_tiles_intra_sao_stream_matches_jax():
    """(a) tests/test_tiles.py's 128x128 all-intra stream with tiles 2x2
    and SAO: the statistics on the device, the decision on the host with
    its merges cut at the tile boundaries, the filter on the device."""
    frames = _clip(2, 128, 128, seed=41)
    enc, got = _stream(dict(width=128, height=128, qp=30, intra_period=1,
                            intra_max_cu=16, intra_min_cu=16, wpp=False,
                            tiles_x=2, tiles_y=2, sao=True, hash="md5"),
                       frames)
    p = enc._intra.params
    assert p.tiles_enabled and p.sao_enabled
    assert not enc._intra._native_cabac()
    assert enc._intra.plan.tiles == (2, 2)


def test_tiles_nonuniform_columns_stream_matches_jax():
    """(b) 320x64 (5 CTU columns) in 3 tile columns of 1, 2 and 2 CTUs
    (7.4.3.3.1's uniform spacing)."""
    frames = _clip(1, 320, 64, seed=42)
    enc, _got = _stream(dict(width=320, height=64, qp=32, intra_period=1,
                             intra_max_cu=16, intra_min_cu=16, wpp=False,
                             tiles_x=3, tiles_y=1, hash="md5"), frames)
    assert enc._intra.plan.tile_col_bounds == (0, 1, 3, 5)


def test_tiles_wpp_ippp_stream_matches_jax():
    """(c) IPPP 192x128 with tiles 2x2 and WPP: each picture codes one
    substream per CTU row of each tile, 4 here (3 entry points)."""
    frames = _clip(3, 192, 128, seed=43)
    sizes = []
    real = tfe.IntraFrameEncoder._python_slice_data

    def counted(self, *a, **k):
        out = real(self, *a, **k)
        sizes.append(len(out[1]))
        return out

    tfe.IntraFrameEncoder._python_slice_data = counted
    try:
        enc, got = _stream(dict(width=192, height=128, qp=32,
                                intra_period=0, intra_max_cu=16,
                                intra_min_cu=16, wpp=True, tiles_x=2,
                                tiles_y=2), frames)
    finally:
        tfe.IntraFrameEncoder._python_slice_data = real
    assert sizes == [4, 4, 4]
    assert [i.slice_type for _c, i, _r in got] == [2, 1, 1]


def test_tile_slices_ippp_stream_matches_jax():
    """(d) --slices tiles, IPPP 192x128, tiles 2x1, WPP off: an
    independent slice NAL per tile (tile-scan slice addresses)."""
    frames = _clip(3, 192, 128, seed=44)
    _enc, got = _stream(dict(width=192, height=128, qp=30, intra_period=0,
                             intra_max_cu=16, intra_min_cu=16, wpp=False,
                             tiles_x=2, tiles_y=1, slices="tiles"), frames)
    assert [_slices(c) for c, _i, _r in got[1:]] == [2, 2]


def test_row_slices_ippp_stream_matches_jax():
    """(e) --slices wpp, IPPP 128x192: each CTU row a dependent slice
    segment, 3 NALs a picture."""
    frames = _clip(3, 128, 192, seed=45)
    _enc, got = _stream(dict(width=128, height=192, qp=30, intra_period=0,
                             intra_max_cu=16, intra_min_cu=16,
                             slices="wpp"), frames)
    assert [_slices(c) for c, _i, _r in got[1:]] == [3, 3]


def test_row_slices_var_tree_stream_matches_jax():
    """(e) --slices wpp on the medium preset at --period 1 (a variable
    intra tree with RDOQ; SAO off, whose JAX program alone takes most of
    a minute to compile here), 64x128: two dependent row segments."""
    frames = _clip(1, 64, 128, seed=46)
    enc, got = _stream(dict(width=64, height=128, qp=30, intra_period=1,
                            slices="wpp", sao=False), frames,
                       preset="medium", pipelined=False)
    assert enc._intra.var and _slices(got[0][0]) == 2


def test_tiles_gop4_stream_matches_jax():
    """(f) a fixed-grid GOP-4 B pyramid with tiles 2x2 at 128x128: the
    IDR, the P anchor and three B pictures, whose decode-order merge /
    AMVP loops follow the plan's tile-major order."""
    frames = _clip(5, 128, 128, seed=47)
    _enc, got = _stream(dict(width=128, height=128, qp=30, intra_max_cu=16,
                             intra_min_cu=16, gop_len=4, intra_period=0,
                             tiles_x=2, tiles_y=2), frames,
                        pipelined=False)
    assert [r[1].poc for r in got] == [0, 4, 2, 1, 3]


def test_tiles_10bit_cu32_stream_matches_jax():
    """(g) Config()'s fixed cu 32 grid (WPP) at 10-bit on 128x128 with
    tiles 2x2, all-intra: 16-bit samples through the tile substreams."""
    frames = [tuple((p.astype(np.uint16) << 2) | (p.astype(np.uint16) & 3)
                    for p in f) for f in _clip(2, 128, 128, seed=48)]
    _enc, got = _stream(dict(width=128, height=128, qp=30, intra_period=1,
                             input_bitdepth=10, tiles_x=2, tiles_y=2),
                        frames)
    assert all(r.dtype == np.uint16 for _c, _i, rec in got for r in rec)


def test_tiles_lossless_stream_matches_jax():
    """(g) lossless all-intra 128x64, cu 16, tiles 2x1: the bypass
    reconstruction is the source on a tiled plan."""
    frames = _clip(1, 128, 64, seed=49)
    _enc, got = _stream(dict(width=128, height=64, qp=30, intra_max_cu=16,
                             intra_min_cu=16, intra_period=1, lossless=True,
                             tiles_x=2, tiles_y=1), frames)
    for r, s in zip(got[0][2], frames[0]):
        np.testing.assert_array_equal(r, s)


_JAX_RECON = _jit_whole(jax_reconstruct_frames)


@pytest.mark.parametrize("cu,kind", [(16, "intra"), (32, "inter")])
def test_wavefront_plain_on_tile_plans_matches_jax(cu, kind):
    """reconstruct_frames on a 3x2 tile plan of 192x128 (availability
    cut at the tile edges, tile-major steps) against JAX's: random
    samples and modes, for inter a random inter map with random MC
    planes; levels and recon equal."""
    rng = np.random.default_rng(cu)
    w, h = 192, 128
    plan = make_intra_plan(w, h, cu, chroma=True, tiles=(3, 2))
    ys = rng.integers(0, 256, (1, h, w)).astype(np.int32)
    cbs, crs = (rng.integers(0, 256, (1, h // 2, w // 2)).astype(np.int32)
                for _ in range(2))
    shape = (1, plan.blocks_y, plan.blocks_x)
    modes = rng.integers(0, 35, shape).astype(np.int32)
    kw = {}
    if kind == "inter":
        kw = dict(is_inter=rng.random(shape) < 0.5,
                  **{k: rng.integers(0, 256, p.shape).astype(np.int32)
                     for k, p in (("mc_y", ys), ("mc_cb", cbs),
                                  ("mc_cr", crs))})
    want = _JAX_RECON(ys, cbs, crs, modes, plan, 27, 29, 8, **kw)
    got = reconstruct_frames(
        *(torch.from_numpy(a) for a in (ys, cbs, crs, modes)), plan, 27,
        29, 8, **{k: torch.from_numpy(v) for k, v in kw.items()})
    for name, g, wnt in zip(("rec_y", "lv_y", "rec_cb", "lv_cb", "rec_cr",
                             "lv_cr"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt),
                                      err_msg=name)


@pytest.mark.parametrize("chroma", [False, True])
def test_sao_decide_frame_matches_jax(chroma):
    """The copied host decision (sao_decide_frame) against JAX's on
    seeded statistics with tile maps: every resolved parameter equal,
    no merge across a tile boundary, and the tile maps changing the
    result."""
    rng = np.random.default_rng(7 + chroma)
    cy, cx = 4, 6

    def stats():
        cnt = rng.integers(0, 400, (4, 5, cy, cx))
        bcnt = rng.integers(0, 120, (32, cy, cx))
        # Small sums against the counts keep many offsets near 0, so
        # that merging often wins.
        return (cnt, rng.integers(-2, 3, cnt.shape) * cnt // 3, bcnt,
                rng.integers(-2, 3, bcnt.shape) * bcnt // 3)

    s_y = stats()
    s_c = (stats(), stats()) if chroma else None
    tcol = np.array([0, 0, 1, 1, 1, 2])
    trow = np.array([0, 0, 1, 1])
    for tiles in ((None, None), (tcol, trow)):
        want = jsao.sao_decide_frame(s_y, s_c, 35.5, tile_col=tiles[0],
                                     tile_row=tiles[1])
        got = tsao.sao_decide_frame(s_y, s_c, 35.5, tile_col=tiles[0],
                                    tile_row=tiles[1])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    merge = got["merge"]
    assert not ((merge == 1) & (tcol != np.roll(tcol, 1))[None, :]).any()
    assert not ((merge == 2) & (trow != np.roll(trow, 1))[:, None]).any()
    untiled = tsao.sao_decide_frame(s_y, s_c, 35.5)["merge"]
    assert (untiled != merge).any()


def _tile_ring_holds(plan, info, k):
    """Replay each tile's steps on a ring of its own k block rows (block
    row by in ring row by % k): every reference read finds its
    neighbour's edges, written in an earlier step and not written over
    in the reader's step."""
    for bx0, by0, bw, bh in info.tolist():
        owner = {}
        for step in plan.block_of_slot:
            blocks = [divmod(int(b), plan.blocks_x) for b in step if b >= 0]
            blocks = [(y, x) for y, x in blocks
                      if by0 <= y < by0 + bh and bx0 <= x < bx0 + bw]
            writes = {}
            for by, bx in blocks:
                writes.setdefault((by % k, bx), []).append((by, bx))
            for by, bx in blocks:
                for i, (dx, dy) in enumerate(((-1, 0), (0, -1), (1, -1),
                                              (-1, 1), (-1, -1))):
                    if not plan.avail[by, bx, i]:
                        continue
                    loc = ((by + dy) % k, bx + dx)
                    if owner.get(loc) != (by + dy, bx + dx) or loc in writes:
                        return False
            for loc, ws in writes.items():
                owner[loc] = ws[0] if len(ws) == 1 else None
    return True


@pytest.mark.parametrize("w,h,cu,tiles", [
    (1920, 1088, 16, (3, 3)),
    (1920, 1088, 32, (3, 3)),
    (3840, 2176, 32, (3, 3)),
    (320, 192, 16, (3, 2)),
])
def test_kernel_tile_tables(w, h, cu, tiles):
    """The kernel runs a thread block per tile, each with a ring over its
    own block rows: the wrapper's ring depth holds for every tile and is
    3 at BASELINE config #4's 3x3 shapes (one ring over the whole tiled
    frame would need 12..16 rows: its tiles run their wavefronts at
    once); the tiles' widest width and most steps bound the launch."""
    plan = make_intra_plan(w, h, cu, chroma=True, tiles=tiles)
    _blk, _starts, info = wavefront.step_tables(plan)
    n_steps, n_slots, ring, tile_bw, tile_blocks = wavefront.tile_shape(plan)
    assert len(info) == tiles[0] * tiles[1]
    assert n_steps == plan.n_steps and tile_bw == info[:, 2].max()
    assert tile_blocks == (info[:, 2] * info[:, 3]).max()
    assert n_slots <= plan.n_slots
    if w >= 1920:
        assert ring == 3
        assert wavefront.ring_depth(plan) >= 12
    else:
        assert _tile_ring_holds(plan, info, ring)
        assert ring == 1 or not _tile_ring_holds(plan, info, ring - 1)


def test_tiles_and_slices_are_ported():
    """The frame encoder no longer names tiles or slices; mesh sharding
    still raises NotImplementedError; per-CTU QP under tiles stays off
    (frame-level rate control), as the config decides; and the CLI's
    --tiles / --slices reach the config."""
    for kw in (dict(tiles_x=3, tiles_y=3), dict(slices="wpp"),
               dict(tiles_x=2, tiles_y=1, slices="tiles", wpp=False)):
        cfg = Config(width=256, height=192, **kw).validate()
        assert tfe.unsupported(cfg) == []
    cfg = Config(width=256, height=192, tiles_x=2, tiles_y=2,
                 bitrate=500_000)
    assert not cfg.cu_qp_delta_active
    mesh = Config(width=128, height=128, intra_period=1, mesh_tiles=2)
    with pytest.raises(NotImplementedError, match="mesh sharding"):
        tfe.IntraFrameEncoder(mesh, device="cpu")
    args = build_argparser().parse_args(
        ["-i", "x.yuv", "--input-res", "256x192", "-o", "y.hevc",
         "--preset", "superfast", "--period", "1", "--set",
         "inter-min-cu=16", "--tiles", "3x2", "--no-wpp", "--slices",
         "tiles"])
    cfg = config_from_args(args).validate()
    assert (cfg.tiles_x, cfg.tiles_y, cfg.slices) == (3, 2, "tiles")
    assert tfe.unsupported(cfg) == []
