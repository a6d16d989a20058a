"""RDOQ, sign-data hiding, --rd 2 and --rd 3 on the fixed CU grid (and
--rd 3 on variable intra trees) in the port == the JAX package's, with
tolerance 0.

Op cases: (a) ``quantize_rdoq`` with one QP per block at S = 4..32, 8
and 10 bits; (b) the wavefront reconstruction's plain version (the CUDA
kernel's RDOQ / sign-hiding instances and its explicit chroma modes are
held against it on the card by ``chip_smoke.py``) with RDOQ, sign hiding,
both, a per-block QP map and explicit chroma modes, against the JAX
package's XLA scan (``reconstruct_frames``) at 64x48, cu 8/16/32, intra
and inter (inter blocks scan diagonally), one case at 10 bits, and on
blocks whose RDOQ decision flips between the float32 orders of JAX's
jitted ``quantize_rdoq`` and of its encoder programs (F2), intra and
inter, tiled or not; (c) ``search_chroma_modes``.

Streams, one test per JAX reference stream: kvazaar_tpu_torch's
``Encoder`` on CPU tensors against kvazaar_tpu's on its CPU backend,
each picture's bytes, FrameInfo and reconstruction equal, and the JAX
oracle decoder turning the port's stream back into its recon: (d1) fixed
cu 8 all-intra with rd 3, RDOQ and sign hiding; (d2) ``slower --gop
lp-g4d4t1`` (an IDR and 2 P frames); (d3) ``medium --gop 0 --ref
2`` (an IDR, then P frames against one and two references); (d4) a
fixed-grid GOP 4 with RDOQ and sign hiding; (d5) RDOQ with
``--bitrate`` on one-reference IPPP (per-CTU QP); (d6) tiles 2x2 with
RDOQ and sign hiding, an I and a P picture (the P picture holds F2's
near-tie group, ROADMAP §3, repaired); (d7) ``medium --period 1
--rd 3`` (variable trees, SAO on, at 96x96: the JAX SAO program is
the one ``test_torch_sao.share_sao_program`` compiles once per
process).  --rd 3 with 64x64 intra CUs stays refused (F3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvazaar_tpu.api as japi
from kvazaar_tpu.config import Config as JaxConfig
from kvazaar_tpu.config import config_from_preset as jax_preset
from kvazaar_tpu.encoder.intra_recon import \
    reconstruct_frames as jax_reconstruct_frames
from kvazaar_tpu.encoder.intra_search import \
    search_chroma_modes as jax_search_chroma_modes
from kvazaar_tpu.ops import quant as jquant
from kvazaar_tpu_torch import Config
from kvazaar_tpu_torch.api import Encoder
from kvazaar_tpu_torch.config import config_from_preset
from kvazaar_tpu_torch.encoder.frame_encoder import unsupported
from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
from kvazaar_tpu_torch.encoder.intra_recon import reconstruct_frames
from kvazaar_tpu_torch.encoder.intra_search import search_chroma_modes
from kvazaar_tpu_torch.ops import quant as tquant
from kvazaar_tpu_torch.ops.transform import forward_transform
from test_torch_rate_control import _same_streams
from test_torch_sao import share_sao_program
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


# ---- (a) RDOQ with a per-block QP ----

@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_rdoq_per_block_qp_matches_jax(size, bd):
    """Transform-range coefficients, one QP per block over 0..51 and the
    frame's lambda, as the per-CTU QP path calls it."""
    rng = np.random.default_rng(size + bd)
    n = 40
    coeff = (rng.laplace(0, 300, (n, size, size))
             * rng.random((n, 1, 1)) ** 2).clip(-32768, 32767).astype(
                 np.int32)
    qps = rng.integers(0, 52, n).astype(np.int32)
    lam = tquant._f32(0.57 * 2.0 ** ((27 - 12) / 3.0))
    got = tquant.quantize_rdoq(_t(coeff), _t(qps), size, bd, lam=lam)
    want = jquant.quantize_rdoq(jnp.asarray(coeff), jnp.asarray(qps), size,
                                bd, lam=lam)
    _eq(got, want)
    assert (got != 0).any() and (got == 0).any()


# ---- (b) the wavefront's plain version with the tools ----

_JAX_RECON = _jit_whole(jax_reconstruct_frames)

# name: (cu, inter, rdoq, signhide, qp_map, cmodes, bitdepth)
RECON_CASES = {
    "cu8-intra-rdoq-sh-cmodes": (8, False, True, True, False, True, 8),
    "cu8-inter-sh": (8, True, False, True, False, False, 8),
    "cu16-intra-rdoq-qpmap": (16, False, True, False, True, False, 8),
    "cu16-inter-rdoq-sh": (16, True, True, True, False, False, 8),
    "cu32-intra-sh-qpmap-cmodes": (32, False, False, True, True, True, 8),
    "cu32-inter-rdoq-sh-qpmap": (32, True, True, True, True, False, 8),
    "cu16-10bit-inter-rdoq-sh-qpmap": (16, True, True, True, True, False,
                                       10),
}


@pytest.mark.parametrize("name", sorted(RECON_CASES))
def test_wavefront_plain_tools_match_jax_scan(name):
    """Two 64x48 frames (64x64 at cu 32) of the seeded clip, random modes
    over all 35 (every scanIdx), random explicit chroma modes, a random
    inter map with the next frames as MC planes, a per-block QP map over
    18..40: levels and recon equal to the JAX scan's."""
    cu, inter, rdoq, sh, qpm, cm, bd = RECON_CASES[name]
    rng = np.random.default_rng(len(name))
    w, h = 64, (64 if cu == 32 else 48)
    plan = make_intra_plan(w, h, cu, chroma=True)
    frames = _clip(4, w, h, seed=cu)
    planes = [np.stack([f[k] for f in frames]).astype(np.int32) << (bd - 8)
              for k in range(3)]
    ys, cbs, crs = (p[:2] for p in planes)
    shape = (2, plan.blocks_y, plan.blocks_x)
    modes = rng.integers(0, 35, shape).astype(np.int32)
    kw = dict(rdoq=rdoq, signhide=sh, lam=0.57 * 2.0 ** ((30 - 12) / 3.0))
    if inter:
        kw.update(is_inter=rng.random(shape) < 0.5,
                  mc_y=planes[0][2:], mc_cb=planes[1][2:],
                  mc_cr=planes[2][2:])
    if qpm:
        kw["qp_map"] = rng.integers(18, 41, shape).astype(np.int32)
    if cm:
        kw["cmodes"] = rng.integers(0, 35, shape).astype(np.int32)
    want = _JAX_RECON(ys, cbs, crs, modes, plan, 30, 29, bd, **kw)
    got = reconstruct_frames(
        _t(ys), _t(cbs), _t(crs), _t(modes), plan, 30, 29, bd,
        **{k: _t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    for key, g, wnt in zip(("rec_y", "lv_y", "rec_cb", "lv_cb", "rec_cr",
                            "lv_cr"), got, want):
        _eq(g, wnt, key)


def _rdoq_tie_blocks(s, qp, lam, n, seed):
    """n seeded residual blocks (S x S, small amplitudes) whose RDOQ
    levels differ between the float32 orders of the JAX package's jitted
    ``quantize_rdoq`` and of its encoder programs (``program`` "op" and
    "grid" in ops.quant: the kept-cost group sums and the rate product's
    rounding), with the two level arrays."""
    rng = np.random.default_rng(seed)
    found = []
    for _ in range(40):
        if len(found) >= n:
            break
        amp = rng.choice([2, 3, 4, 6], size=(2048, 1, 1))
        r = rng.integers(-8, 9, (2048, s, s)) * (
            rng.random((2048, s, s)) < rng.uniform(0.05, 0.6, (2048, 1, 1)))
        r = np.clip(r, -amp, amp).astype(np.int32)
        c = forward_transform(_t(r), s, 8)
        op, grid = (tquant.quantize_rdoq(c, qp, s, 8, True, lam,
                                         program=pg).numpy()
                    for pg in ("op", "grid"))
        for i in np.flatnonzero((op != grid).reshape(len(r), -1).any(1)):
            found.append((r[i], op[i], grid[i]))
    assert len(found) >= n
    return found[:n]


@pytest.mark.parametrize("kind", ["intra", "intra-tiled", "inter",
                                  "inter-tiled"])
def test_rdoq_near_ties_in_recon_programs_match_jax(kind):
    """F2 (ROADMAP §3): blocks whose RDOQ decision differs between the
    float32 orders of JAX's jitted ``quantize_rdoq`` and of its encoder
    programs, reconstructed by JAX's scan (jitted with a constant
    lambda, as its fixed-grid I, P and B programs run it; B frames take
    the inter variant with their bi-predicted MC planes) and by the
    port's plain twin, on a cu 16 plan, tiled 2x2 or not.  Intra: each
    crafted block is the first of its tile (no neighbours, DC predicts
    mid-grey); inter: every block is inter with a flat MC plane."""
    w = h = 128
    qp, lam, cu = 27, 0.57 * 2.0 ** ((27 - 12) / 3.0), 16
    tiled, inter = kind.endswith("tiled"), kind.startswith("inter")
    plan = make_intra_plan(w, h, cu, chroma=False,
                           tiles=(2, 2) if tiled else (1, 1))
    firsts = ([(0, 0), (0, 4), (4, 0), (4, 4)] if tiled else [(0, 0)])
    nb = 2 if inter else 3
    spots = ([(f, by, bx) for f in range(nb) for by in (1, 3, 6)
              for bx in (0, 2, 5)] if inter else
             [(f, by, bx) for f in range(nb) for by, bx in firsts])
    ties = _rdoq_tie_blocks(cu, qp, lam, len(spots), seed=len(kind))
    ys = np.full((nb, h, w), 128, np.int32)
    for (f, by, bx), (r, _op, _grid) in zip(spots, ties):
        ys[f, by * cu:(by + 1) * cu, bx * cu:(bx + 1) * cu] += r
    shape = (nb, plan.blocks_y, plan.blocks_x)
    modes = np.ones(shape, np.int32)                     # DC
    kw = dict(rdoq=True, lam=lam)
    if inter:
        kw.update(is_inter=np.ones(shape, bool),
                  mc_y=np.full((nb, h, w), 128, np.int32))
    want = _JAX_RECON(ys, None, None, modes, plan, qp, 29, 8, **kw)
    got = reconstruct_frames(
        _t(ys), None, None, _t(modes), plan, qp, 29, 8,
        **{k: _t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    _eq(got[0], want[0], "rec")
    _eq(got[1], want[1], "levels")
    lv = np.asarray(want[1])
    for (f, by, bx), (_r, op, grid) in zip(spots, ties):
        _eq(lv[f, by * plan.blocks_x + bx], grid, f"block {f, by, bx}")
    assert any((lv[f, by * plan.blocks_x + bx] != op).any()
               for (f, by, bx), (_r, op, _g) in zip(spots, ties))


# ---- (c) the chroma-mode search ----

_JAX_CHROMA = _jit_whole(jax_search_chroma_modes)


@pytest.mark.parametrize("cu", [8, 16, 32])
def test_search_chroma_modes_matches_jax(cu):
    w, h = 64, 64
    plan = make_intra_plan(w, h, cu, chroma=True)
    _y, cb, cr = _clip(1, w, h, seed=5)[0]
    rng = np.random.default_rng(cu)
    modes = rng.integers(0, 35, (plan.blocks_y, plan.blocks_x)).astype(
        np.int32)
    lam = 0.57 * 2.0 ** ((27 - 12) / 3.0)
    got = search_chroma_modes(_t(cb.astype(np.int32)),
                              _t(cr.astype(np.int32)), _t(modes), plan, 29,
                              lam)
    want = _JAX_CHROMA(jnp.asarray(cb, jnp.int32), jnp.asarray(cr, jnp.int32),
                       jnp.asarray(modes), plan, 29, lam)
    _eq(got, want)
    assert len(np.unique(got.numpy())) > 2


# ---- (d) streams ----

def _encode_both(cfg, jcfg, frames):
    """(port Encoder, its results, the JAX package's results) of one
    config, each result (chunk, FrameInfo, recon)."""
    assert unsupported(cfg) == []
    enc = Encoder(cfg, device="cpu")
    got = list(enc.encode_stream(frames, need_recon=True))
    jax_enc = japi.Encoder(jcfg)
    if jcfg.sao:
        share_sao_program(jax_enc._intra)
    return enc, got, list(jax_enc.encode_stream(frames, need_recon=True))


def _decoded(stream, enc, n_frames):
    """The oracle's decoded pictures of a stream: ((y, cb, cr),
    FrameData) in decoding order."""
    dec = oracle_decode(stream, enc._intra.params)
    assert len(dec) == n_frames
    return dec


def _decodes_to_recon(enc, got, frames):
    """The oracle decodes the port's stream to the port's recon; returns
    the decoded FrameData."""
    dec = _decoded(b"".join(r[0] for r in got), enc, len(frames))
    h, w = frames[0][0].shape
    for ((dy, dcb, dcr), _fd), (_c, info, rec) in zip(dec, got):
        for d, r in zip((dy[:h, :w], dcb[:h // 2, :w // 2],
                         dcr[:h // 2, :w // 2]), rec):
            _eq(d, r, f"decoded POC {info.poc}")
    return [fd for _r, fd in dec]


def _stream(cfg, jcfg, frames):
    """The port's and the JAX package's pictures of one config, equal
    picture by picture, and the oracle decode of the port's stream equal
    to its recon; returns the port's results and the decoded
    FrameData."""
    enc, got, want = _encode_both(cfg, jcfg, frames)
    _same_streams(got, want)
    return got, _decodes_to_recon(enc, got, frames)


def _explicit_chroma(fds):
    """The decoded pictures code some chroma mode other than DM."""
    return any((fd.cmode4 != fd.mode4[::2, ::2]).any() for fd in fds)


def _both(preset=None, **kw):
    if preset is None:
        return Config(**kw), JaxConfig(**kw)
    return config_from_preset(preset, **kw), jax_preset(preset, **kw)


def test_fixed_cu8_rd3_rdoq_signhide_intra_stream():
    """(d1) Fixed cu 8 all-intra at rd 3 with RDOQ and sign hiding: the
    rd 2 re-rank, the chroma-mode search (explicit intra_chroma_pred_mode
    in the native CABAC) and mode-dependent scans at luma 8 / chroma 4."""
    _got, fds = _stream(*_both(width=64, height=48, qp=27, intra_min_cu=8,
                               intra_max_cu=8, rd=3, rdoq=True,
                               signhide=True, intra_period=1),
                        _clip(1, 64, 48, seed=11))
    assert _explicit_chroma(fds)


def test_slower_low_delay_gop_stream():
    """(d2) ``--preset slower --gop lp-g4d4t1`` at 64x64, an IDR and 2 P
    frames: a variable-tree I frame (8..64, rd 2, RDOQ, sign hiding),
    then fixed cu 32 P frames with RDOQ and sign hiding at the QP of
    each GOP position (a frame encoder per QP: the first two positions
    take two).  SAO off: (d7) runs the JAX SAO program."""
    cfg, jcfg = _both("slower", width=64, height=64, qp=27,
                      lp_gop=(4, 4, 1), gop_len=0, sao=False)
    got, _fds = _stream(cfg, jcfg, _clip(3, 64, 64, seed=12))
    assert [r[1].qp for r in got] == [27, 31, 30]


def test_medium_two_references_stream():
    """(d3) ``--preset medium --gop 0 --ref 2``: fixed cu 32 P frames
    against two references with RDOQ."""
    cfg, jcfg = _both("medium", width=64, height=64, qp=27, gop_len=0,
                      lp_gop=None, ref_frames=2, sao=False)
    _stream(cfg, jcfg, _clip(3, 64, 64, seed=13))


def test_fixed_gop4_rdoq_signhide_stream():
    """(d4) A fixed-grid GOP 4 with RDOQ and sign hiding: B frames on the
    kernel's inter variant with the tools."""
    _stream(*_both(width=64, height=64, qp=27, intra_min_cu=16,
                   intra_max_cu=16, gop_len=4, intra_period=0, rdoq=True,
                   signhide=True), _clip(5, 64, 64, seed=14))


def test_rdoq_bitrate_per_ctu_qp_stream():
    """(d5) ``Config(rdoq=True, bitrate=...)`` IPPP: each block's RDOQ at
    its CTU's QP, at the frame's lambda (ROADMAP §3)."""
    cfg, jcfg = _both(width=128, height=64, qp=27, rdoq=True,
                      bitrate=300_000, intra_period=0)
    assert cfg.cu_qp_delta_active
    _stream(cfg, jcfg, _clip(3, 128, 64, seed=15))


def test_tiles_rdoq_stream():
    """(d6) Tiles 2x2 with RDOQ and sign hiding, an I and a P picture
    (the tiled plans of the kernel's tools instances; the Python tile
    CABAC), equal to JAX's.  The P picture holds F2's near-tie 4x4 group
    (ROADMAP §3, repaired): Cb (16, 53) is -1, as JAX's tiled P program
    decides it, where the order of JAX's jitted ``quantize_rdoq`` gives
    0."""
    cfg, jcfg = _both(width=128, height=128, qp=27, tiles_x=2, tiles_y=2,
                      rdoq=True, signhide=True, intra_period=2)
    _got, fds = _stream(cfg, jcfg, _clip(2, 128, 128, seed=16))
    assert fds[1].coeff_cb[16, 53] == -1


def test_medium_rd3_variable_trees_stream():
    """(d7) ``--preset medium --period 1 --rd 3`` at 96x96 as the preset
    sets it: variable intra trees whose chroma classes take the searched
    chroma modes, with RDOQ and SAO."""
    cfg, jcfg = _both("medium", width=96, height=96, qp=27,
                      intra_period=1, rd=3)
    assert cfg.sao and cfg.rdoq
    _got, fds = _stream(cfg, jcfg, _clip(1, 96, 96, seed=17))
    assert _explicit_chroma(fds)


def test_rd3_with_64_intra_cus_is_refused():
    """--rd 3 on variable intra trees that reach 64x64 CUs stays
    unported: the JAX package lets a 64 CU's four 32x32 quadrants keep
    different chroma modes while its stream codes the top-left's, so
    its decoded picture differs from its recon (F3, ROADMAP §3).  rd 3
    up to 32 and rd 2 up to 64 encode."""
    kw = dict(width=64, height=64, qp=27, intra_period=1)
    with pytest.raises(NotImplementedError, match="--rd 3 with 64x64"):
        Encoder(config_from_preset("slower", rd=3, **kw), device="cpu")
    assert unsupported(config_from_preset("slower", rd=3, **kw)) == [
        "--rd 3 with 64x64 intra CUs"]
    assert unsupported(config_from_preset("slower", **kw)) == []
    assert unsupported(config_from_preset("medium", rd=3, **kw)) == []
    assert unsupported(Config(intra_min_cu=8, intra_max_cu=64, rd=3,
                              chroma_format=400, **kw)) == []
