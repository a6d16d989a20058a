"""The port's ops at 10-bit (Main 10) == the JAX package's, exactly.

The same seeded numpy inputs, with samples in 0..1023, go through each
kvazaar_tpu op (CPU backend, jitted) and its kvazaar_tpu_torch
counterpart (CPU tensors) at bitdepth 10, with tolerance 0: the
transforms, the quantizer and dequantizer (flat and RDOQ, whose
distortion gain 1 / 4^(15 - 10 - log2 S) is 1 at S = 32), intra
prediction and the SATD mode search, deblocking (beta and tC scaled by
4), the SAO statistics, filter and offset choice (offsets capped at +-7
as the JAX package caps them, where 7.4.9.3.2 allows 31 at 10-bit), uni-
and bi-predicted MC, the quarter-pel refinement, the SAD surfaces and
the coarse hint grids, the wavefront reconstruction's plain version
against the JAX package's XLA scan (which is what the JAX package runs at
10-bit: its Pallas kernel stops at 8-bit), 16-bit YUV input, the SPS of
the Main 10 profile and the picture hash of 16-bit planes.

Small shapes throughout, so that each case costs one JAX compile of a
second or two.
"""

import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvazaar_tpu.bitstream import headers as jheaders
from kvazaar_tpu.encoder import inter_search as jisearch
from kvazaar_tpu.encoder import intra_search as jsearch
from kvazaar_tpu.encoder.intra_recon import \
    reconstruct_frames as jax_reconstruct_frames
from kvazaar_tpu.io import yuv as jyuv
from kvazaar_tpu.ops import deblock as jdeblock
from kvazaar_tpu.ops import intra as jintra
from kvazaar_tpu.ops import inter as jinter
from kvazaar_tpu.ops import quant as jquant
from kvazaar_tpu.ops import sao as jsao
from kvazaar_tpu.ops import transform as jtransform
from kvazaar_tpu_torch.bitstream import headers as theaders
from kvazaar_tpu_torch.encoder import inter_search as tisearch
from kvazaar_tpu_torch.encoder import intra_search as tsearch
from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
from kvazaar_tpu_torch.encoder.intra_recon import reconstruct_frames
from kvazaar_tpu_torch.io import yuv as tyuv
from kvazaar_tpu_torch.ops import deblock as tdeblock
from kvazaar_tpu_torch.ops import intra as tintra
from kvazaar_tpu_torch.ops import inter as tinter
from kvazaar_tpu_torch.ops import quant as tquant
from kvazaar_tpu_torch.ops import sao as tsao
from kvazaar_tpu_torch.ops import transform as ttransform
from test_torch_slice import _jit_whole

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

# Small CPU shapes: one intra-op thread each, so that the xdist
# workers sharing the cores do not oversubscribe them.
torch.set_num_threads(1)

BD = 10
MAXV = (1 << BD) - 1


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def _plane(rng, h, w, lo=0, hi=MAXV):
    """A smooth textured 10-bit plane with noise in its low bits."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    p = (512 + 300 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
         + 120 * (((xx // 12) + (yy // 8)) % 2) + rng.normal(0, 24, (h, w)))
    return np.clip(p, lo, hi).astype(np.int32)


def _moving_pair(rng, w, h):
    """(current, reference) 10-bit planes with real motion."""
    ref = _plane(rng, h, w)
    cur = np.roll(ref, (2, -3), (0, 1)) + rng.integers(-12, 13, (h, w))
    return np.clip(cur, 0, MAXV).astype(np.int32), ref


# ---- transform, quantizer, RDOQ ----

@pytest.mark.parametrize("qp", [0, 22, 37, 51])
@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_transform_quant_10bit_match_jax(size, qp):
    """Forward shift log2 S + 1, inverse shift 10; qbits = 14 + QP / 6
    + 15 - 10 - log2 S (no QpBdOffset, as the JAX package quantizes)."""
    rng = np.random.default_rng(size + 100 * qp)
    resid = rng.integers(-MAXV, MAXV + 1, (3, size, size)).astype(np.int32)
    fwd = ttransform.forward_transform(_t(resid), size, BD)
    _eq(fwd, jtransform.forward_transform(jnp.asarray(resid), size, BD))
    coeff = rng.integers(-32768, 32768, (3, size, size)).astype(np.int32)
    coeff[0] //= 64
    _eq(ttransform.inverse_transform(_t(coeff), size, BD),
        jtransform.inverse_transform(jnp.asarray(coeff), size, BD))
    log2n = size.bit_length() - 1
    assert tquant.quant_params(qp, log2n, BD) == tuple(
        int(v) for v in jquant.quant_params(qp, log2n, BD))
    for intra in (True, False):
        lv = tquant.quantize(fwd, qp, size, BD, intra=intra)
        _eq(lv, jquant.quantize(jnp.asarray(fwd.numpy()), qp, size, BD,
                                intra=intra), f"intra {intra}")
    levels = rng.integers(-500, 501, (3, size, size)).astype(np.int32)
    _eq(tquant.dequantize(_t(levels), qp, size, BD),
        jquant.dequantize(jnp.asarray(levels), qp, size, BD))


@functools.lru_cache(maxsize=None)
def _jax_rdoq(size):
    return jax.jit(lambda c, qp, lam, intra: jquant.quantize_rdoq(
        c, qp, size, BD, intra, lam), static_argnums=3)


@pytest.mark.parametrize("size", [4, 8, 16, 32])
@pytest.mark.parametrize("intra", [True, False], ids=["intra", "inter"])
def test_rdoq_10bit_matches_jax(size, intra):
    rng = np.random.default_rng(40 + size + 100 * intra)
    n = max(2048 // (size * size), 2)
    mag = np.exp(rng.uniform(0, np.log(32767), (n, size, size)))
    c = (mag * rng.choice([-1, 1], (n, size, size))).astype(np.int32)
    c[rng.random((n, size, size)) < 0.6] //= 64
    for qp in (22, 37):
        for lam in (4.5, 57.0, 913.25):
            want = np.asarray(_jax_rdoq(size)(
                jnp.asarray(c), jnp.int32(qp), jnp.float32(lam), intra))
            got = tquant.quantize_rdoq(_t(c), qp, size, BD, intra, lam)
            _eq(got, want, f"qp {qp} lam {lam}")


# ---- intra prediction and the mode search ----

@pytest.mark.parametrize("n,luma", [(8, True), (16, True), (32, True),
                                    (4, False), (8, False), (16, False)])
def test_intra_prediction_10bit_matches_jax(n, luma):
    """Every mode, the DC / 10 / 26 fixups clipped to 1023."""
    rng = np.random.default_rng(n + 100 * luma)
    refs = rng.integers(0, MAXV + 1, (3, 4 * n + 1)).astype(np.int32)
    refs[0] = np.where(np.arange(4 * n + 1) < 2 * n, 1000, 20)
    _eq(tintra.predict_all_modes(_t(refs), n, luma=luma, bitdepth=BD),
        jax.jit(functools.partial(jintra.predict_all_modes, n=n, luma=luma,
                                  bitdepth=BD))(jnp.asarray(refs)))
    modes = np.tile(np.arange(35, dtype=np.int32), 3)
    refs3 = np.repeat(refs, 35, axis=0)
    _eq(tintra.predict_modes(_t(refs3), _t(modes), n, luma=luma,
                             bitdepth=BD),
        jax.jit(functools.partial(jintra.predict_modes, n=n, luma=luma,
                                  bitdepth=BD))(jnp.asarray(refs3),
                                                jnp.asarray(modes)))


@pytest.mark.parametrize("cu", [8, 16, 32])
@pytest.mark.parametrize("two_pass", [False, True], ids=["satd", "rd"])
def test_mode_search_10bit_matches_jax(cu, two_pass):
    """search_frame_modes (the SATD pass, or with the RD re-rank and its
    float32 SSDs of 10-bit residuals), mid-grey 512 where no neighbour
    is available."""
    rng = np.random.default_rng(cu)
    frame = _plane(rng, 64, 96)
    plan = make_intra_plan(96, 64, cu, chroma=False)
    got = tsearch.search_frame_modes(_t(frame), plan, 6.3, BD, two_pass)
    want = jax.jit(functools.partial(
        jsearch.search_frame_modes, plan=plan, lambda_satd=6.3,
        bitdepth=BD, two_pass=two_pass))(jnp.asarray(frame))
    _eq(got[0], want[0], "modes")
    _eq(got[1], want[1], "costs")


# ---- deblocking ----

_JAX_DEBLOCK = _jit_whole(jdeblock.deblock_frame)


@pytest.mark.parametrize("qp", [27, 45])
@pytest.mark.parametrize("kind", ["all-intra", "bs-maps", "qp-map"])
def test_deblock_10bit_matches_jax(kind, qp):
    """beta and tC scaled by 1 << 2, the clip to 1023; bS maps of a P
    frame, a per-block QP map."""
    rng = np.random.default_rng(len(kind))
    h, w, s = 48, 64, 16
    base = rng.integers(200, 800, (1, 1, w)).astype(np.int32)
    planes = [np.clip(base + rng.integers(-24, 25, (1, h, w)), 0, MAXV),
              rng.integers(300, 700, (1, h // 2, w // 2)),
              rng.integers(300, 700, (1, h // 2, w // 2))]
    planes = [(p // 24 * 24).astype(np.int32) for p in planes]
    kw = {}
    if kind == "bs-maps":
        kw = dict(bs_v=rng.integers(0, 3, (h // s, w // s)).astype(np.int32),
                  bs_h=rng.integers(0, 3, (h // s, w // s)).astype(np.int32))
    elif kind == "qp-map":
        kw = dict(qp_map=rng.integers(20, 52, (h // s, w // s)).astype(
            np.int32))
    got = tdeblock.deblock_frame(*(_t(p) for p in planes), qp, s, BD,
                                 **{k: _t(v) for k, v in kw.items()})
    want = _JAX_DEBLOCK(*planes, qp, s, BD, **kw)
    for g, wnt, name in zip(got, want, ("y", "cb", "cr")):
        _eq(g, wnt, name)
    assert not np.array_equal(got[0].numpy(), planes[0])


# ---- SAO ----

def _sao_planes(rng, h, w):
    """(source, reconstruction): band bias on the left, dips at strong
    gradients on the right, errors larger than SAO's 7 can undo."""
    src = _plane(rng, h, w, 16, MAXV - 16)
    yy, xx = np.mgrid[0:h, 0:w]
    in_bands = (src >= 384) & (src < 512)
    edges = np.abs(np.diff(src, axis=1, prepend=0)) > 48
    err = np.where(xx < w // 2, 20 * in_bands, -20 * edges)
    rec = np.clip(src + err + rng.integers(-3, 4, (h, w)), 0, MAXV)
    return src, rec.astype(np.int32)


@pytest.mark.parametrize("ctu", [64, 32])
def test_sao_stats_and_offsets_10bit_match_jax(ctu):
    """Band classes at shift bitdepth - 5 = 5; the offset choice of each
    class clamps to +-7 in both packages (the quirk that 7.4.9.3.2's
    cMax of 31 at 10-bit would not impose)."""
    rng = np.random.default_rng(ctu)
    h, w = (136, 200) if ctu == 64 else (68, 100)
    src, rec = _sao_planes(rng, h, w)
    want = jax.jit(lambda o, r: jsao.sao_stats(o, r, ctu, BD))(src, rec)
    got = tsao.sao_stats(_t(src), _t(rec), ctu, BD)
    for g, wv, name in zip(got, want, ("e_cnt", "e_sum", "b_cnt", "b_sum")):
        _eq(g, wv, name)
    e_cnt, e_sum, b_cnt, b_sum = (np.asarray(a) for a in want)
    port = tsao._choose_luma(*got, 30.0)
    ref = jax.jit(jsao._choose_luma_jnp)(e_cnt, e_sum, b_cnt, b_sum,
                                          jnp.float32(30.0))
    for k in ("type", "eo_class", "band_pos", "offsets"):
        _eq(port[k], ref[k], k)
    mean_err = np.abs(b_sum).max(axis=0) / np.maximum(b_cnt.max(axis=0), 1)
    assert mean_err.max() > 7 and np.abs(port["offsets"].numpy()).max() == 7


@pytest.mark.parametrize("ctu", [64, 32])
def test_sao_apply_10bit_matches_jax(ctu):
    """Off, band and edge CTUs with random classes, band positions (the
    window wraps past 31) and offsets, clipped to 1023."""
    rng = np.random.default_rng(10 + ctu)
    h, w = (136, 200) if ctu == 64 else (68, 100)
    rec = _plane(rng, h, w)
    rec[:8] = MAXV - 2
    cy, cx = -(-h // ctu), -(-w // ctu)
    typ = rng.integers(0, 3, (cy, cx)).astype(np.int32)
    eo = rng.integers(0, 4, (cy, cx)).astype(np.int32)
    bp = rng.integers(0, 32, (cy, cx)).astype(np.int32)
    off = rng.integers(-7, 8, (cy, cx, 4)).astype(np.int32)
    got = tsao.apply_sao_plane(_t(rec), _t(typ), _t(eo), _t(bp), _t(off),
                               ctu, BD)
    want = jax.jit(lambda *a: jsao.apply_sao_plane(*a, ctu, BD))(
        rec, typ, eo, bp, off)
    _eq(got, want)


# ---- motion compensation and search ----

@pytest.mark.parametrize("kind", ["uni", "bi", "qpel"])
def test_mc_10bit_matches_jax(kind):
    """mc_planes (uni_round at shift 14 - 10), bi_mc_planes (bi_average
    at shift 15 - 10) and the quarter-pel refinement's SATDs, MVs
    reaching outside the frame."""
    rng = np.random.default_rng(len(kind))
    w, h, cu = 64, 48, 16
    plan = make_intra_plan(w, h, cu, chroma=True)
    refs = [[_plane(rng, *s) for s in ((h, w), (h // 2, w // 2),
                                       (h // 2, w // 2))] for _ in range(2)]
    lim = 4 * 16 + 3
    mv = rng.integers(-lim, lim + 1, (2, plan.blocks_y, plan.blocks_x,
                                      2)).astype(np.int32)
    mv[0, 0, 0] = (-lim, -lim)
    if kind == "uni":
        got = tisearch.mc_planes(*(_t(p) for p in refs[0]), _t(mv[0]), plan,
                                 BD)
        want = jax.jit(lambda *a: jisearch.mc_planes(*a, plan, BD))(
            *refs[0], mv[0])
    elif kind == "bi":
        dirs = rng.integers(0, 3, (plan.blocks_y, plan.blocks_x)).astype(
            np.int32)
        got = tisearch.bi_mc_planes(tuple(_t(p) for p in refs[0]),
                                    tuple(_t(p) for p in refs[1]),
                                    _t(mv[0]), _t(mv[1]), _t(dirs), plan, BD)
        want = jax.jit(lambda r0, r1, m0, m1, d: jisearch.bi_mc_planes(
            r0, r1, m0, m1, d, plan, BD))(tuple(refs[0]), tuple(refs[1]),
                                          mv[0], mv[1], dirs)
    else:
        n, size = 9, 8
        x0s = rng.integers(-8, w, n).astype(np.int32)
        y0s = rng.integers(-8, h, n).astype(np.int32)
        mv_int = rng.integers(-5, 6, (n, 2)).astype(np.int32) * 4
        blocks = rng.integers(0, MAXV + 1, (n, size, size)).astype(np.int32)
        got = (tinter.refine_qpel_dense(_t(blocks), _t(refs[0][0]),
                                        _t(x0s), _t(y0s), _t(mv_int), size,
                                        BD),)
        want = (jax.jit(lambda *a: jinter.refine_qpel_dense(*a, size, BD))(
            blocks, refs[0][0], x0s, y0s, mv_int),)
    for g, wnt in zip(got, want):
        _eq(g, wnt)
    assert max(int(g.max()) for g in got) > 255


@pytest.mark.parametrize("kind", ["sad", "coarse"])
def test_sad_and_coarse_grids_10bit_match_jax(kind):
    """The SAD surfaces over int16 |differences| and the hierarchical
    hint grids (4x4 pooled planes, surfaces for the size ladder)."""
    rng = np.random.default_rng(7 + len(kind))
    cur, ref = _moving_pair(rng, 128, 64 if kind == "sad" else 72)
    if kind == "sad":
        _eq(tinter.sad_surfaces(_t(cur), _t(ref), 8, 16, BD),
            jax.jit(lambda c, f: jinter.sad_surfaces(c, f, 8, 16, BD))(
                cur, ref))
        return
    got = tinter.coarse_mv_grids(_t(cur), _t(ref), 16, (8, 16, 32, 64), BD)
    want = jax.jit(lambda c, f: jinter.coarse_mv_grids(
        c, f, 16, (8, 16, 32, 64), BD))(cur, ref)
    assert sorted(got) == sorted(want)
    for s in got:
        _eq(got[s], want[s], f"hint {s}")
    assert any(np.abs(g.numpy()).max() > 0 for g in got.values())


# ---- the wavefront reconstruction ----

_JAX_RECON = _jit_whole(jax_reconstruct_frames)


@pytest.mark.parametrize("cu", [8, 16, 32])
@pytest.mark.parametrize("kind", ["intra", "inter", "qp-map"])
def test_wavefront_plain_10bit_matches_jax_scan(kind, cu):
    """The kernel's plain version at 10-bit (substitution 512, clip
    1023) against the JAX XLA scan: two frames of seeded modes, intra,
    with a random inter map and 10-bit MC planes, or with a per-block QP
    map (an inter frame)."""
    rng = np.random.default_rng(cu + 7 * len(kind))
    w, h = 64, 64
    plan = make_intra_plan(w, h, cu, chroma=True)
    ys = np.stack([_plane(rng, h, w) for _ in range(2)])
    cbs, crs = (np.stack([_plane(rng, h // 2, w // 2) for _ in range(2)])
                for _ in range(2))
    shape = (2, plan.blocks_y, plan.blocks_x)
    modes = rng.integers(0, 35, shape).astype(np.int32)
    kw = {}
    if kind != "intra":
        kw = dict(is_inter=rng.integers(0, 2, shape).astype(bool),
                  mc_y=np.clip(ys + rng.integers(-20, 21, ys.shape), 0,
                               MAXV).astype(np.int32),
                  mc_cb=np.roll(cbs, 1, axis=1), mc_cr=np.roll(crs, -2,
                                                               axis=2))
    if kind == "qp-map":
        kw["qp_map"] = rng.integers(-3, 55, shape).astype(np.int32)
    want = _JAX_RECON(ys, cbs, crs, modes, plan, 27, 29, BD, **kw)
    got = reconstruct_frames(_t(ys), _t(cbs), _t(crs), _t(modes), plan, 27,
                             29, BD, **{k: _t(v) for k, v in kw.items()})
    for name, g, wnt in zip(("rec_y", "lv_y", "rec_cb", "lv_cb", "rec_cr",
                             "lv_cr"), got, want):
        _eq(g, wnt, name)
    assert got[0].dtype == torch.int16 and int(got[0].max()) > 255


# ---- 16-bit input, the SPS and the picture hash ----

@pytest.mark.parametrize("case", ["le", "be", "8to10"])
def test_read_frames_10bit_matches_jax(tmp_path, case):
    """16-bit little- and big-endian files at 10-bit, and an 8-bit file
    read up to 10-bit: the port's copy of io/yuv reads what the JAX
    package reads, as uint16."""
    rng = np.random.default_rng(len(case))
    w, h = 16, 8
    file_bd = 8 if case == "8to10" else 10
    dt = np.uint8 if file_bd == 8 else (">u2" if case == "be" else "<u2")
    planes = [rng.integers(0, 1 << file_bd, s).astype(dt)
              for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))] * 2
    path = tmp_path / "in.yuv"
    path.write_bytes(b"".join(p.tobytes() for p in planes))
    kw = dict(bitdepth=10, file_bitdepth=file_bd, big_endian=case == "be")
    got = list(tyuv.read_frames(str(path), w, h, **kw))
    want = list(jyuv.read_frames(str(path), w, h, **kw))
    assert len(got) == len(want) == 2
    for gf, wf in zip(got, want):
        for g, wnt in zip(gf, wf):
            assert g.dtype == np.uint16
            _eq(g, wnt)
    shift = 2 if case == "8to10" else 0
    _eq(got[0][0], planes[0].astype(np.uint16) << shift)


@pytest.mark.parametrize("kind", ["md5", "checksum"])
def test_main10_sps_and_16bit_hash_match_jax(kind):
    """general_profile_idc 2 (Main 10), bit_depth_*_minus8 = 2, and the
    picture hash SEI over 16-bit little-endian samples."""
    kw = dict(width=64, height=48, bitdepth=10, qp=27, sao_enabled=True,
              deblock_enabled=True, wpp=True)
    tp, jp = theaders.StreamParams(**kw), jheaders.StreamParams(**kw)
    for name in ("write_vps", "write_sps", "write_pps"):
        assert getattr(theaders, name)(tp) == getattr(jheaders, name)(jp)
    sps = theaders.write_sps(tp)
    assert sps != theaders.write_sps(theaders.StreamParams(
        **dict(kw, bitdepth=8)))
    rng = np.random.default_rng(len(kind))
    planes = [rng.integers(0, MAXV + 1, s).astype(np.uint16)
              for s in ((48, 64), (24, 32), (24, 32))]
    sei = theaders.write_picture_hash_sei(planes, BD, kind=kind)
    assert sei == jheaders.write_picture_hash_sei(planes, BD, kind=kind)
    if kind == "md5":
        assert hashlib.md5(planes[0].astype("<u2").tobytes()).digest() \
            in sei
    # The int16 device recon downloaded by the frame encoder hashes the
    # same as uint16 planes.
    assert theaders.write_picture_hash_sei(
        [p.view(np.int16).view("<u2") for p in planes], BD,
        kind=kind) == sei
