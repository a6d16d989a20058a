"""The port's B pyramids == the JAX package's.

kvazaar_tpu_torch (CPU tensors, plain paths) against kvazaar_tpu (CPU
backend, jitted) with tolerance 0, float costs included:

- the bi-pred ops (``bi_average``, ``mc_planes_hp``, ``bi_mc_planes``,
  ``bi_mc_planes_cells``, ``merge_satd_maps_b``) with MVs reaching out of
  the frame and every direction; the B deblocking strengths of the fixed
  grid (``compute_bs_maps_b``) and of a variable tree (``var_bs_maps``
  with ``mv1_cells`` / ``dirs8``);
- the copied B candidate derivations (``merge_amvp_var_b_vec`` and
  ``var_b_derive``) against their scalar oracle and the JAX module;
- ``frame_lambda`` and the frame QP / lambdas of every GOP entry;
- the bi-pred check's ``satd + lambda * rate``: one fused multiply-add on
  XLA's CPU backend, with the lambda traced (variable trees) or a
  constant (the fixed grid), on inputs that tell it from two roundings;
- stream A, variable trees: the medium preset at GOP 4 with an intra
  period of 8 at 128x64 (11 frames): an IDR, a P anchor and B pictures
  at their layers' QP and lambda (RDOQ, SAO, CUs 8..64), a CRA anchor
  with RASL B pictures, a 2-frame P tail.  Bytes and recon equal the
  JAX ``Encoder``'s, the JAX oracle decoder gives back the port's recon,
  and on one B frame the search, the merge RD and the recon program
  (bi MC, direct pass, wavefront, B bS, deblocking at the frame QP)
  equal the compiled JAX programs of the stream;
- stream B, the fixed grid: tests/test_gop.py's GOP 8 at cu 16 (9
  frames, POC order 0 8 4 2 1 3 6 5 7, some B CU bi-predicted): bytes,
  recon and oracle decode, and one B frame's search and decision (the
  float32 1.02 intra bias) against the compiled JAX search;
- every preset from medium to placebo encodes at its default, and what
  stays unported on a GOP config raises.

Each JAX reference stream is encoded once, in the one test that needs
its compiled programs, so a test worker compiles it once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvazaar_tpu.api import Encoder as JaxEncoder
from kvazaar_tpu.api import GOP_TABLES as JAX_GOP_TABLES
from kvazaar_tpu.config import Config as JaxConfig
from kvazaar_tpu.config import config_from_preset as jax_preset
from kvazaar_tpu.encoder import frame_encoder as jfe
from kvazaar_tpu.encoder import inter_cands as jcands
from kvazaar_tpu.encoder import inter_search as jsearch
from kvazaar_tpu.encoder import quadtree as jqt
from kvazaar_tpu.ops import inter as jinter
from kvazaar_tpu_torch import Config
from kvazaar_tpu_torch.api import GOP_TABLES, Encoder, _unsupported_structure
from kvazaar_tpu_torch.config import config_from_preset
from kvazaar_tpu_torch.constants import SLICE_B, SLICE_I, SLICE_P
from kvazaar_tpu_torch.encoder import frame_encoder as tfe
from kvazaar_tpu_torch.encoder import inter_cands as tcands
from kvazaar_tpu_torch.encoder import inter_search as tsearch
from kvazaar_tpu_torch.encoder import quadtree as tqt
from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
from kvazaar_tpu_torch.ops import inter as tinter
from kvazaar_tpu_torch.ops import quant as tquant
from test_gop import _clip as gop_clip
from test_torch_slice import oracle_decode
from test_var_inter import _clip as shear_clip
from test_var_vec import random_fields, random_tree

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

# Small CPU shapes: one intra-op thread each, so that the xdist
# workers sharing the cores do not oversubscribe them.
torch.set_num_threads(1)

# Stream A: variable trees, open GOP; stream B: the fixed grid.
STREAM_A = dict(width=128, height=64, qp=32, gop_len=4, intra_period=8,
                hash="md5")
STREAM_B = dict(width=96, height=64, qp=30, intra_max_cu=16,
                intra_min_cu=16, gop_len=8, intra_period=0, hash="md5")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def _encode(enc, frames):
    out = [r for f in frames for r in enc.encode(*f)]
    return out + enc.flush()


def _nal_types(chunk: bytes) -> list:
    """NAL unit types of an Annex-B chunk, in order."""
    return [(part[0] >> 1) & 0x3F for part in chunk.split(b"\x00\x00\x01")
            if part]


def _check_stream(got, want, params, w, h):
    """Each picture's bytes, FrameInfo and recon == JAX's, and the oracle
    decoder turns the port stream into the port's recon.  Returns the
    decoded FrameData in coding order."""
    assert [dataclasses.astuple(g[1]) for g in got] == \
        [dataclasses.astuple(w_[1]) for w_ in want]
    for i, (g, w_) in enumerate(zip(got, want)):
        assert g[0] == w_[0], f"picture {i} (POC {g[1].poc}) bytes"
        for a, b in zip(g[2], w_[2]):
            _eq(a, b, f"picture {i} recon")
    dec = oracle_decode(b"".join(g[0] for g in got), params)
    assert len(dec) == len(got)
    for ((dy, dcb, dcr), _fd), g in zip(dec, got):
        for a, b in zip((dy[:h, :w], dcb[:h // 2, :w // 2],
                         dcr[:h // 2, :w // 2]), g[2]):
            _eq(a, b)
    return [fd for _planes, fd in dec]


def _recon_of(results, poc):
    """The (y, cb, cr) uint8 recon tensors of the picture at POC poc."""
    rec, = [r[2] for r in results if r[1].poc == poc]
    return tuple(_t(p) for p in rec)


# ---- 1. bi-pred ops --------------------------------------------------

def test_bi_pred_ops_match_jax():
    """bi_average, mc_planes_hp and bi_mc_planes (fixed grid, cu 16),
    bi_mc_planes_cells and merge_satd_maps_b (8x8 cells), with MVs
    reaching out of the frame and every direction."""
    rng = np.random.default_rng(21)
    w, h = 64, 48

    def planes():
        return [rng.integers(0, 256, s).astype(np.int32)
                for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]

    ref0, ref1 = planes(), planes()
    yp = rng.integers(0, 256, (h, w)).astype(np.int32)
    lim = 4 * 16 + 3
    hp = rng.integers(-(1 << 13), 1 << 14, (2, 100)).astype(np.int32)
    _eq(tinter.bi_average(_t(hp[0]), _t(hp[1])),
        jax.jit(jinter.bi_average)(hp[0], hp[1]))

    plan = make_intra_plan(w, h, 16, chroma=True)
    by, bx = plan.blocks_y, plan.blocks_x
    mv0, mv1 = (rng.integers(-lim, lim + 1, (by, bx, 2)).astype(np.int32)
                for _ in range(2))
    mv0[0, 0] = (-lim, -lim)
    mv1[-1, -1] = (lim, lim)
    dirs = rng.integers(0, 3, (by, bx)).astype(np.int32)
    for g, w_, n in zip(tsearch.mc_planes_hp(*map(_t, ref0), _t(mv0), plan),
                        jax.jit(lambda a, b, c, m: jsearch.mc_planes_hp(
                            a, b, c, m, plan))(*ref0, mv0), "yuv"):
        _eq(g, w_, f"mc_planes_hp {n}")
    got = tsearch.bi_mc_planes(tuple(map(_t, ref0)), tuple(map(_t, ref1)),
                               _t(mv0), _t(mv1), _t(dirs), plan)
    want = jax.jit(lambda r0, r1, a, b, d: jsearch.bi_mc_planes(
        r0, r1, a, b, d, plan))(tuple(ref0), tuple(ref1), mv0, mv1, dirs)
    for g, w_, n in zip(got, want, "yuv"):
        _eq(g, w_, f"bi_mc_planes {n}")

    h8, w8 = h // 8, w // 8
    c0, c1 = (rng.integers(-lim, lim + 1, (6, h8, w8, 2)).astype(np.int32)
              for _ in range(2))
    cd = rng.integers(0, 3, (6, h8, w8)).astype(np.int32)
    assert set(np.unique(cd[0])) == {0, 1, 2}
    got = tsearch.bi_mc_planes_cells(tuple(map(_t, ref0)),
                                     tuple(map(_t, ref1)), _t(c0[0]),
                                     _t(c1[0]), _t(cd[0]))
    want = jax.jit(jsearch.bi_mc_planes_cells)(tuple(ref0), tuple(ref1),
                                               c0[0], c1[0], cd[0])
    for g, w_, n in zip(got, want, "yuv"):
        _eq(g, w_, f"bi_mc_planes_cells {n}")
    _eq(tsearch.merge_satd_maps_b(_t(yp), _t(ref0[0]), _t(ref1[0]),
                                  _t(cd[:5]), _t(c0[:5]), _t(c1[:5]),
                                  _t(cd[5]), _t(c0[5]), _t(c1[5])),
        jax.jit(jsearch.merge_satd_maps_b)(yp, ref0[0], ref1[0], cd[:5],
                                           c0[:5], c1[:5], cd[5], c0[5],
                                           c1[5]))


def test_b_deblocking_strengths_match_jax():
    """compute_bs_maps_b on a random fixed grid and var_bs_maps with the
    B fields on a random tree (its TU edges), every bS value."""
    rng = np.random.default_rng(5)
    by, bx = 6, 8
    inter = rng.random((by, bx)) < 0.8
    cbf = rng.random((by, bx)) < 0.3
    dirs = rng.integers(0, 3, (by, bx)).astype(np.int32)
    mv0, mv1 = (rng.integers(-6, 7, (by, bx, 2)).astype(np.int32)
                for _ in range(2))
    got = tfe.compute_bs_maps_b(_t(inter), _t(cbf), _t(dirs), _t(mv0),
                                _t(mv1))
    want = jax.jit(jfe.compute_bs_maps_b)(inter, cbf, dirs, mv0, mv1)
    for g, w_ in zip(got, want):
        _eq(g, w_)
    assert {0, 1, 2} <= set(np.unique(got[0].numpy()))

    size8 = random_tree(rng, 16, 24)
    ev, eh = tqt.var_edge_masks(size8)
    inter8, m0, m1, d8 = random_fields(rng, size8)
    inter8 = inter8.astype(bool)
    d8 = d8.astype(np.int32)
    cbf8 = rng.random(size8.shape) < 0.2
    got = tqt.var_bs_maps(_t(inter8), _t(cbf8), _t(m0), _t(ev), _t(eh),
                          mv1_cells=_t(m1), dirs8=_t(d8))
    want = jax.jit(lambda *a: jqt.var_bs_maps(*a[:5], mv1_cells=a[5],
                                              dirs8=a[6]))(
        inter8, cbf8, m0, ev, eh, m1, d8)
    for g, w_ in zip(got, want):
        _eq(g, w_)
    assert {0, 1, 2} <= set(np.unique(got[0].numpy()))


# ---- 2. B candidate lists --------------------------------------------

def _b_fields(rng, size8):
    """random_fields of a tree, then about half of the CUs take the
    motion (direction and both MVs) of their left neighbour A1, so that
    merge candidates match."""
    inter8, mv0, mv1, dirs = random_fields(rng, size8)
    h8, w8 = size8.shape
    for y in range(h8):
        for x in range(1, w8):
            c = int(size8[y, x]) // 8
            a1 = (y + c - 1, x - 1)
            if (y % c or x % c or y + c > h8 or not inter8[a1]
                    or rng.random() < 0.5):
                continue
            box = (slice(y, y + c), slice(x, x + c))
            inter8[box], dirs[box] = 1, dirs[a1]
            mv0[box], mv1[box] = mv0[a1], mv1[a1]
    return inter8, mv0, mv1, dirs


@pytest.mark.parametrize("seed", range(3))
def test_var_b_signalling_matches_oracles(seed):
    """The copied merge_amvp_var_b_vec == its scalar decode-order oracle
    (copied too) and the JAX module's; var_b_derive == JAX's."""
    rng = np.random.default_rng(400 + seed)
    size8 = random_tree(rng, 16, 24)
    inter8, mv0, mv1, dirs = _b_fields(rng, size8)
    for poc, refs in ((2, (0, 4)), (6, (4, 8)), (1, (0, 2))):
        vec = tcands.merge_amvp_var_b_vec(size8, inter8, dirs, mv0, mv1,
                                          poc, refs)
        for g, r, j, n in zip(vec, tcands.merge_amvp_var_b_scalar(
                size8, inter8, dirs, mv0, mv1, poc, refs),
                jcands.merge_amvp_var_b_vec(size8, inter8, dirs, mv0, mv1,
                                            poc, refs),
                ("merge8", "mvp8", "mvd8", "mvp8_l1", "mvd8_l1")):
            _eq(g, r, n)
            _eq(g, j, n)
        assert (vec[0] >= 0).any() and ((vec[0] < 0) & (inter8 != 0)).any()
        d = tcands.var_b_derive(size8, inter8, dirs, mv0, mv1, poc, refs)
        want = jcands.var_b_derive(size8, inter8, dirs, mv0, mv1, poc, refs)
        assert sorted(d) == sorted(want)
        for k in want:
            if k == "amvp":
                for lst in (0, 1):
                    for a, b in zip(d[k][lst], want[k][lst]):
                        _eq(a, b, f"amvp {lst}")
            else:
                _eq(d[k], want[k], k)


def test_inter_cands_copies_every_jax_function():
    names = {n for n, v in vars(jcands).items() if callable(v)
             and getattr(v, "__module__", "") == jcands.__name__}
    assert names == {n for n, v in vars(tcands).items() if callable(v)
                     and getattr(v, "__module__", "") == tcands.__name__}


# ---- 3. per-picture QP and lambda ------------------------------------

def test_frame_lambda_matches_jax():
    """frame_lambda of every GOP entry (GOP 4 and 8) and slice type, and
    the frame QP / lambdas a variable-tree encoder derives from them (the
    JAX encoder's _var_frame_qp_lam); with neither override the config's
    QP, its I-frame lambda and the search lambda."""
    assert GOP_TABLES == JAX_GOP_TABLES
    cfg = config_from_preset("medium", width=64, height=64, qp=27)
    port = tfe.IntraFrameEncoder(cfg, device="cpu")
    jax_enc = jfe.IntraFrameEncoder(jax_preset("medium", width=64,
                                               height=64, qp=27))
    assert port._var_frame_qp_lam() == jax_enc._var_frame_qp_lam(
        None, None, SLICE_P)
    for gop, table in GOP_TABLES.items():
        for period in (0, 2 * gop):
            for _off, _l0, l1, qp_off, fac in table:
                for qp in (0, 12, 27, 40, 51):
                    for st in (SLICE_B, SLICE_P, SLICE_I):
                        for kf in (False, True):
                            args = (qp + qp_off, st, gop, period, fac, kf)
                            assert tfe.frame_lambda(*args) == \
                                jfe.frame_lambda(*args)
                st = SLICE_P if l1 is None else SLICE_B
                port.cfg.gop_len = jax_enc.cfg.gop_len = gop
                port.cfg.intra_period = jax_enc.cfg.intra_period = period
                assert port._var_frame_qp_lam(27 + qp_off, fac, st) == \
                    jax_enc._var_frame_qp_lam(27 + qp_off, fac, st)
    assert tfe.frame_lambda(30, SLICE_P) == jfe.frame_lambda(30, SLICE_P)


_FMA_JIT = {}


@pytest.mark.parametrize("traced", [True, False])
def test_bi_check_cost_is_one_fma(traced):
    """cbi = satd + lambda * rate, the bi-pred check of both B searches:
    XLA's CPU backend fuses it into one multiply-add, with the lambda
    traced (search_quadtree_b) and as a constant (the fixed grid's
    lambda_me); the port's form equals it on inputs where two roundings
    differ."""
    rng = np.random.default_rng(8)
    satd = rng.integers(0, 1 << 16, 4096).astype(np.int32)
    rate = rng.integers(4, 80, 4096).astype(np.float32)
    lam = 5.039684199579493
    if traced not in _FMA_JIT:
        if traced:
            _FMA_JIT[traced] = jax.jit(
                lambda s, l, r: s.astype(jnp.float32) + l * r)
        else:
            _FMA_JIT[traced] = jax.jit(
                lambda s, l, r: s.astype(jnp.float32) + lam * r)
    want = np.asarray(_FMA_JIT[traced](satd, jnp.float32(lam), rate))
    got = tquant._fma_f32(_t(satd).to(torch.float32), lam, _t(rate))
    _eq(got, want)
    twice = _t(satd).to(torch.float32) + _t(rate) * tquant._f32(lam)
    assert int(twice.ne(got).sum()) > 0


# ---- 4. stream A: variable trees, open GOP ---------------------------

def _check_var_b_frame(port, results, jax_enc, frames):
    """The B frame at POC 2 (layer QP 34, references POC 0 and 4):
    search_quadtree_b (costs, modes, both lists' MVs, dirs, inter maps,
    64 level included) == the stream's compiled JAX search; the tree and
    the cell fields; the B merge RD == JAX's (its compiled SATD maps);
    the recon program (bi MC, direct pass, wavefront, B bS, deblocking
    at the frame QP) == JAX's on the same schedule; the signalling ==
    the scalar oracle and JAX's."""
    ife, jax_intra = port._intra, jax_enc._intra
    poc, (poc0, poc1) = 2, (0, 4)
    qp_off, fac = 2, 0.3536
    ql = ife._var_frame_qp_lam(32 + qp_off, fac, SLICE_B)
    assert ql == jax_intra._var_frame_qp_lam(32 + qp_off, fac, SLICE_B)
    frame_qp, lam_rd, lam_satd = ql
    planes = tuple(a[0] for a in ife._upload(
        ife.host_pack_sources([frames[poc]])))
    r0, r1 = _recon_of(results, poc0), _recon_of(results, poc1)
    yp, cbp, crp = (p.numpy() for p in planes)
    vec = jax_intra._var_b_search()(
        jnp.asarray(yp), jnp.asarray(r0[0].numpy()),
        jnp.asarray(r1[0].numpy()), jnp.float32(lam_satd),
        jnp.int32(frame_qp), jnp.float32(lam_rd), jax_intra._var_dconsts())
    want = tuple({k: np.asarray(v) for k, v in d.items()}
                 for d in jfe._unpack_host_tree(
                     vec, jax_intra._qt_search_b_spec))
    got = ife.var_b_search(planes[0], r0[0], r1[0], ql)
    names = ("costs", "modes", "mv0", "mv1", "dirs", "imaps")
    for g, w_, what in zip(got, want, names):
        assert sorted(g) == sorted(w_), what
        for s in w_:
            _eq(g[s], w_[s], f"{what} {s}")
    assert 64 in want[0]
    assert any(set(np.unique(w_[want[5][s]])) >= {0, 1}
               for s, w_ in want[4].items())
    size8, sched_size8, mode_maps, inter8, dirs8, emv0, emv1, vp = \
        ife.var_b_plan(*got, ql)
    _eq(size8, jqt.choose_tree(want[0], ife.coded_w, ife.coded_h, lam_rd,
                               0.0, jqt.SPLIT_FLAG_BINS))
    assert len(np.unique(size8)) >= 2 and inter8.any() and (~inter8).any()
    fields = jqt.build_cell_fields(size8, want[5], want[2],
                                   (want[3], want[4]))
    _eq(inter8, fields[0])
    _eq(dirs8, fields[3])
    refs = (0, 4)
    new = ife.merge_rd_b(planes[0], r0[0], r1[0], size8, inter8, dirs8,
                         emv0, emv1, poc, refs, ql)
    jnew = jax_intra._merge_rd_b(yp, jnp.asarray(r0[0].numpy()),
                                 jnp.asarray(r1[0].numpy()), size8, inter8,
                                 dirs8, emv0, emv1, poc, refs, lam_satd)
    for g, w_, n in zip(new, jnew, ("dirs8", "emv0", "emv1")):
        _eq(g, w_, f"merge rd {n}")
    dirs8, emv0, emv1 = new
    sched = ife.var_b_sched(vp, planes, size8, inter8, dirs8, emv0, emv1)
    recs, levels = ife.var_recon_b(sched, r0, r1, ql)
    jsched, _ = jax_intra._var_inter_sched(vp, yp, cbp, crp, size8, inter8,
                                           emv0)
    jsched["mv1_cells"] = jnp.asarray(emv1)
    jsched["dirs8"] = jnp.asarray(np.where(inter8, dirs8, 0).astype(
        np.int32))
    jsched["qp"] = jnp.int32(frame_qp)
    jsched["lam"] = jnp.float32(lam_rd)
    jr0, jr1 = (tuple(jnp.asarray(p.numpy()) for p in r) for r in (r0, r1))
    dy, dcb, dcr, lv_flat = jax_intra._var_recon_inter_fn(vp.n_steps, True)(
        jsched, jr0, jr1, jax_intra._var_dconsts())
    for g, w_, n in zip(recs, (dy, dcb, dcr), "yuv"):
        _eq(g.to(torch.int32), np.asarray(w_).astype(np.int32), f"rec {n}")
    _eq(torch.cat([lv.reshape(-1) for lv in levels]), lv_flat, "levels")
    mcs = tsearch.bi_mc_planes_cells(r0, r1, sched["mv_cells"],
                                     sched["mv1_cells"], sched["dirs8"])
    jmcs = jax.jit(jsearch.bi_mc_planes_cells)(
        jr0, jr1, jsched["mv_cells"], jsched["mv1_cells"], jsched["dirs8"])
    for g, w_, n in zip(mcs, jmcs, "yuv"):
        _eq(g, w_, f"bi_mc_planes_cells {n}")
    sig = tcands.merge_amvp_var_b_vec(size8, inter8, dirs8, emv0, emv1, poc,
                                      refs)
    for g, r, j in zip(sig, tcands.merge_amvp_var_b_scalar(
            size8, inter8, dirs8, emv0, emv1, poc, refs),
            jcands.merge_amvp_var_b_vec(size8, inter8, dirs8, emv0, emv1,
                                        poc, refs)):
        _eq(g, r)
        _eq(g, j)


def test_stream_a_var_open_gop_matches_jax():
    """Stream A through the public Encoders: the coding order, each
    picture's NAL type (IDR, trailing P and B, the CRA at POC 8 and its
    RASL B pictures 6, 5, 7) and QP (the base QP plus the layer's
    offset), bytes, recon and the oracle decode; the B pictures hold
    variable trees with inter, intra and bi-pred CUs; then one B frame's
    stages against the stream's compiled JAX programs."""
    frames = shear_clip(11, 128, 64, seed=7)
    port = Encoder(config_from_preset("medium", **STREAM_A), device="cpu")
    got = _encode(port, frames)
    jax_enc = JaxEncoder(jax_preset("medium", **STREAM_A))
    want = _encode(jax_enc, frames)
    pocs = [g[1].poc for g in got]
    assert pocs == [0, 4, 2, 1, 3, 8, 6, 5, 7, 9, 10]
    slice_nal = {0: 19, 8: 21, 6: 9, 5: 9, 7: 9}
    for g in got:
        assert slice_nal.get(g[1].poc, 1) in _nal_types(g[0])
    assert [g[1].qp for g in got] == [32, 33, 34, 35, 35, 32, 34, 35, 35,
                                      32, 32]
    fds = _check_stream(got, want, port._intra.params, 128, 64)
    b_fds = [fd for g, fd in zip(got, fds) if g[1].poc in (2, 1, 3, 6, 5, 7)]
    assert any(len(np.unique(fd.depth8)) > 1 for fd in b_fds)
    assert any((fd.dir8[fd.inter8 != 0] == 2).any() for fd in b_fds)
    assert any((fd.inter8 == 0).any() for fd in b_fds)
    _check_var_b_frame(port, got, jax_enc, frames)


# ---- 5. stream B: the fixed grid -------------------------------------

def test_stream_b_fixed_gop8_matches_jax():
    """Stream B through the public Encoders: POC order, bytes, recon and
    the oracle decode, some B CU bi-predicted; then the B frame at POC 4
    (QP 32, references POC 0 and 8): the port's search and decision (both
    lists' full search, the bi check, the argmin, the float32 1.02 intra
    bias) == the compiled JAX search of the stream's QP-32 encoder."""
    frames = gop_clip(9, 96, 64)
    port = Encoder(Config(**STREAM_B), device="cpu")
    got = _encode(port, frames)
    jax_enc = JaxEncoder(JaxConfig(**STREAM_B))
    want = _encode(jax_enc, frames)
    assert [g[1].poc for g in got] == [0, 8, 4, 2, 1, 3, 6, 5, 7]
    fds = _check_stream(got, want, port._intra.params, 96, 64)
    assert any((fd.dir8[fd.inter8 != 0] == 2).any() for fd in fds[2:])
    assert any((fd.dir8[fd.inter8 != 0] == 1).any() for fd in fds[2:])

    ife = port._encoders[32]
    yp = ife._upload(ife.host_pack_sources([frames[4]]))[0][0]
    r0, r1 = _recon_of(got, 0), _recon_of(got, 8)
    modes, inter_map, dirs, mv0, mv1 = ife._b_predict(yp, r0[0], r1[0])
    jm, jic, jmv0, jmv1, jdirs, jec = jax_enc._encoders[32]._device_search_b(
        jnp.asarray(yp.numpy()), jnp.asarray(r0[0].numpy()),
        jnp.asarray(r1[0].numpy()))
    jmap = np.asarray(jec) <= np.asarray(jic) * 1.02
    _eq(modes, jm, "modes")
    _eq(inter_map, jmap, "inter map")
    _eq(dirs, np.where(jmap, jdirs, 0), "dirs")
    _eq(mv0, np.where(jmap[..., None], jmv0, 0), "mv0")
    _eq(mv1, np.where(jmap[..., None], jmv1, 0), "mv1")
    assert inter_map.any() and set(np.unique(dirs[inter_map])) == {0, 1, 2}


# ---- 6. presets and gates --------------------------------------------

@pytest.mark.parametrize("preset", ["medium", "slow", "slower", "veryslow",
                                    "placebo"])
def test_preset_default_encodes(preset):
    """The preset's own default (a GOP-8 B pyramid of variable trees)
    passes the gates and encodes an IDR and a GOP on the port."""
    cfg = config_from_preset(preset, width=64, height=64)
    cfg.validate()
    assert cfg.gop_len == 8 and tfe.var_inter(cfg)
    assert tfe.unsupported(cfg) == [] and _unsupported_structure(cfg) == []
    enc = Encoder(cfg, device="cpu")
    assert not enc.can_pipeline()
    frames = gop_clip(9, 64, 64, seed=2)
    out = list(enc.encode_stream(frames))
    assert [o[1].poc for o in out] == [0, 8, 4, 2, 1, 3, 6, 5, 7]
    assert all(len(c) > 0 for c, _, _ in out)


@pytest.mark.parametrize("change,match", [
    (dict(crypto="k"), "selective encryption"),
    (dict(intra_min_cu=16, intra_max_cu=16, inter_min_cu=16,
          inter_max_cu=16, sao=False, rdoq=False, crypto="k"),
     "selective encryption"),
    pytest.param(dict(intra_min_cu=16, intra_max_cu=16, inter_min_cu=16,
                      inter_max_cu=16, sao=False, rdoq=False, gop_len=4,
                      crypto="k"), "selective encryption",
                 id="change2-tr-depth-intra"),
    pytest.param(dict(gop_len=4, crypto="k"), "selective encryption",
                 id="change3-scaling lists")])
def test_what_stays_unported_on_a_gop_raises(change, match):
    cfg = config_from_preset("medium", width=64, height=64)
    for k, v in change.items():
        setattr(cfg, k, v)
    with pytest.raises(NotImplementedError, match=match):
        Encoder(cfg, device="cpu")


@pytest.mark.parametrize("change,match", [
    (dict(tmvp=True), "TMVP"),
    (dict(smp=True, intra_min_cu=16, intra_max_cu=16, inter_min_cu=16,
          inter_max_cu=16), "SMP")])
def test_tmvp_and_smp_on_a_gop_are_refused(change, match):
    """TMVP and SMP are for low-delay structures only (B slices signal
    TMVP off; SMP codes P slices only): the config itself refuses them
    on a GOP, in both packages, and the port's Encoder with it."""
    for config in (Config, JaxConfig):
        cfg = config(width=64, height=64, gop_len=8, **change)
        with pytest.raises(ValueError, match=match):
            cfg.validate()
    with pytest.raises(ValueError, match=match):
        Encoder(Config(width=64, height=64, gop_len=8, **change),
                device="cpu")


def test_reset_stream_needs_a_flushed_gop():
    cfg = Config(width=32, height=32, intra_min_cu=16, intra_max_cu=16,
                 gop_len=4)
    enc = Encoder(cfg, device="cpu")
    frames = gop_clip(3, 32, 32)
    out = [r for f in frames for r in enc.encode(*f)]
    assert [o[1].poc for o in out] == [0]
    with pytest.raises(RuntimeError, match="flush"):
        enc.reset_stream()
    assert [o[1].poc for o in enc.flush()] == [1, 2]
    enc.reset_stream()
    assert [o[1].poc for o in enc.encode(*frames[0])] == [0]
