"""The port's variable-CU P frames (one reference) == the JAX package's.

kvazaar_tpu_torch (CPU tensors, plain paths) against kvazaar_tpu (CPU
backend, jitted) with tolerance 0, float costs included:

- the coarse level of the hierarchical motion search (``box4_mean``,
  ``sad_surfaces_multi``, ``coarse_mv_grids``) and the hint branch of
  ``search_inter_frame`` (lambda traced, as the JAX var program passes
  it), also on content whose SADs tie everywhere (the argmin keeps the
  first candidate, the hint's set before the zero set);
- ``mc_planes_cells`` and ``merge_satd_maps_p`` with MVs reaching out of
  the frame; ``var_bs_maps`` and ``var_edge_masks`` on a random tree;
  the tie rule of ``search_quadtree_p`` (intra costs patched to the
  inter costs in both packages); the copied merge/AMVP and skip
  derivations against their scalar oracles (as tests/test_var_vec.py
  does) and against the JAX module;
- six 3-frame streams of the shear clip of tests/test_var_inter.py
  through the public ``Encoder``, one test each: bytes and recon equal
  to the JAX ``Encoder``'s, and the JAX oracle decoder turns each port
  stream into the port's recon.  On the case's compiled JAX programs,
  ``8-32-md5`` and ``8-64`` also check ``search_quadtree_p`` (costs,
  modes, MVs, inter maps, the 64 level, the tree, ``build_cell_fields``
  and the fused multiply-add of the inter cost: ``er + lam * (rate +
  5)`` is one FMA on XLA's CPU backend, and these inputs tell it from
  two roundings), ``8-32-md5`` and ``sao-rdoq-sh`` the P recon program
  (cell MC, direct inter pass, intra wavefront, var bS, deblocking;
  RDOQ and sign hiding on inter and intra blocks) and
  ``reconstruct_frame_var``'s cbf8, and ``8-32-md5`` a ``set_base_qp``
  + ``reset_stream`` ladder equal to the JAX ladder and to a fresh
  encoder; then the gates.

Each JAX reference stream is encoded once per process, and each case's
checks run in one test, so a test worker compiles a case's JAX programs
once.  JAX encoders of one frame shape share compiled programs where
the programs are the same (QP and lambdas are traced data there) and
the base case already ran in the process: the search programs of the
96x64 8..32 cases, the recon and merge-RD programs of the cases whose
tools agree, one SAO program for the two SAO cases.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvazaar_tpu.api import Encoder as JaxEncoder
from kvazaar_tpu.config import Config as JaxConfig
from kvazaar_tpu.config import config_from_preset as jax_preset
from kvazaar_tpu.encoder import frame_encoder as jfe
from kvazaar_tpu.encoder import inter_cands as jcands
from kvazaar_tpu.encoder import inter_search as jsearch
from kvazaar_tpu.encoder import quadtree as jqt
from kvazaar_tpu.ops import inter as jinter
from kvazaar_tpu_torch import Config
from kvazaar_tpu_torch.api import Encoder, _unsupported_structure
from kvazaar_tpu_torch.config import config_from_preset
from kvazaar_tpu_torch.encoder import frame_encoder as tfe
from kvazaar_tpu_torch.encoder import inter_cands as tcands
from kvazaar_tpu_torch.encoder import inter_search as tsearch
from kvazaar_tpu_torch.encoder import quadtree as tqt
from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
from kvazaar_tpu_torch.ops import inter as tinter
from kvazaar_tpu_torch.ops import quant as tquant
from test_torch_slice import oracle_decode
from test_var_inter import _clip
from test_var_vec import random_fields, random_tree

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

# Small CPU shapes: one intra-op thread each, so that the xdist
# workers sharing the cores do not oversubscribe them.
torch.set_num_threads(1)

# name -> (width, height, clip seed, config fields, the case whose JAX
# programs it reuses and which of them)
CASES = {
    "8-32-md5": (96, 64, 5, dict(qp=32, intra_min_cu=8, intra_max_cu=32,
                                 intra_period=0, hash="md5"), None, ()),
    "merge-amvp": (96, 64, 11, dict(qp=30, intra_min_cu=8, intra_max_cu=32,
                                    intra_period=0), "8-32-md5",
                   ("search", "recon", "merge")),
    "sao-rdoq-sh": (96, 64, 17, dict(qp=32, intra_min_cu=8,
                                     intra_max_cu=32, intra_period=0,
                                     sao=True, rdoq=True, signhide=True),
                    "8-32-md5", ("search", "merge")),
    "8-64": (128, 128, 13, dict(qp=34, intra_min_cu=8, intra_max_cu=64,
                                intra_period=0), None, ()),
    "medium": (96, 64, 5, dict(preset="medium", qp=32, intra_period=0,
                               gop_len=1, ref_frames=1), "sao-rdoq-sh",
               ("isearch", "merge", "sao")),
    "ultrafast": (96, 64, 5, dict(preset="ultrafast", qp=32, lp_gop=None),
                  None, ()),
}

# JAX frame-encoder attributes holding each compiled program.
_PROGRAMS = {
    "isearch": ("_qt_search", "_qt_search_spec"),
    "search": ("_qt_search", "_qt_search_spec", "_qt_search_p",
               "_qt_search_p_spec"),
    "recon": ("_var_recon_fn", "_var_recon_inter_fn"),
    "merge": ("_merge_rd_jit_p",),
    "sao": ("_sao_dev_jit",),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def _configs(name):
    w, h, _seed, fields, _base, _share = CASES[name]
    kw = dict(width=w, height=h, **fields)
    preset = kw.pop("preset", None)
    if preset is None:
        return JaxConfig(**kw), Config(**kw)
    return jax_preset(preset, **kw), config_from_preset(preset, **kw)


def _frames(name):
    w, h, seed = CASES[name][:3]
    return _clip(3, w, h, seed=seed)


def _share(jax_intra, name):
    """Point a JAX frame encoder at the compiled programs of its base
    case, where this process has compiled them already (else it
    compiles its own, the same programs)."""
    base_name, programs = CASES[name][4:]
    if base_name not in _JAX:
        return
    base = _JAX[base_name][0]._intra
    for prog in programs:
        for attr in _PROGRAMS[prog]:
            if hasattr(base, attr) or attr.startswith("_var_recon"):
                setattr(jax_intra, attr, getattr(base, attr))


def _encode(enc, frames):
    return [r for f in frames for r in enc.encode(*f)]


_JAX = {}


def _jax_stream(name):
    """(JAX Encoder, its results) of a case, encoded once per process."""
    if name not in _JAX:
        jax_cfg, _ = _configs(name)
        enc = JaxEncoder(jax_cfg)
        _share(enc._intra, name)
        _JAX[name] = (enc, _encode(enc, _frames(name)))
    return _JAX[name]


@functools.lru_cache(maxsize=None)
def _port_stream(name):
    _, port_cfg = _configs(name)
    enc = Encoder(port_cfg, device="cpu")
    return enc, _encode(enc, _frames(name))


def _moving_pair(rng, w, h, flat=False):
    """A textured reference and a current frame moved by (3, -2) px with
    a little noise; flat: the left half is one grey level (every SAD
    there ties)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    ref = np.clip(128 + 60 * np.sin(xx / 7.0) * np.cos(yy / 5.0)
                  + rng.normal(0, 8, (h, w)), 0, 255).astype(np.int32)
    cur = np.clip(np.roll(ref, (2, -3), (0, 1))
                  + rng.integers(-3, 4, (h, w)), 0, 255).astype(np.int32)
    if flat:
        ref[:, :w // 2] = 100
        cur[:, :w // 2] = 100
    return cur, ref


# ---- 1. the coarse motion search level -------------------------------

@pytest.mark.parametrize("sizes", [(8, 16, 32, 64), (8, 16), (32,)])
def test_coarse_mv_grids_match_jax(sizes):
    """box4_mean, the multi-size SAD surfaces (floor grids: 72 rows give
    a 64 grid of one row) and the per-size hint grids."""
    rng = np.random.default_rng(len(sizes))
    cur, ref = _moving_pair(rng, 128, 72)
    _eq(tinter.box4_mean(_t(cur)), jinter.box4_mean(jnp.asarray(cur)))
    got = tinter.sad_surfaces_multi(_t(cur), _t(ref), 3, (4, 8, 16))
    want = jax.jit(lambda c, f: jinter.sad_surfaces_multi(
        c, f, 3, (4, 8, 16)))(cur, ref)
    assert sorted(got) == sorted(want)
    for s in got:
        _eq(got[s], want[s], f"sad surface {s}")
    got = tinter.coarse_mv_grids(_t(cur), _t(ref), 16, sizes)
    want = jax.jit(lambda c, f: jinter.coarse_mv_grids(c, f, 16, sizes))(
        cur, ref)
    assert sorted(got) == sorted(want) and set(sizes) <= set(got)
    for s in got:
        _eq(got[s], want[s], f"hint {s}")
    assert any(np.abs(g.numpy()).max() > 0 for g in got.values())


# ---- 2. the hint branch of search_inter_frame ------------------------

@pytest.mark.parametrize("cu,flat", [(8, False), (16, False), (8, True)])
def test_hint_search_matches_jax(cu, flat):
    """MVs and float32 costs with the lambda traced; flat: SAD ties over
    the whole left half, so both argmins meet ties between the hint's
    candidates and the zero candidates."""
    rng = np.random.default_rng(cu + flat)
    cur, ref = _moving_pair(rng, 96, 64, flat)
    plan = make_intra_plan(96, 64, cu, chroma=False)
    hint = np.array(jax.jit(lambda c, f: jinter.coarse_mv_grids(
        c, f, 16, (cu,)))(cur, ref)[cu])
    if flat:
        hint[:, :hint.shape[1] // 2] = (8, -12)
    lam = 4.2426406871192848
    mv, cost = tsearch.search_inter_frame(_t(cur), _t(ref), plan, lam, 16,
                                          mv_hint=_t(hint))
    jmv, jcost = jax.jit(lambda c, f, l, h: jsearch.search_inter_frame(
        c, f, plan, l, 16, mv_hint=h))(cur, ref, jnp.float32(lam), hint)
    _eq(mv, jmv, "mv")
    assert cost.dtype == torch.float32
    _eq(cost, jcost, "cost")
    assert np.abs(mv.numpy()).max() > 0


# ---- 3. cell MC and the merge SATD maps ------------------------------

def test_mc_planes_cells_and_merge_maps_match_jax():
    rng = np.random.default_rng(7)
    w, h = 64, 48
    ref = [rng.integers(0, 256, s).astype(np.int32)
           for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    yp = rng.integers(0, 256, (h, w)).astype(np.int32)
    lim = 4 * 16 + 3
    cells = rng.integers(-lim, lim + 1, (4, h // 8, w // 8, 2)).astype(
        np.int32)
    cells[0, 0, 0] = (-lim, -lim)
    cells[0, -1, -1] = (lim, lim)
    got = tsearch.mc_planes_cells(*[_t(p) for p in ref], _t(cells[0]))
    want = jax.jit(jsearch.mc_planes_cells)(*ref, cells[0])
    for g, w_, n in zip(got, want, ("y", "cb", "cr")):
        _eq(g, w_, n)
    _eq(tsearch.merge_satd_maps_p(_t(yp), _t(ref[0]), _t(cells[:3]),
                                  _t(cells[3])),
        jax.jit(jsearch.merge_satd_maps_p)(yp, ref[0], cells[:3],
                                           cells[3]))


# ---- 4. the P search -------------------------------------------------

_TIE_JIT = {}


@pytest.mark.parametrize("tie", [True, False])
def test_search_quadtree_p_tie_goes_to_inter(monkeypatch, tie):
    """imap = er <= ir: with every intra cost set to the inter cost
    (tie) all CUs go inter, one float32 step below it none does, in the
    port and in the JAX search (the intra costs patched the same way in
    both, on a 32x32 frame, CUs 8 and 16; one JAX compile serves both
    cases, the patched costs entering it as arguments)."""
    rng = np.random.default_rng(9)
    cur, ref = _moving_pair(rng, 32, 32)
    lam, lam_rd, qp = 4.2426406871192848, 18.0, 30
    args = (32, 32, lam, 16, 8, (8, 16), (8, 16), True, True, qp, lam_rd)
    hints = tinter.coarse_mv_grids(_t(cur), _t(ref), 16, (8, 16))
    ir = {}
    for s in (8, 16):
        plan = make_intra_plan(32, 32, s, chroma=False)
        er = tqt._inter_cost(_t(cur), _t(ref), plan, hints[s], lam, 16, 8,
                             True, qp, lam_rd)[1].numpy()
        ir[s] = er if tie else np.nextafter(er, -np.inf).astype(np.float32)
    box = {}
    monkeypatch.setattr(tqt, "intra_rd_recost", lambda y, plan, *a, **k:
                        _t(ir[plan.cu_size]))
    monkeypatch.setattr(jqt, "intra_rd_recost", lambda y, plan, *a, **k:
                        box[plan.cu_size])
    if not _TIE_JIT:
        def search(c, f, ir8, ir16):
            box[8], box[16] = ir8, ir16
            return jqt.search_quadtree_p(c, f, *args)
        _TIE_JIT["fn"] = jax.jit(search)
    got = tqt.search_quadtree_p(_t(cur), _t(ref), *args)
    want = _TIE_JIT["fn"](cur, ref, ir[8], ir[16])
    for g, w_, what in zip(got, want, ("costs", "modes", "mvs", "imaps")):
        for s in (8, 16):
            _eq(g[s], w_[s], f"{what} {s}")
    for s in (8, 16):
        assert bool(got[3][s].all() if tie else not got[3][s].any())


# ---- 5. cell fields and the var bS -----------------------------------

def test_var_bs_maps_match_jax():
    """var_bs_maps on a random tree with random inter cells, cbf and MVs
    (every bS value), at its TU edges (var_edge_masks, 64 CUs counting
    their 32x32 TB edges)."""
    rng = np.random.default_rng(3)
    size8 = random_tree(rng, 16, 24)
    ev, eh = tqt.var_edge_masks(size8)
    for g, w_ in zip((ev, eh), jqt.var_edge_masks(size8)):
        _eq(g, w_)
    h8, w8 = size8.shape
    inter8 = rng.random((h8, w8)) < 0.7
    cbf8 = rng.random((h8, w8)) < 0.4
    mv = rng.integers(-6, 7, (h8, w8, 2)).astype(np.int32)
    mv[rng.random((h8, w8)) < 0.5] = (4, -4)
    got = tqt.var_bs_maps(_t(inter8), _t(cbf8), _t(mv), _t(ev), _t(eh))
    want = jax.jit(jqt.var_bs_maps)(inter8, cbf8, mv, ev, eh)
    for g, w_ in zip(got, want):
        _eq(g, w_)
    assert {0, 1, 2} <= set(np.unique(got[0].numpy()))


# ---- 7. merge/AMVP and skip ------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_var_p_signalling_matches_oracles(seed):
    """The copied vectorized merge/AMVP and skip derivations == their
    scalar decode-order oracles (copied too) and the JAX module's."""
    rng = np.random.default_rng(300 + seed)
    h8, w8 = 16, 24
    size8 = random_tree(rng, h8, w8)
    inter8, mv0, _mv1, _d = random_fields(rng, size8)
    vec = tcands.merge_amvp_var_vec(size8, inter8, mv0)
    for g, r, j, n in zip(vec, tcands.merge_amvp_var_scalar(
            size8, inter8, mv0), jcands.merge_amvp_var_vec(
            size8, inter8, mv0), ("merge8", "mvp8", "mvd8")):
        _eq(g, r, n)
        _eq(g, j, n)
    assert (vec[0] >= 0).any() and ((vec[0] < 0) & (inter8 != 0)).any()
    cy = (rng.random((h8 * 8, w8 * 8)) < 0.01).astype(np.int16)
    ccb = (rng.random((h8 * 4, w8 * 4)) < 0.01).astype(np.int16)
    ccr = (rng.random((h8 * 4, w8 * 4)) < 0.01).astype(np.int16)
    skip = tcands.var_skip8_vec(size8, inter8, vec[0], cy, ccb, ccr)
    _eq(skip, tcands.var_skip8_scalar(size8, inter8, vec[0], cy, ccb, ccr))
    _eq(skip, jcands.var_skip8_vec(size8, inter8, vec[0], cy, ccb, ccr))
    d = tcands.var_p_derive(size8, inter8, mv0)
    for k, v in jcands.var_p_derive(size8, inter8, mv0).items():
        _eq(d[k], v, k)
    v = np.arange(-300, 301).reshape(-1, 1)
    _eq(tfe._mvd_bits_np(v), jfe.PFrameMixin._mvd_bits_np(v))
    _eq(tfe.IntraFrameEncoder._MERGE_IDX_BITS,
        jfe.PFrameMixin._MERGE_IDX_BITS)


# ---- whole streams, and each case's search and recon ---------------

def _jax_search_p(jax_intra, yp, ref_y):
    """The JAX encoder's compiled var P search, as submit_var_p calls
    it: (costs, modes, mvs, inter maps) dicts of numpy grids."""
    qp = jax_intra.cfg.qp
    vec = jax_intra._var_p_search()(
        jnp.asarray(yp), jnp.asarray(ref_y), jnp.float32(
            jax_intra.lambda_satd), jnp.int32(qp),
        jnp.float32(jfe.qp_to_lambda(qp)), jax_intra._var_dconsts())
    return tuple({k: np.asarray(v) for k, v in d.items()}
                 for d in jfe._unpack_host_tree(
                     vec, jax_intra._qt_search_p_spec))


def _p_inputs(name):
    """(port frame encoder, JAX frame encoder, source planes (y, cb, cr)
    int32 on the CPU, reference planes uint8) of the case's first P
    frame, against the recon of its I frame."""
    port, results = _port_stream(name)
    ife = port._intra
    planes = tuple(a[0] for a in ife._upload(
        ife.host_pack_sources([_frames(name)[1]])))
    refs = tuple(_t(r) for r in results[0][2])
    return ife, _jax_stream(name)[0]._intra, planes, refs


def _check_search(name):
    """search_quadtree_p == the JAX encoder's compiled search: per-size
    float32 RD costs (tolerance 0), intra modes, MVs and inter maps, the
    64 level included; the trees the two argmins pick; build_cell_fields
    of that tree; and the fused multiply-add of the inter cost: the
    same costs rounded twice differ from JAX's on these inputs."""
    ife, jax_intra, planes, refs = _p_inputs(name)
    cfg = ife.cfg
    want = _jax_search_p(jax_intra, planes[0].numpy(), refs[0].numpy())
    got = ife.var_p_search(planes[0], refs[0])
    for g, w_, what in zip(got, want, ("costs", "modes", "mvs", "imaps")):
        assert sorted(g) == sorted(w_), what
        for s in w_:
            _eq(g[s], w_[s], f"{what} {s}")
    assert (64 in want[0]) == (cfg.inter_max_cu >= 64)
    lam = jfe.qp_to_lambda(cfg.qp)
    size8 = tqt.choose_tree(want[0], ife.coded_w, ife.coded_h, lam, 0.0,
                            tqt.SPLIT_FLAG_BINS)
    _eq(size8, jqt.choose_tree(want[0], ife.coded_w, ife.coded_h, lam,
                               0.0, jqt.SPLIT_FLAG_BINS))
    assert len(np.unique(size8)) >= 2
    for g, w_ in zip(tqt.build_cell_fields(size8, want[3], want[2]),
                     jqt.build_cell_fields(size8, want[3], want[2])):
        _eq(g, w_)
    # The inter candidates' costs from the port's pieces: fused as JAX
    # forms them, and rounded twice.
    y, ref = planes[0], refs[0]
    sizes = [s for s in (8, 16, 32)
             if cfg.inter_min_cu <= s <= cfg.inter_max_cu]
    hints = tinter.coarse_mv_grids(y, ref, cfg.me_range, sizes)
    twice = 0
    for s in sizes:
        plan = make_intra_plan(ife.coded_w, ife.coded_h, s, chroma=False)
        mv, _ = tsearch.search_inter_frame(y, ref, plan, ife.lambda_satd,
                                           cfg.me_range, mv_hint=hints[s])
        er = tqt.inter_rd_grid(y, tqt._mc_blocks_at(ref, mv, s, 8), s,
                               plan.blocks_y, plan.blocks_x, cfg.qp, lam,
                               8)
        bins = tqt._mv_rate_grid(mv) + 1.0 + tqt.OVERHEAD_BINS_INTER
        fused = tquant._fma_f32(er, lam, bins)
        inter = torch.from_numpy(want[3][s])
        _eq(fused[inter], want[0][s][want[3][s]], f"fused inter cost {s}")
        twice += int((er + bins * tquant._f32(lam))[inter].ne(
            fused[inter]).sum())
    return twice


def _check_recon(name):
    """The port's P recon (cell MC, direct pass, wavefront, var bS,
    deblocking) == the JAX encoder's compiled recon program on its
    schedule of the same plan: deblocked recon and levels, tolerance 0;
    and reconstruct_frame_var's raw recon, levels and cbf8 == the JAX
    function's (jitted alone)."""
    ife, jax_intra, planes, refs = _p_inputs(name)
    size8, sched_size8, mode_maps, inter8, mv_cells, vp = ife.var_p_plan(
        *ife.var_p_search(planes[0], refs[0]))
    assert inter8.any() and (~inter8).any()
    sched = ife.var_p_sched(vp, planes, size8, inter8, mv_cells)
    recs, levels = ife.var_recon_p(sched, refs)
    yp, cbp, crp = (p.numpy() for p in planes)
    jsched, _ = jax_intra._var_inter_sched(vp, yp, cbp, crp, size8, inter8,
                                           mv_cells)
    jsched["qp"] = jnp.int32(ife.cfg.qp)
    jsched["lam"] = jnp.float32(jfe.qp_to_lambda(ife.cfg.qp))
    jrefs = tuple(jnp.asarray(r.numpy()) for r in refs)
    dy, dcb, dcr, lv_flat = jax_intra._var_recon_inter_fn(
        vp.n_steps, False)(jsched, jrefs, jrefs, jax_intra._var_dconsts())
    for g, w_, n in zip(recs, (dy, dcb, dcr), ("y", "cb", "cr")):
        _eq(g.to(torch.int32), np.asarray(w_).astype(np.int32), f"rec {n}")
    _eq(torch.cat([lv.reshape(-1) for lv in levels]), lv_flat, "levels")
    assert all((lv != 0).any() for lv in levels)
    if name != "8-32-md5":
        return
    mcs = tsearch.mc_planes_cells(*refs, sched["mv_cells"])
    (ry, rcb, rcr), lvs, cbf8 = tqt.reconstruct_frame_var(
        sched, ife.cfg.qp, ife.qp_c, ife.coded_w, ife.coded_h, True,
        mc_planes=mcs)
    want = jax.jit(lambda sc, m: jqt.reconstruct_frame_var(
        sc, ife.cfg.qp, ife.qp_c, ife.coded_w, ife.coded_h, True,
        mc_planes=m))(jsched, tuple(jnp.asarray(m.numpy()) for m in mcs))
    for g, w_, n in zip((ry, rcb, rcr, *lvs, cbf8),
                        (*want[:3], *want[3], want[4]),
                        ("ry", "rcb", "rcr", "ly", "lcb", "lcr", "cbf8")):
        _eq(g.to(torch.int32), np.asarray(w_).astype(np.int32), n)
    assert cbf8.any() and (~cbf8).any()


def _check_ladder(name):
    """One Encoder over QP 32, 27, 32 (set_base_qp + reset_stream): QP
    27 == the JAX Encoder's ladder == a fresh port Encoder at 27, and
    back at 32 the first stream again."""
    port, first = _port_stream(name)
    jax_enc, _ = _jax_stream(name)
    frames = _frames(name)
    for enc in (port, jax_enc):
        enc.set_base_qp(27)
        enc.reset_stream()
    got = _encode(port, frames)
    want = _encode(jax_enc, frames)
    for enc in (port, jax_enc):
        enc.set_base_qp(32)
        enc.reset_stream()
    _, cfg = _configs(name)
    cfg.qp = 27
    fresh = _encode(Encoder(cfg, device="cpu"), frames)
    assert [g[0] for g in got] == [w_[0] for w_ in want] == \
        [f[0] for f in fresh]
    assert [g[1].qp for g in got] == [27] * 3
    assert got[0][0] != first[0][0]
    assert [g[0] for g in _encode(port, frames)] == [f[0] for f in first]
    port.reset_stream()


@pytest.mark.parametrize("name", list(CASES))
def test_var_p_case_matches_jax(name):
    """IDR + 2 P frames of the case through the public Encoder: each
    frame's bytes and recon == the JAX Encoder's, and the oracle decoder
    gives back the port's recon; the P trees mix CU sizes and carry
    inter CUs, and intra CUs but in ``ultrafast`` (merge and AMVP both
    signalled in ``merge-amvp``, 64 CUs in ``8-64``).  8-32-md5 and 8-64 also check the search, 8-32-md5
    and sao-rdoq-sh the recon (RDOQ and sign hiding on inter and intra
    blocks), and 8-32-md5 the QP ladder, on the case's compiled JAX
    programs."""
    port, got = _port_stream(name)
    _jax, want = _jax_stream(name)
    assert [g[1].slice_type for g in got] == [2, 1, 1]
    for i, (g, w_) in enumerate(zip(got, want)):
        assert g[0] == w_[0], f"frame {i} bytes"
        for a, b in zip(g[2], w_[2]):
            _eq(a, b, f"frame {i} recon")
    w, h = CASES[name][:2]
    dec = oracle_decode(b"".join(g[0] for g in got), port._intra.params)
    assert len(dec) == 3
    for ((dy, dcb, dcr), _fd), g in zip(dec, got):
        for a, b in zip((dy[:h, :w], dcb[:h // 2, :w // 2],
                         dcr[:h // 2, :w // 2]), g[2]):
            _eq(a, b)
    fds = [fd for _planes, fd in dec[1:]]
    assert any(len(np.unique(fd.depth8)) > 1 for fd in fds)
    assert any(fd.inter8.any() for fd in fds)
    if name != "ultrafast":         # intra CUs 16 only: all inter there
        assert any((fd.inter8 == 0).any() for fd in fds)
    if name == "merge-amvp":
        inter = [fd.inter8.astype(bool) for fd in fds]
        assert sum(int((i & (fd.merge8 >= 0)).sum())
                   for i, fd in zip(inter, fds)) > 0, "no merge CU"
        assert sum(int((i & (fd.merge8 < 0)).sum())
                   for i, fd in zip(inter, fds)) > 0, "no AMVP CU"
    if name == "8-64":
        assert any((fd.depth8 == 0).any() for _p, fd in dec)
    if name in ("8-32-md5", "8-64"):
        twice = _check_search(name)
        assert twice > 0 or name == "8-64"
    if name in ("8-32-md5", "sao-rdoq-sh"):
        _check_recon(name)
    if name == "8-32-md5":
        _check_ladder(name)


@pytest.mark.parametrize("name", ["medium --gop 0", "slower --gop 0",
                                  "ultrafast --gop 0", "8..32 IPPP"])
def test_one_reference_var_p_passes_the_gates(name):
    if name == "8..32 IPPP":
        cfg = Config(width=64, height=64, intra_min_cu=8, intra_max_cu=32,
                     intra_period=0)
    elif name.startswith("ultrafast"):
        cfg = config_from_preset("ultrafast", width=64, height=64,
                                 lp_gop=None)
    else:
        cfg = config_from_preset(name.split()[0], width=64, height=64,
                                 intra_period=0, gop_len=1, ref_frames=1)
    cfg.validate()
    assert tfe.var_inter(cfg)
    assert tfe.unsupported(cfg) == [] and _unsupported_structure(cfg) == []
    assert not Encoder(cfg, device="cpu").can_pipeline()


@pytest.mark.parametrize("change,match", [
    (dict(gop_len=8, crypto="k"), "selective encryption"),
    pytest.param(dict(gop_len=4, crypto="k"), "selective encryption",
                 id="change1-tr-depth-intra"),
    pytest.param(dict(tmvp=True, crypto="k"), "selective encryption",
                 id="change2-TMVP"),
    pytest.param(dict(smp=True, intra_min_cu=16, intra_max_cu=16,
                      inter_min_cu=16, inter_max_cu=16, crypto="k"),
                 "selective encryption", id="change3-SMP"),
    (dict(crypto="k"), "selective encryption")])
def test_what_stays_unported_raises(change, match):
    cfg = Config(width=64, height=64, intra_min_cu=8, intra_max_cu=32,
                 intra_period=0)
    for k, v in change.items():
        setattr(cfg, k, v)
    with pytest.raises(NotImplementedError, match=match):
        Encoder(cfg, device="cpu")
    if {"gop_len", "tmvp", "smp"} & set(change):   # itself ported
        cfg.crypto = None
        assert tfe.unsupported(cfg) == _unsupported_structure(cfg) == []
