"""The port's all-intra variable CU trees == the JAX package's.

kvazaar_tpu_torch (CPU tensors, plain paths) against kvazaar_tpu (CPU
backend, jitted) on the same seeded frames, every comparison exact
(tolerance 0), float costs included:

- ``ops.rate.tb_rate_bits`` at S = 4, 8, 16, 32 on random levels (the
  S = 32 DCT, quant and prediction are pinned in test_torch_ops.py);
- ``search_quadtree``'s per-size costs and modes (rd 1, rd 2, and the
  64 level), through the JAX encoder's own compiled search;
- ``choose_tree`` and ``build_var_plan``, field by field;
- ``reconstruct_frame_var`` (and the var deblock, scalar QP against the
  JAX package's constant QP map) on the same schedule;
- the slice NAL bytes of ``encode_frame_var`` at 96x64 QP27 intra
  8..32 with deblocking on and off, 64x64 intra 16..32, 192x128 QP32
  intra 8..64 on content that picks 64x64 CUs, 96x64 at rd 2, and the
  all-intra ``medium`` (8..32, RDOQ, SAO) and ``slower`` (8..64, rd 2,
  RDOQ, sign hiding, SAO) presets at 96x96 QP22, and the JAX oracle
  decoder turning each port stream into the port's recon (post-SAO);
- ``Encoder.encode_stream`` == ``encode`` and the CLI on a var config;
  field sources and selective encryption (also at cu 4, and with TMVP)
  still raise.

Each JAX reference encoder is built and run once per case (cached), so
each config compiles once; the SAO cases share one compiled JAX SAO
program with test_torch_sao.py (``share_sao_program``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvazaar_tpu.config import Config as JaxConfig
from kvazaar_tpu.config import config_from_preset as jax_preset
from kvazaar_tpu.encoder import frame_encoder as jfe
from kvazaar_tpu.encoder import quadtree as jqt
from kvazaar_tpu.encoder.var_schedule import build_var_plan as jax_build
from kvazaar_tpu.ops import rate as jrate
from kvazaar_tpu_torch import Config
from kvazaar_tpu_torch.api import Encoder
from kvazaar_tpu_torch.config import config_from_preset
from kvazaar_tpu_torch.encoder import quadtree as tqt
from kvazaar_tpu_torch.encoder.frame_encoder import IntraFrameEncoder
from kvazaar_tpu_torch.ops import rate as trate
from test_quadtree import _mixed_frame, _smooth_plus_noise
from test_torch_sao import share_sao_program
from test_torch_slice import oracle_decode

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

# Small CPU shapes: one intra-op thread each, so that the xdist
# workers sharing the cores do not oversubscribe them.
torch.set_num_threads(1)

# name -> (width, height, frame maker, config fields)
CASES = {
    "8-32": (96, 64, lambda: _mixed_frame(96, 64),
             dict(qp=27, intra_min_cu=8, intra_max_cu=32, deblock=True)),
    "8-32-nodbk": (96, 64, lambda: _mixed_frame(96, 64),
                   dict(qp=27, intra_min_cu=8, intra_max_cu=32,
                        deblock=False)),
    "16-32": (64, 64, lambda: _mixed_frame(64, 64, seed=3),
              dict(qp=27, intra_min_cu=16, intra_max_cu=32)),
    "8-64": (192, 128, lambda: _smooth_plus_noise(192, 128),
             dict(qp=32, intra_min_cu=8, intra_max_cu=64)),
    "8-32-rd2": (96, 64, lambda: _mixed_frame(96, 64),
                 dict(qp=27, intra_min_cu=8, intra_max_cu=32, rd=2)),
    # Whole presets at --period 1, at the shape of the shared JAX SAO
    # program (test_torch_sao.W, H).
    "medium": (96, 96, lambda: _mixed_frame(96, 96, seed=5),
               dict(preset="medium", qp=22)),
    "slower": (96, 96, lambda: tuple(
        np.ascontiguousarray(p[:p.shape[0], :p.shape[1] * 3 // 4])
        for p in _smooth_plus_noise(128, 96)), dict(preset="slower", qp=22)),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


def _kw(name):
    w, h, _frame, fields = CASES[name]
    return dict(width=w, height=h, intra_period=1, wpp=True, **fields)


def _configs(name):
    """(JAX config, port config) of a case, from its preset if it names
    one."""
    kw = _kw(name)
    preset = kw.pop("preset", None)
    if preset is None:
        return JaxConfig(**kw), Config(**kw)
    return jax_preset(preset, **kw), config_from_preset(preset, **kw)


# Cases whose JAX encoder reuses another case's compiled program, which
# is the same program: deblocking does not enter the search, nor --rd
# the reconstruction.
_SHARED = {"8-32-nodbk": ("8-32", "search"), "8-32-rd2": ("8-32", "recon")}


@functools.lru_cache(maxsize=None)
def _encoded(name):
    """(frame, JAX encoder, JAX result, port encoder, port result) of
    one case, shared by its tests."""
    frame = CASES[name][2]()
    jax_cfg, port_cfg = _configs(name)
    jax_enc = jfe.IntraFrameEncoder(jax_cfg)
    if jax_cfg.sao:
        share_sao_program(jax_enc)
    if name in _SHARED:
        base_name, program = _SHARED[name]
        base = _encoded(base_name)[1]
        if program == "search":
            jax_enc._qt_search = base._var_search_fn()
            jax_enc._qt_search_spec = base._qt_search_spec
        else:
            jax_enc._var_recon_fn = base._var_recon_fn
    port = IntraFrameEncoder(port_cfg, device="cpu")
    return (frame, jax_enc, jax_enc.encode_frame(*frame), port,
            port.encode_frame(*frame))


def _jax_search(jax_enc, yp):
    """The JAX encoder's compiled var search (as encode_frame_var calls
    it): (costs, modes) dicts of numpy grids."""
    cfg = jax_enc.cfg
    vec = jax_enc._var_search_fn()(
        jnp.asarray(yp), jnp.int32(cfg.qp),
        jnp.float32(jax_enc.lambda_satd),
        jnp.float32(jfe.qp_to_lambda(cfg.qp)), jax_enc._var_dconsts())
    costs, modes = jfe._unpack_host_tree(vec, jax_enc._qt_search_spec)
    return ({k: np.asarray(v) for k, v in costs.items()},
            {k: np.asarray(v) for k, v in modes.items()})


def _port_planes(port, frame):
    return tuple(None if a is None else a[0] for a in port._upload(
        port.host_pack_sources([frame])))


@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_tb_rate_bits_matches_jax(size):
    """float32 rate of random levels (dense, sparse, empty TBs and TBs
    zero beyond their first rows): equal to the JAX function with
    tolerance 0, although three of its sums add non-dyadic constants
    whose float32 value depends on the order of the additions."""
    rng = np.random.default_rng(size)
    n = 400
    dens = rng.uniform(0, 1, (n, 1, 1))
    mag = rng.geometric(0.4, (n, size, size)) * (
        rng.uniform(0, 1, (n, size, size)) < dens)
    lv = (mag * rng.choice([-1, 1], (n, size, size))).astype(np.int32)
    lv[::7] = 0
    lv[::5, size // 2:, :] = 0
    got = trate.tb_rate_bits(_t(lv))
    assert got.dtype == torch.float32
    _eq(got, jax.jit(jrate.tb_rate_bits)(jnp.asarray(lv)))


@pytest.mark.parametrize("name", ["8-32", "8-32-rd2", "8-64"])
def test_search_quadtree_matches_jax(name):
    """Per-size float32 RD costs (tolerance 0) and modes, the 64 level
    included; and the trees the two argmins pick."""
    frame, jax_enc, _want, port, _got = _encoded(name)
    planes = _port_planes(port, frame)
    costs, modes = _jax_search(jax_enc, planes[0].numpy())
    tc, tm = port.var_search(planes[0])
    assert sorted(tc) == sorted(costs) and sorted(tm) == sorted(modes)
    for s in costs:
        assert tc[s].dtype == torch.float32
        _eq(tc[s], costs[s], f"costs {s}")
        _eq(tm[s], modes[s], f"modes {s}")
    lam = jfe.qp_to_lambda(jax_enc.cfg.qp)
    w, h = port.coded_w, port.coded_h
    _eq(tqt.choose_tree(costs, w, h, lam, 0.0, tqt.SPLIT_FLAG_BINS),
        jqt.choose_tree(costs, w, h, lam, 0.0, jqt.SPLIT_FLAG_BINS))
    if name == "8-64":
        assert 64 in costs


@pytest.mark.parametrize("name", ["8-32", "8-64"])
def test_choose_tree_and_plan_match_jax(name):
    """choose_tree on the same costs, then build_var_plan of the tree,
    equal field by field."""
    frame, jax_enc, _want, port, _got = _encoded(name)
    planes = _port_planes(port, frame)
    size8, sched_size8, mode_maps, vp, _cmodes = port.var_tree_plan(
        *port.var_search(planes[0]))
    costs, _ = _jax_search(jax_enc, planes[0].numpy())
    _eq(size8, jqt.choose_tree(costs, port.coded_w, port.coded_h,
                               jfe.qp_to_lambda(jax_enc.cfg.qp), 0.0,
                               jqt.SPLIT_FLAG_BINS))
    want = jax_build(sched_size8, mode_maps, port.coded_w, port.coded_h,
                     True)
    assert len(np.unique(size8)) >= 2
    for f in ("n_steps", "n_steps_real", "width", "height", "isteps"):
        assert getattr(vp, f) == getattr(want, f), f
    for kind in ("luma", "chroma"):
        assert sorted(getattr(vp, kind)) == sorted(getattr(want, kind))
        for s, cs in getattr(vp, kind).items():
            rs = getattr(want, kind)[s]
            for f in ("size", "valid", "modes", "x0", "y0", "inter",
                      "avail", "corner_h"):
                _eq(getattr(cs, f), getattr(rs, f), f"{kind} {s} {f}")


@pytest.mark.parametrize("name", ["8-32-nodbk", "8-32", "medium"])
def test_reconstruct_frame_var_matches_jax(name):
    """The plain var-tree wavefront on the port's schedule == the JAX
    encoder's compiled recon program on its schedule of the same plan:
    reconstruction and levels with tolerance 0 (``medium``: with RDOQ);
    with deblocking on, the port's scalar-QP deblock with the var bS
    maps == the JAX program's deblock with a constant QP map."""
    frame, jax_enc, _want, port, _got = _encoded(name)
    planes = _port_planes(port, frame)
    size8, sched_size8, mode_maps, vp, _cmodes = port.var_tree_plan(
        *port.var_search(planes[0]))
    sched = port.var_sched_arrays(vp, planes, sched_size8)
    recs, levels = port.var_recon(sched)
    yp, cbp, crp = (p.numpy() for p in planes)
    jsched, _shapes = jax_enc._var_sched_arrays(vp, yp, cbp, crp,
                                                sched_size8)
    jsched["qp"] = jnp.int32(port.cfg.qp)
    jsched["lam"] = jnp.float32(jfe.qp_to_lambda(port.cfg.qp))
    dy, dcb, dcr, lv_flat = jax_enc._var_recon_fn(vp.n_steps)(
        jsched, jax_enc._var_dconsts())
    for g, w, n in zip(recs, (dy, dcb, dcr), ("y", "cb", "cr")):
        _eq(g.to(torch.int32), np.asarray(w).astype(np.int32), f"rec {n}")
    _eq(torch.cat([lv.reshape(-1) for lv in levels]), lv_flat, "levels")


@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_matches_jax_and_decodes(name):
    """Headers and slice NAL bytes == the JAX encode_frame_var's; the
    recon too; the JAX oracle decoder gives back the port's recon."""
    frame, jax_enc, want, port, got = _encoded(name)
    assert port.headers() == jax_enc.headers()
    assert got.nals == want.nals
    for a, b in ((got.recon_y, want.recon_y), (got.recon_cb, want.recon_cb),
                 (got.recon_cr, want.recon_cr)):
        _eq(a, b)
    depths = np.unique(got.frame_data.depth8)
    assert len(depths) >= 2 or name == "16-32", depths
    if name == "8-64":
        assert 0 in depths, "smooth content should pick 64x64 CUs"
    (dy, dcb, dcr), _fd = oracle_decode(port.headers() + got.nals,
                                        port.params)[0]
    _eq(dy, got.recon_y)
    _eq(dcb, got.recon_cb)
    _eq(dcr, got.recon_cr)


def test_encode_stream_matches_encode():
    """Var trees take the per-frame path of encode_stream: its chunks
    == encode's == AU prefix + the JAX encoder's slice NAL."""
    frame, jax_enc, want, _port, _got = _encoded("16-32")
    frames = [frame, tuple(np.ascontiguousarray(p[::-1]) for p in frame)]
    enc = Encoder(Config(**_kw("16-32")), device="cpu")
    assert not enc.can_pipeline()
    out = list(enc.encode_stream(frames, need_recon=True))
    ref = Encoder(Config(**_kw("16-32")), device="cpu")
    per_frame = [ref.encode(*f)[0] for f in frames]
    assert [o[0] for o in out] == [p[0] for p in per_frame]
    assert out[0][0].startswith(jax_enc.headers())
    assert out[0][0].endswith(want.nals)
    assert [o[1].slice_type for o in out] == [2, 2]
    assert out[0][1].psnr_y == per_frame[0][1].psnr_y


def test_cli_medium_all_intra(tmp_path):
    """python -m kvazaar_tpu_torch --preset medium --period 1 --set
    rdoq=0 --set sao=0 writes the var-tree stream Encoder gives."""
    from kvazaar_tpu_torch import cli
    frame = _mixed_frame(64, 64, seed=3)
    src = tmp_path / "in.yuv"
    src.write_bytes(b"".join(p.tobytes() for p in frame))
    argv = ["-i", str(src), "--input-res", "64x64", "-o",
            str(tmp_path / "out.hevc"), "-q", "27", "--preset", "medium",
            "--period", "1", "--set", "rdoq=0", "--set", "sao=0",
            "--device", "cpu", "--no-psnr"]
    assert cli.main(argv) == 0
    cfg = cli.config_from_args(cli.build_argparser().parse_args(argv))
    assert (cfg.intra_min_cu, cfg.intra_max_cu, cfg.rd) == (8, 32, 1)
    want = b"".join(c for c, _, _ in
                    Encoder(cfg, device="cpu").encode_stream([frame]))
    assert (tmp_path / "out.hevc").read_bytes() == want


@pytest.mark.parametrize("change,match", [
    pytest.param(dict(crypto="k"), "selective encryption",
                 id="change0-scaling lists"),
    pytest.param(dict(source_scan_type=1), "field",
                 id="change1-tr-depth-intra"),
    (dict(intra_period=0, gop_len=8, crypto="k"), "selective encryption"),
    pytest.param(dict(intra_min_cu=4, intra_max_cu=4, rdoq=False,
                      crypto="k"), "selective encryption",
                 id="change3-fixed CU size 4"),
    pytest.param(dict(intra_period=0, tmvp=True, crypto="k"),
                 "selective encryption", id="change4-TMVP")])
def test_unported_var_options_raise(change, match):
    kw = _kw("8-32")
    kw.update(change)
    with pytest.raises(NotImplementedError, match=match):
        Encoder(Config(**kw), device="cpu")
