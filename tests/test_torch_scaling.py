"""Scaling lists (--scaling-list default, --cqmfile) in the port == the
JAX package's, with tolerance 0.

Op cases: (a) the port's copied tables (``ops.scaling``: every size /
intra / component / QP % 6 of the default lists and of a custom cqm)
and its SPS ``scaling_list_data()`` bits; (b) ``quantize``,
``dequantize`` and ``quantize_rdoq`` with the tables at S = 4..32, 8
and 10 bits, at QPs that reach both branches of the scaling-list
dequantizer (sh > 0, and the clip-then-shift one from QP 30 up at 4x4 and
QP 36 up at 8x8); (c) the wavefront reconstruction's plain version (the
CUDA kernel's SL instances are held against it on the card by
``chip_smoke.py``) with the tables, intra and inter, cu 8 / 16 / 32, with
and without RDOQ and sign hiding, against the JAX package's XLA scan;
(d) blocks whose RDOQ decision flips between the float32 orders of JAX's
jitted ``quantize_rdoq`` and of its encoder programs, through JAX's
fixed-grid scan and its jitted variable-tree recon, both of which bake
lambda in as a constant when a scaling list is on (ROADMAP §3).

Streams, one test per JAX reference stream: kvazaar_tpu_torch's
``Encoder`` on CPU tensors against kvazaar_tpu's on its CPU backend,
each picture's bytes, FrameInfo and reconstruction equal, and the JAX
oracle decoder turning the port's stream back into its recon: (s1)
default lists, all-intra cu 16; (s2) a custom cqm, cu 8, QP 37; (s3)
``Config()`` IPPP with default lists; (s4) fixed cu 16 with RDOQ, sign
hiding and a custom cqm; (s5) ``medium --period 1`` with default lists;
(s6) ``medium --gop 0`` with a custom cqm (a variable P tree); (s7)
10-bit cu 16, custom; (s8) cu 4 with a custom cqm and RDOQ; (s9) tiles
2x2 IPPP with default lists; (s10) ``medium`` GOP 4 with a custom cqm:
one B frame's recon against JAX's ``reconstruct_frame_var`` with the
layer encoder's QP and plain lambda, and the stream through the oracle.
Plus the CLI and the configurations that still raise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvazaar_tpu.api as japi
from kvazaar_tpu.bitstream.bits import BitWriter as JaxBitWriter
from kvazaar_tpu.config import Config as JaxConfig
from kvazaar_tpu.config import config_from_preset as jax_preset
from kvazaar_tpu.encoder import frame_encoder as jfe
from kvazaar_tpu.encoder.intra_recon import \
    reconstruct_frames as jax_reconstruct_frames
from kvazaar_tpu.ops import quant as jquant
from kvazaar_tpu.ops import scaling as jscaling
from kvazaar_tpu_torch import Config
from kvazaar_tpu_torch.api import Encoder
from kvazaar_tpu_torch.bitstream.bits import BitWriter
from kvazaar_tpu_torch.config import config_from_preset
from kvazaar_tpu_torch.encoder.frame_encoder import (IntraFrameEncoder,
                                                     qp_to_lambda,
                                                     unsupported)
from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
from kvazaar_tpu_torch.encoder.intra_recon import reconstruct_frames
from kvazaar_tpu_torch.encoder.var_schedule import build_var_plan
from kvazaar_tpu_torch.ops import quant as tquant
from kvazaar_tpu_torch.ops import scaling as tscaling
from kvazaar_tpu_torch.ops.transform import forward_transform
from test_torch_rate_control import _same_streams
from test_torch_slice import _clip, _jit_whole, oracle_decode

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

# Small CPU shapes: one intra-op thread each, so that the xdist
# workers sharing the cores do not oversubscribe them.
torch.set_num_threads(1)

_NAMES = [
    "INTRA4X4_LUMA", "INTRA4X4_CHROMAU", "INTRA4X4_CHROMAV", "INTER4X4_LUMA",
    "INTER4X4_CHROMAU", "INTER4X4_CHROMAV", "INTRA8X8_LUMA",
    "INTRA8X8_CHROMAU", "INTRA8X8_CHROMAV", "INTER8X8_LUMA",
    "INTER8X8_CHROMAU", "INTER8X8_CHROMAV", "INTRA16X16_LUMA",
    "INTRA16X16_CHROMAU", "INTRA16X16_CHROMAV", "INTER16X16_LUMA",
    "INTER16X16_CHROMAU", "INTER16X16_CHROMAV", "INTRA32X32_LUMA",
    "INTER32X32_LUMA"]


def write_cqm(path, seed=7, nxn=False):
    """A cqmfile whose matrices all differ (intra / inter, Y / Cb / Cr,
    each size), entries in 8..80 rising away from DC, DC entries in
    12..30; nxn: the intra 4x4 Cr matrix equals the Cb one (the intra-NxN
    point refuses others, F4 in ROADMAP §3)."""
    rng = np.random.default_rng(seed)
    text = []
    mats = {}
    for name in _NAMES:
        n = 4 if "4X4" in name else 8
        yy, xx = np.mgrid[0:n, 0:n]
        m = 12 + 5 * (yy + xx) * 8 // n + rng.integers(-4, 5, (n, n))
        if nxn and name == "INTRA4X4_CHROMAV":
            m = mats["INTRA4X4_CHROMAU"]
        mats[name] = m
        text.append(name + "\n" + ",".join(
            str(v) for v in np.clip(m, 8, 80).ravel()) + "\n")
        if n == 8 and "8X8" not in name:
            text.append(f"{name}_DC\n{int(rng.integers(12, 31))}\n")
    with open(path, "w") as f:
        f.write("".join(text))
    return str(path)


@functools.lru_cache(maxsize=None)
def _cqm(tmpdir, nxn=False):
    return write_cqm(f"{tmpdir}/custom{'-nxn' if nxn else ''}.cqm", nxn=nxn)


@pytest.fixture(scope="module")
def cqm(tmp_path_factory):
    return _cqm(str(tmp_path_factory.mktemp("cqm")))


@pytest.fixture(scope="module")
def cqm_nxn(tmp_path_factory):
    return _cqm(str(tmp_path_factory.mktemp("cqm")), nxn=True)


def _lists(kind, cqm):
    """(port, JAX) ScalingLists of kind 'default' or 'custom'."""
    if kind == "default":
        return tscaling.ScalingLists("default"), jscaling.ScalingLists(
            "default")
    return tscaling.parse_cqmfile(cqm), jscaling.parse_cqmfile(cqm)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(want), err_msg=msg)


# ---- (a) tables and SPS bits ----

@pytest.mark.parametrize("kind", ["default", "custom"])
def test_tables_and_sps_bits_match_jax(kind, cqm):
    """qc / dqc of every (size, intra, component, qp % 6), the kernel's
    stacked device tables, and scaling_list_data() / the SPS."""
    sl, jsl = _lists(kind, cqm)
    for size in (4, 8, 16, 32):
        for comp in ((0,) if size == 32 else (0, 1, 2)):
            for intra in (True, False):
                _eq(sl.qc(size, intra, comp), jsl.qc(size, intra, comp))
                _eq(sl.dqc(size, intra, comp), jsl.dqc(size, intra, comp))
            for qp in range(22, 28):
                tabs = tquant.scaling_tables(sl, size, comp, qp,
                                             torch.device("cpu"))
                want = (jsl.qc(size, True, comp), jsl.qc(size, False, comp),
                        jsl.dqc(size, True, comp),
                        jsl.dqc(size, False, comp))
                for g, w in zip(tabs, want):
                    _eq(g, w[qp % 6])
    w, jw = BitWriter(), JaxBitWriter()
    tscaling.write_scaling_list_data(w, sl)
    jscaling.write_scaling_list_data(jw, jsl)
    w.rbsp_trailing_bits()
    jw.rbsp_trailing_bits()
    assert w.get_bytes() == jw.get_bytes()
    cfg = dict(width=64, height=64, qp=27, intra_period=1)
    cfg.update(scaling_list="default") if kind == "default" else \
        cfg.update(cqmfile=cqm)
    port = IntraFrameEncoder(Config(**cfg), device="cpu")
    assert port.headers() == jfe.IntraFrameEncoder(JaxConfig(**cfg)).headers()


# ---- (b) the quantizers ----

@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_quantizers_with_tables_match_jax(size, bd, cqm):
    """Transform-range coefficients, intra and inter blocks mixed, the
    custom lists' Cb tables (luma at 32), at QPs 22 and 27 (sh > 0) and 37
    and 51 (sh <= 0 at S = 4 and 8)."""
    sl, jsl = _lists("custom", cqm)
    comp = 0 if size == 32 else 1
    rng = np.random.default_rng(size + bd)
    n = 24
    for qp in (22, 27, 37, 51):
        coeff = (rng.laplace(0, 300, (n, size, size))
                 * rng.random((n, 1, 1)) ** 2).clip(-32768, 32767).astype(
                     np.int32)
        intra = rng.random(n) < 0.5
        tabs = tquant.scaling_tables(sl, size, comp, qp, torch.device("cpu"))
        jqc = (jnp.asarray(jsl.qc(size, True, comp)[qp % 6]),
               jnp.asarray(jsl.qc(size, False, comp)[qp % 6]))
        jdqc = (jnp.asarray(jsl.dqc(size, True, comp)[qp % 6]),
                jnp.asarray(jsl.dqc(size, False, comp)[qp % 6]))
        lv = tquant.quantize(_t(coeff), qp, size, bd, _t(intra), qc=tabs[:2])
        jlv = jquant.quantize(jnp.asarray(coeff), qp, size, bd,
                              jnp.asarray(intra), qc=jqc)
        _eq(lv, jlv, f"quantize qp {qp}")
        _eq(tquant.dequantize(lv, qp, size, bd, dqc=tabs[2:],
                              intra=_t(intra)),
            jquant.dequantize(jlv, qp, size, bd, dqc=jdqc,
                              intra=jnp.asarray(intra)), f"dequant qp {qp}")
        lam = tquant._f32(qp_to_lambda(qp))
        got = tquant.quantize_rdoq(_t(coeff), qp, size, bd, _t(intra),
                                   lam=lam, qc=tabs[:2], dqc=tabs[2:])
        want = jax.jit(lambda c, i: jquant.quantize_rdoq(
            c, qp, size, bd, i, lam=lam, qc=jqc, dqc=jdqc))(
                jnp.asarray(coeff), jnp.asarray(intra))
        _eq(got, want, f"rdoq qp {qp}")
    with pytest.raises(NotImplementedError, match="per-block QP"):
        tquant.quantize(_t(coeff), _t(np.full(n, 30, np.int32)), size, bd,
                        qc=tabs[:2])


# ---- (c) the wavefront's plain version with the tables ----

_JAX_RECON = _jit_whole(jax_reconstruct_frames)

# name: (cu, inter, rdoq, signhide, qp, lists)
RECON_CASES = {
    "cu8-intra-custom-qp37": (8, False, False, False, 37, "custom"),
    "cu8-inter-rdoq-sh-custom": (8, True, True, True, 30, "custom"),
    "cu16-intra-rdoq-sh-default": (16, False, True, True, 27, "default"),
    "cu16-inter-custom-qp37": (16, True, False, False, 37, "custom"),
    "cu32-intra-rdoq-custom": (32, False, True, False, 27, "custom"),
    "cu32-inter-sh-default": (32, True, False, True, 22, "default"),
}


@pytest.mark.parametrize("name", sorted(RECON_CASES))
def test_wavefront_plain_scaling_matches_jax_scan(name, cqm):
    """Two 64x48 frames (64x64 at cu 32) of the seeded clip, random modes
    over all 35, a random inter map with the next frames as MC planes:
    levels and recon equal to the JAX scan's."""
    cu, inter, rdoq, sh, qp, kind = RECON_CASES[name]
    sl, jsl = _lists(kind, cqm)
    rng = np.random.default_rng(len(name))
    w, h = 64, (64 if cu == 32 else 48)
    plan = make_intra_plan(w, h, cu, chroma=True)
    frames = _clip(4, w, h, seed=cu)
    planes = [np.stack([f[k] for f in frames]).astype(np.int32)
              for k in range(3)]
    ys, cbs, crs = (p[:2] for p in planes)
    shape = (2, plan.blocks_y, plan.blocks_x)
    modes = rng.integers(0, 35, shape).astype(np.int32)
    qp_c = jfe.chroma_qp(qp)
    kw = dict(rdoq=rdoq, signhide=sh, lam=qp_to_lambda(qp))
    if inter:
        kw.update(is_inter=rng.random(shape) < 0.5,
                  mc_y=planes[0][2:], mc_cb=planes[1][2:],
                  mc_cr=planes[2][2:])
    want = _JAX_RECON(ys, cbs, crs, modes, plan, qp, qp_c, 8, scaling=jsl,
                      **kw)
    got = reconstruct_frames(
        _t(ys), _t(cbs), _t(crs), _t(modes), plan, qp, qp_c, 8, scaling=sl,
        **{k: _t(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    for key, g, wnt in zip(("rec_y", "lv_y", "rec_cb", "lv_cb", "rec_cr",
                            "lv_cr"), got, want):
        _eq(g, wnt, key)
    assert (got[1] != 0).any()


# ---- (d) RDOQ near-ties inside the constant-lambda programs ----

def _tie_blocks(sl, s, comp, qp, n, seed):
    """n seeded residual blocks (S x S, small amplitudes) whose RDOQ
    levels with the scaling list's tables differ between the float32
    orders of JAX's jitted ``quantize_rdoq`` ("op") and of its encoder
    programs ("grid"), with the two level arrays."""
    rng = np.random.default_rng(seed)
    tabs = tquant.scaling_tables(sl, s, comp, qp, torch.device("cpu"))
    lam = qp_to_lambda(qp)
    found = []
    for _ in range(40):
        if len(found) >= n:
            break
        amp = rng.choice([2, 3, 4, 6], size=(2048, 1, 1))
        r = rng.integers(-8, 9, (2048, s, s)) * (
            rng.random((2048, s, s)) < rng.uniform(0.05, 0.6, (2048, 1, 1)))
        r = np.clip(r, -amp, amp).astype(np.int32)
        c = forward_transform(_t(r), s, 8)
        op, grid = (tquant.quantize_rdoq(c, qp, s, 8, True, lam, program=pg,
                                         qc=tabs[:2], dqc=tabs[2:]).numpy()
                    for pg in ("op", "grid"))
        for i in np.flatnonzero((op != grid).reshape(len(r), -1).any(1)):
            found.append((r[i], op[i], grid[i]))
    assert len(found) >= n
    return found[:n]


def test_rdoq_near_ties_in_fixed_grid_scan_match_jax():
    """Near-tie blocks as the first block of each tile of a 2x2-tiled cu
    16 plan (no neighbours: DC predicts mid-grey), reconstructed by
    JAX's scan jitted with the default lists and a constant lambda, as
    its fixed-grid programs run it, and by the port's plain twin (near
    ties are rarer under the custom test lists, whose steps are
    coarser)."""
    sl, jsl = _lists("default", None)
    w = h = 128
    qp, cu = 27, 16
    plan = make_intra_plan(w, h, cu, chroma=False, tiles=(2, 2))
    spots = [(f, by, bx) for f in range(2)
             for by, bx in ((0, 0), (0, 4), (4, 0), (4, 4))]
    ties = _tie_blocks(sl, cu, 0, qp, len(spots), seed=3)
    ys = np.full((2, h, w), 128, np.int32)
    for (f, by, bx), (r, _op, _grid) in zip(spots, ties):
        ys[f, by * cu:(by + 1) * cu, bx * cu:(bx + 1) * cu] += r
    modes = np.ones((2, plan.blocks_y, plan.blocks_x), np.int32)
    lam = qp_to_lambda(qp)
    want = _JAX_RECON(ys, None, None, modes, plan, qp, 29, 8, rdoq=True,
                      lam=lam, scaling=jsl)
    got = reconstruct_frames(_t(ys), None, None, _t(modes), plan, qp, 29, 8,
                             rdoq=True, lam=lam, scaling=sl)
    _eq(got[1], want[1], "levels")
    lv = np.asarray(want[1])
    for (f, by, bx), (_r, _op, grid) in zip(spots, ties):
        _eq(lv[f, by * plan.blocks_x + bx], grid, f"block {f, by, bx}")


@pytest.mark.parametrize("size", [8, 16])
def test_rdoq_near_ties_in_var_recon_program_match_jax(size):
    """Near-tie blocks as the top-left CU of a 32x32 frame of size x size
    CUs (no neighbours: DC predicts mid-grey), through the JAX encoder's
    jitted variable-tree recon program with the default lists (QP and
    lambda baked in) and the port's var recon: the kept costs' group
    sums in the encoder programs' order, lambda times the rate rounded
    on its own (no block was found where that rounding alone differs
    from the fused multiply-add)."""
    sl, _jsl = _lists("default", None)
    qp = 27
    kw = dict(width=32, height=32, qp=qp, intra_min_cu=8, intra_max_cu=32,
              intra_period=1, rdoq=True, scaling_list="default",
              deblock=False)
    jenc = jfe.IntraFrameEncoder(JaxConfig(**kw))
    port = IntraFrameEncoder(Config(**kw), device="cpu")
    size8 = np.full((4, 4), size, np.int32)
    mode_maps = {s: np.ones((32 // s, 32 // s), np.int32)
                 for s in (8, 16, 32)}
    vp = build_var_plan(size8, mode_maps, 32, 32, True)
    ties = _tie_blocks(sl, size, 0, qp, 2, seed=size)
    flips = 0
    for r, op, grid in ties:
        y = np.full((32, 32), 128, np.int32)
        y[:size, :size] += r
        y = y.astype(np.uint8)
        c = np.full((16, 16), 128, np.uint8)
        planes = tuple(None if a is None else a[0] for a in port._upload(
            port.host_pack_sources([(y, c, c)])))
        _recs, levels = port.var_recon(port.var_sched_arrays(vp, planes,
                                                             size8))
        jsched, _ = jenc._var_sched_arrays(
            vp, *(p.numpy() for p in planes), size8)
        *_rec, lv_flat = jenc._var_recon_fn(vp.n_steps)(
            jsched, jenc._var_dconsts())
        lv_flat = np.asarray(lv_flat)
        _eq(torch.cat([lv.reshape(-1) for lv in levels]), lv_flat)
        _eq(lv_flat[:1024].reshape(32, 32)[:size, :size], grid)
        flips += (grid != op).any()
    assert flips == len(ties)


# ---- streams ----

def _both(preset=None, **kw):
    if preset is None:
        return Config(**kw), JaxConfig(**kw)
    return config_from_preset(preset, **kw), jax_preset(preset, **kw)


def _encode_both(cfg, jcfg, frames):
    assert unsupported(cfg) == []
    enc = Encoder(cfg, device="cpu")
    got = list(enc.encode_stream(frames, need_recon=True))
    want = list(japi.Encoder(jcfg).encode_stream(frames, need_recon=True))
    return enc, got, want


def _decodes_to_recon(enc, got, n):
    """The oracle decodes the port's stream to the port's recon."""
    dec = oracle_decode(b"".join(r[0] for r in got), enc._intra.params)
    assert len(dec) == n
    h, w = got[0][2][0].shape
    for ((dy, dcb, dcr), _fd), (_c, info, rec) in zip(dec, got):
        _eq(dy[:h, :w], rec[0], f"decoded POC {info.poc}")
        if rec[1] is not None:
            _eq(dcb[:h // 2, :w // 2], rec[1], f"decoded Cb POC {info.poc}")
            _eq(dcr[:h // 2, :w // 2], rec[2], f"decoded Cr POC {info.poc}")
    return [fd for _r, fd in dec]


def _stream(cfg, jcfg, frames):
    enc, got, want = _encode_both(cfg, jcfg, frames)
    _same_streams(got, want)
    _decodes_to_recon(enc, got, len(frames))
    return enc, got


def test_default_lists_intra_cu16_stream():
    """(s1) Default lists, all-intra fixed cu 16 (SL instance luma 16,
    chroma 8; the native CABAC), 64x64 QP 22; the lists change the
    stream."""
    kw = dict(width=64, height=64, qp=22, intra_min_cu=16, intra_max_cu=16,
              intra_period=1)
    frames = _clip(1, 64, 64, seed=21)
    enc, got = _stream(*_both(scaling_list="default", **kw), frames)
    assert enc._intra._native_cabac()
    flat = list(Encoder(Config(**kw), device="cpu").encode_stream(frames))
    assert got[0][0] != flat[0][0]


def test_custom_cqm_cu8_qp37_stream(cqm):
    """(s2) A custom cqm at fixed cu 8, QP 37: luma 8x8 and chroma 4x4
    TBs dequantize through the clip-then-shift branch."""
    _stream(*_both(width=64, height=48, qp=37, intra_min_cu=8,
                   intra_max_cu=8, intra_period=1, cqmfile=cqm),
            _clip(1, 64, 48, seed=22))


def test_default_lists_config_ippp_stream():
    """(s3) ``Config()`` IPPP (cu 32, the pipelined P path) with the
    default lists: inter blocks take the inter tables."""
    _stream(*_both(width=64, height=64, qp=27, intra_period=0,
                   scaling_list="default"), _clip(3, 64, 64, seed=23))


def test_custom_cqm_rdoq_signhide_cu16_stream(cqm):
    """(s4) Fixed cu 16 IPPP with RDOQ, sign hiding and a custom cqm
    (the TQ SL instances)."""
    _stream(*_both(width=64, height=64, qp=27, intra_min_cu=16,
                   intra_max_cu=16, intra_period=0, rdoq=True,
                   signhide=True, cqmfile=cqm), _clip(2, 64, 64, seed=24))


def test_medium_all_intra_default_lists_stream():
    """(s5) ``medium --period 1`` with the default lists: a variable
    intra tree with RDOQ (the constant-lambda program's order) and SAO,
    at 96x96 so that the JAX SAO program is the shared one."""
    from test_torch_sao import share_sao_program
    cfg, jcfg = _both("medium", width=96, height=96, qp=22, intra_period=1,
                      scaling_list="default")
    frames = _clip(1, 96, 96, seed=25)
    enc = Encoder(cfg, device="cpu")
    got = list(enc.encode_stream(frames, need_recon=True))
    jenc = japi.Encoder(jcfg)
    share_sao_program(jenc._intra)
    _same_streams(got, list(jenc.encode_stream(frames, need_recon=True)))
    _decodes_to_recon(enc, got, 1)


def test_medium_ippp_custom_cqm_var_p_stream(cqm):
    """(s6) ``medium --gop 0`` (variable P trees, RDOQ) with a custom cqm:
    the inter CUs' direct pass with the inter tables; SAO off (s5 runs
    the SAO program)."""
    _stream(*_both("medium", width=64, height=64, qp=27, intra_period=0,
                   gop_len=0, lp_gop=None, ref_frames=1, sao=False,
                   cqmfile=cqm), _clip(2, 64, 64, seed=26))


def test_tenbit_custom_cqm_cu16_stream(cqm):
    """(s7) 10-bit fixed cu 16 IPPP with a custom cqm."""
    rng = np.random.default_rng(27)
    frames = [tuple((p.astype(np.uint16) << 2)
                    | rng.integers(0, 4, p.shape).astype(np.uint16)
                    for p in f) for f in _clip(2, 64, 64, seed=27)]
    _stream(*_both(width=64, height=64, qp=27, intra_min_cu=16,
                   intra_max_cu=16, intra_period=0, input_bitdepth=10,
                   cqmfile=cqm), frames)


def test_nxn_custom_cqm_rdoq_stream(cqm_nxn):
    """(s8) The intra-NxN point (fixed cu 4, DST-VII) with a custom cqm
    and RDOQ: the 4x4 intra tables, luma and chroma (Cr's equal to Cb's:
    F4)."""
    cqm = cqm_nxn
    _stream(*_both(width=64, height=48, qp=30, intra_min_cu=4,
                   intra_max_cu=4, intra_period=1, rdoq=True, cqmfile=cqm),
            _clip(1, 64, 48, seed=28))


def test_tiles_default_lists_ippp_stream():
    """(s9) Tiles 2x2 IPPP (cu 32, tiled SL instances) with the default
    lists."""
    _stream(*_both(width=128, height=128, qp=27, tiles_x=2, tiles_y=2,
                   intra_period=0, scaling_list="default"),
            _clip(2, 128, 128, seed=29))


def test_medium_gop4_custom_cqm_var_b_stream(cqm):
    """(s10) ``medium`` GOP 4 (variable B trees) with a custom cqm: each
    layer QP on a frame encoder of its own (the JAX package's per-QP
    path, no CRA), whose recon takes that encoder's QP and plain lambda
    (JAX's constants) while its search takes the layer's lambda.  The
    port's stream passes the oracle decode, and the B frame at POC 2
    (layer QP 29, references POC 0 and 4) reconstructs as JAX's compiled
    var B recon program of a frame encoder at QP 29 does on the same
    schedule.  SAO off."""
    from kvazaar_tpu_torch.api import GOP_TABLES
    from kvazaar_tpu_torch.constants import SLICE_B
    w = h = 64
    kw = dict(width=w, height=h, qp=27, gop_len=4, intra_period=0,
              sao=False, cqmfile=cqm)
    cfg = config_from_preset("medium", **kw)
    assert unsupported(cfg) == []
    frames = _clip(5, w, h, seed=30)
    enc = Encoder(cfg, device="cpu")
    got = list(enc.encode_stream(frames, need_recon=True))
    fds = _decodes_to_recon(enc, got, 5)
    assert [r[1].poc for r in got] == [0, 4, 2, 1, 3]
    assert [r[1].qp for r in got] == [27, 28, 29, 30, 30]
    assert [r[1].nal_type for r in got[1:]] == [1] * 4
    assert all(fd.inter8.any() for fd in fds[1:])
    # POC 2 on the QP 29 frame encoder, as the stream coded it.
    (off, l0, l1, qp_off, fac), = [e for e in GOP_TABLES[4] if e[0] == 2]
    assert (l0, l1, qp_off) == (2, 2, 2)
    layer = enc._encoders[29]
    jlayer = jfe.IntraFrameEncoder(jax_preset("medium", **dict(kw, qp=29)))
    ql = layer._var_frame_qp_lam(None, fac, SLICE_B)
    assert ql[1] != qp_to_lambda(29)
    with pytest.raises(ValueError, match="per-frame qp override"):
        layer._var_frame_qp_lam(30, fac, SLICE_B)
    planes = tuple(a[0] for a in layer._upload(
        layer.host_pack_sources([frames[2]])))
    r0, r1 = (tuple(_t(p) for p in r[2]) for r in (got[0], got[1]))
    size8, _s8, _mm, inter8, dirs8, emv0, emv1, vp = layer.var_b_plan(
        *layer.var_b_search(planes[0], r0[0], r1[0], ql), ql)
    dirs8, emv0, emv1 = layer.merge_rd_b(planes[0], r0[0], r1[0], size8,
                                         inter8, dirs8, emv0, emv1, 2,
                                         (0, 4), ql)
    assert inter8.any()
    sched = layer.var_b_sched(vp, planes, size8, inter8, dirs8, emv0, emv1)
    recs, levels = layer.var_recon_b(sched, r0, r1, ql)
    jsched, _ = jlayer._var_inter_sched(vp, *(p.numpy() for p in planes),
                                        size8, inter8, emv0)
    jsched["mv1_cells"] = jnp.asarray(emv1)
    jsched["dirs8"] = jnp.asarray(np.where(inter8, dirs8, 0).astype(
        np.int32))
    jr0, jr1 = (tuple(jnp.asarray(p.numpy()) for p in r) for r in (r0, r1))
    dy, dcb, dcr, lv_flat = jlayer._var_recon_inter_fn(vp.n_steps, True)(
        jsched, jr0, jr1, jlayer._var_dconsts())
    for g, w_, n in zip(recs, (dy, dcb, dcr), "yuv"):
        _eq(g.to(torch.int32), np.asarray(w_).astype(np.int32), f"rec {n}")
    _eq(torch.cat([lv.reshape(-1) for lv in levels]), lv_flat, "levels")
    _eq(recs[0], got[2][2][0], "the stream's POC 2")


def test_cli_scaling_lists(tmp_path, cqm):
    """``--scaling-list default`` and ``--cqmfile`` write what
    ``Encoder.encode_stream`` yields."""
    from kvazaar_tpu_torch import cli
    frames = _clip(2, 64, 48, seed=31)
    src = tmp_path / "in.yuv"
    src.write_bytes(b"".join(p.tobytes() for f in frames for p in f))
    for extra in (["--scaling-list", "default"], ["--cqmfile", cqm]):
        out = tmp_path / "out.hevc"
        argv = ["-i", str(src), "--input-res", "64x48", "-o", str(out),
                "-q", "27", "--period", "1", "--set", "intra-min-cu=16",
                "--set", "intra-max-cu=16", "--device", "cpu",
                "--no-psnr"] + extra
        assert cli.main(argv) == 0
        cfg = cli.config_from_args(
            cli.build_argparser().parse_args(argv)).validate()
        assert cfg.scaling_list == ("default" if "--scaling-list" in extra
                                    else "custom")
        want = b"".join(c for c, _, _ in Encoder(
            cfg, device="cpu").encode_stream(frames))
        assert out.read_bytes() == want


@pytest.mark.parametrize("change,match", [
    (dict(lossless=True), "meaningless"),
    (dict(intra_min_cu=4, intra_max_cu=4, transform_skip=True),
     "transform_skip with scaling lists"),
    (dict(aq=1.0), "ROI/AQ"),
    (dict(mesh_tiles=2), "mesh_tiles with scaling lists")])
def test_what_lists_exclude_still_raises(change, match):
    """Lossless, transform skip, ROI / AQ (the configuration) and mesh
    sharding (unported) with a scaling list raise, as in JAX; --bitrate
    falls back to frame-level rate control."""
    kw = dict(width=64, height=128, qp=27, intra_period=1,
              scaling_list="default", **change)
    with pytest.raises((ValueError, NotImplementedError), match=match):
        Encoder(Config(**kw), device="cpu")
    cfg = Config(width=64, height=64, qp=27, intra_period=0, bitrate=300000,
                 scaling_list="default")
    assert not cfg.cu_qp_delta_active and unsupported(cfg) == []


def test_nxn_with_different_chroma_lists_is_refused(cqm, cqm_nxn):
    """F4 (ROADMAP §3): the JAX package's intra-NxN chroma quantizes Cr
    with the Cb tables, and its oracle decodes Cr with Cr's, so with a
    cqm whose intra 4x4 Cb and Cr matrices differ JAX's stream decodes to
    another Cr than its recon.  The port refuses that configuration;
    equal matrices (s8), other CU sizes and 4:0:0 encode."""
    kw = dict(width=64, height=48, qp=30, intra_min_cu=4, intra_max_cu=4,
              intra_period=1)
    frames = _clip(1, 64, 48, seed=28)
    jenc = japi.Encoder(JaxConfig(cqmfile=cqm, **kw))
    want = list(jenc.encode_stream(frames, need_recon=True))
    (dy, dcb, dcr), _fd = oracle_decode(want[0][0], jenc._intra.params)[0]
    _eq(dy[:48, :64], want[0][2][0])
    _eq(dcb[:24, :32], want[0][2][1])
    assert (dcr[:24, :32] != want[0][2][2]).any()
    with pytest.raises(NotImplementedError, match="intra 4x4 Cb and Cr"):
        Encoder(Config(cqmfile=cqm, **kw), device="cpu")
    assert unsupported(Config(cqmfile=cqm_nxn, **kw)) == []
    assert unsupported(Config(cqmfile=cqm, chroma_format=400, **kw)) == []
    assert unsupported(Config(cqmfile=cqm, **dict(
        kw, intra_min_cu=8, intra_max_cu=8))) == []


# The configurations that other test files held as "still raises" for
# scaling lists until they were ported (those cases now name features
# that stay unported): each passes the port's gates and builds.
_FORMERLY_REFUSED = {
    "gop-fixed16": ("medium", dict(intra_min_cu=16, intra_max_cu=16,
                                   inter_min_cu=16, inter_max_cu=16,
                                   sao=False, rdoq=False)),
    "gop-medium": ("medium", {}),
    "lowdelay-ultrafast-gop8-trees": ("ultrafast", dict(
        lp_gop=None, gop_len=8, intra_period=0)),
    "quadtree-8-32": (None, dict(width=96, height=64, qp=27,
                                 intra_min_cu=8, intra_max_cu=32,
                                 intra_period=1)),
    "quadtree-cu4": (None, dict(width=96, height=64, qp=27, intra_min_cu=4,
                                intra_max_cu=4, intra_period=1,
                                rdoq=False)),
    "sao-superfast": ("superfast", dict(intra_period=1, sao=False)),
    "sao-cu4": ("superfast", dict(intra_period=1, sao=False,
                                  intra_min_cu=4, intra_max_cu=4)),
    "slice-gop8-inter8": (None, dict(width=64, height=48, qp=22,
                                     intra_min_cu=16, intra_max_cu=16,
                                     inter_min_cu=8, intra_period=0,
                                     gop_len=8)),
    "slice-all-intra": (None, dict(width=64, height=48, qp=22,
                                   intra_min_cu=16, intra_max_cu=16,
                                   intra_period=1)),
    "slice-gop8-fixed": (None, dict(width=64, height=48, qp=22,
                                    intra_min_cu=16, intra_max_cu=16,
                                    intra_period=0, gop_len=8)),
    "var-p-gop8": (None, dict(width=64, height=64, intra_min_cu=8,
                              intra_max_cu=32, intra_period=0, gop_len=8)),
}


@pytest.mark.parametrize("name", sorted(_FORMERLY_REFUSED))
def test_formerly_refused_configs_now_encode(name):
    preset, kw = _FORMERLY_REFUSED[name]
    kw = dict(kw, scaling_list="default")
    cfg = (Config(**kw) if preset is None else
           config_from_preset(preset, **dict(dict(width=64, height=64),
                                             **kw)))
    assert unsupported(cfg) == []
    enc = Encoder(cfg, device="cpu")
    assert enc._intra.scaling is not None
    assert enc._intra.params.scaling_list_mode == 2


def test_set_base_qp_with_lists_is_refused():
    """F5 (ROADMAP §3): the JAX package's scaling-list programs keep the
    QP they were compiled at, so after ``set_base_qp`` its stream codes
    the new QP over a recon quantized at the old one and decodes to
    another picture.  The port refuses the call with lists on; the
    frame encoder keeps its QP."""
    kw = dict(width=32, height=32, qp=27, intra_period=1, intra_min_cu=8,
              intra_max_cu=16, scaling_list="default")
    frames = _clip(1, 32, 32, seed=3)
    jenc = japi.Encoder(JaxConfig(**kw))
    list(jenc.encode(*frames[0]))
    jenc.set_base_qp(37)
    jenc.reset_stream()
    (chunk, info, rec), = jenc.encode(*frames[0])
    assert info.qp == 37
    (dec, _fd), = oracle_decode(chunk, jenc._intra.params)
    assert any((d[:32, :32] != r).any() for d, r in zip(dec, rec))
    enc = Encoder(Config(**kw), device="cpu")
    with pytest.raises(NotImplementedError, match="set_base_qp"):
        enc.set_base_qp(37)
    assert enc.cfg.qp == enc._intra.cfg.qp == 27
