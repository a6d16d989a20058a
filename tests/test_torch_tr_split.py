"""--tr-depth-intra 1 (one explicit intra TU split level,
split_transform_flag) in the port == the JAX package's, with tolerance 0.

Op cases: ``search_quadtree(tu_split=True)``'s costs, modes and TU-split
costs against the JAX encoder's compiled var search, and
``choose_tree(tucosts=)`` (the tree and its split flags) on them.

Streams, one test per JAX reference stream, each picture's bytes,
FrameInfo and reconstruction equal to the JAX ``Encoder``'s, and the JAX
oracle decoder turning the port's stream back into its recon: (t1)
all-intra 8..32 at rd 2, 128x64, QP 27 (as tests/test_tr_split.py), some
CUs split; (t2) the flag on a variable-tree IPPP stream at 96x64 (the P
frames' intra CUs code a zero split_transform_flag); (t3) ``--preset
medium --period 1 --tr-depth-intra 1 --rd 3`` at 96x96 (RDOQ, SAO
through ``test_torch_sao.share_sao_program``, split CUs' chroma modes);
(t4) ``--preset faster --tr-depth-intra 1`` at its low-delay GOP; plus
the CLI's --tr-depth-intra.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kvazaar_tpu.api as japi
from kvazaar_tpu.config import Config as JaxConfig
from kvazaar_tpu.config import config_from_preset as jax_preset
from kvazaar_tpu.encoder import frame_encoder as jfe
from kvazaar_tpu.encoder import quadtree as jqt
from kvazaar_tpu_torch import Config
from kvazaar_tpu_torch.api import Encoder
from kvazaar_tpu_torch.config import config_from_preset
from kvazaar_tpu_torch.encoder import quadtree as tqt
from kvazaar_tpu_torch.encoder.frame_encoder import unsupported
from test_torch_intra_nxn import _decodes_to_recon
from test_torch_rate_control import _same_streams
from test_torch_sao import share_sao_program
from test_tr_split import _clip

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

# Small CPU shapes: one intra-op thread each, so that the xdist
# workers sharing the cores do not oversubscribe them.
torch.set_num_threads(1)

T1 = dict(width=128, height=64, qp=27, intra_min_cu=8, intra_max_cu=32,
          intra_period=1, rd=2, tr_depth_intra=1, hash="md5")


def _eq(a, b, msg=""):
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    np.testing.assert_array_equal(a, np.asarray(b), err_msg=msg)


@functools.lru_cache(maxsize=None)
def _streams(name):
    """(frames, port Encoder, its results, JAX Encoder, its results,
    decoded FrameData) of one stream case, shared by its tests."""
    if name == "t1":
        frames = _clip(1, 128, 64)
        cfg, jcfg = Config(**T1), JaxConfig(**T1)
    elif name == "t2":
        w, h = 96, 64
        rng = np.random.default_rng(3)
        base = rng.integers(0, 255, (h + 16, w + 16)).astype(np.uint8)
        frames = [(base[i:i + h, 2 * i:2 * i + w],
                   np.full((h // 2, w // 2), 100, np.uint8),
                   np.full((h // 2, w // 2), 150, np.uint8))
                  for i in range(3)]
        kw = dict(width=w, height=h, qp=30, intra_min_cu=8,
                  intra_max_cu=32, intra_period=0, rd=2, tr_depth_intra=1,
                  hash="md5")
        cfg, jcfg = Config(**kw), JaxConfig(**kw)
    elif name == "t3":
        frames = _clip(2, 96, 96, seed=4)
        kw = dict(width=96, height=96, qp=27, intra_period=1,
                  tr_depth_intra=1, rd=3)
        cfg, jcfg = config_from_preset("medium", **kw), jax_preset("medium",
                                                                  **kw)
    else:
        frames = _clip(3, 96, 96, seed=5)
        kw = dict(width=96, height=96, qp=27, tr_depth_intra=1)
        cfg, jcfg = config_from_preset("faster", **kw), jax_preset("faster",
                                                                  **kw)
    assert unsupported(cfg) == []
    enc = Encoder(cfg, device="cpu")
    got = list(enc.encode_stream(frames, need_recon=True))
    jenc = japi.Encoder(jcfg)
    if jcfg.sao:
        share_sao_program(jenc._intra)
    want = list(jenc.encode_stream(frames, need_recon=True))
    return frames, enc, got, jenc, want, _decodes_to_recon(enc, got, frames)


def test_search_and_tree_with_tu_split_match_jax():
    """t1's first frame: the port's var search with the TU-split costs
    == the JAX encoder's compiled search, and choose_tree(tucosts=) on
    them == the JAX package's (tree and split flags)."""
    frames, enc, _got, jenc, _want, _fds = _streams("t1")
    port, jax_enc = enc._intra, jenc._intra
    yp = port._upload(port.host_pack_sources([frames[0]]))[0][0]
    costs, modes, tucosts = port.var_search(yp)
    vec = jax_enc._var_search_fn()(
        jnp.asarray(yp.numpy()), jnp.int32(T1["qp"]),
        jnp.float32(jax_enc.lambda_satd),
        jnp.float32(jfe.qp_to_lambda(T1["qp"])), jax_enc._var_dconsts())
    jcosts, jmodes, jtucosts = jfe._unpack_host_tree(
        vec, jax_enc._qt_search_spec)
    for name, got, want in (("costs", costs, jcosts),
                            ("modes", modes, jmodes),
                            ("tucosts", tucosts, jtucosts)):
        assert sorted(got) == sorted(want), name
        for s in got:
            _eq(got[s], want[s], f"{name} {s}")
    assert sorted(tucosts) == [16, 32]
    args = ({k: np.asarray(v) for k, v in jcosts.items()}, port.coded_w,
            port.coded_h, jfe.qp_to_lambda(T1["qp"]), 0.0,
            jqt.SPLIT_FLAG_BINS)
    tu = {k: np.asarray(v) for k, v in jtucosts.items()}
    size8, trsplit8 = tqt.choose_tree(*args, tucosts=tu)
    want8, wsplit8 = jqt.choose_tree(*args, tucosts=tu)
    _eq(size8, want8)
    _eq(trsplit8, wsplit8)
    assert trsplit8.any()
    plan = port.var_tree_plan(costs, modes, tucosts)
    _eq(plan[0], size8)
    _eq(plan[5], trsplit8)
    # Split CUs are scheduled as their four half-size TBs.
    _eq(plan[1], np.where(trsplit8 != 0, np.minimum(size8, 32) // 2,
                          np.minimum(size8, 32)))


def test_tr_split_intra_stream():
    """(t1) all-intra variable trees 8..32 at rd 2 with the split
    chosen somewhere."""
    _frames, _enc, got, _jenc, want, fds = _streams("t1")
    _same_streams(got, want)
    assert sum(int(fd.trsplit8.sum()) for fd in fds) > 0


def test_tr_split_ippp_stream():
    """(t2) the flag on a variable-tree IPPP stream: the I tree may
    split, the P trees' intra CUs code the flag as 0."""
    _frames, _enc, got, _jenc, want, _fds = _streams("t2")
    _same_streams(got, want)


def test_tr_split_medium_rd3_stream():
    """(t3) --preset medium --period 1 --tr-depth-intra 1 --rd 3: RDOQ,
    SAO and the split CUs' chroma modes."""
    _frames, _enc, got, _jenc, want, fds = _streams("t3")
    _same_streams(got, want)
    assert sum(int(fd.trsplit8.sum()) for fd in fds) > 0


def test_tr_split_low_delay_gop_stream():
    """(t4) ``--preset faster --tr-depth-intra 1`` at its default
    low-delay GOP (lp-g4d4t1): a variable-tree IDR (8..16, SAO) whose 16
    CUs may split, then two fixed-grid P frames at the QPs of their
    positions, every slice through the Python serializer."""
    _frames, enc, got, _jenc, want, _fds = _streams("t4")
    assert enc.cfg.lp_gop == (4, 4, 1)
    _same_streams(got, want)
    assert len({info.qp for _c, info, _r in got}) > 1


def test_tr_split_cli_encodes(tmp_path):
    """python -m kvazaar_tpu_torch --preset medium --period 1
    --tr-depth-intra 1 writes what Encoder.encode_stream yields for the
    Config its flags build."""
    from kvazaar_tpu_torch import cli
    frames = _clip(1, 64, 64)
    src = tmp_path / "in.yuv"
    src.write_bytes(b"".join(p.tobytes() for f in frames for p in f))
    argv = ["-i", str(src), "--input-res", "64x64", "-o",
            str(tmp_path / "out.hevc"), "-q", "27", "--preset", "medium",
            "--period", "1", "--tr-depth-intra", "1", "--device", "cpu",
            "--no-psnr"]
    assert cli.main(argv) == 0
    cfg = cli.config_from_args(cli.build_argparser().parse_args(argv))
    assert cfg.tr_depth_intra == 1
    want = b"".join(c for c, _, _ in
                    Encoder(cfg, device="cpu").encode_stream(frames))
    assert (tmp_path / "out.hevc").read_bytes() == want
