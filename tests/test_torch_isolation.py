"""The port stands apart from JAX and holds the JAX package's constants.

- importing and running kvazaar_tpu_torch (all-intra and IPPP) never
  imports jax or any kvazaar_tpu module (checked in a fresh
  interpreter), and no source of the port or chip_smoke.py imports
  kvazaar_tpu (checked on the syntax tree);
- every table and constant the port copies equals the JAX package's;
- the kernel module imports on a machine without nvcc, and asking it to
  build the kernel there raises a clear error (no fallback).
"""

import ast
import dataclasses
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = r"""
import sys
import numpy as np
from kvazaar_tpu_torch import Config
from kvazaar_tpu_torch.api import Encoder
rng = np.random.default_rng(0)
frames = [(rng.integers(0, 256, (32, 48), dtype=np.uint8),
           rng.integers(0, 256, (16, 24), dtype=np.uint8),
           rng.integers(0, 256, (16, 24), dtype=np.uint8))
          for _ in range(3)]
for period in (1, 0):
    cfg = Config(width=48, height=32, qp=27, intra_max_cu=16,
                 intra_min_cu=16, intra_period=period)
    out = list(Encoder(cfg, device="cpu").encode_stream(frames))
    assert len(out) == 3 and all(len(c) > 0 for c, _, _ in out)
    assert [o[1].slice_type for o in out] == ([2] * 3 if period
                                              else [2, 1, 1])
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "kvazaar_tpu"))
assert not leaked, leaked
print("NO_JAX_OK")
"""


def test_port_runs_without_importing_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


def _port_sources():
    pkg = os.path.join(REPO, "kvazaar_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_sources_import_no_kvazaar_tpu():
    """Syntax-tree check of every import in the port and chip_smoke.py:
    only kvazaar_tpu_torch, never kvazaar_tpu or jax."""
    bad = []
    n_files = 0
    for path in _port_sources():
        n_files += 1
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("kvazaar_tpu", "jax"):
                    bad.append(f"{os.path.relpath(path, REPO)}:"
                               f"{node.lineno} {name}")
    assert n_files > 20
    assert not bad, bad


@pytest.mark.parametrize("module", [
    "constants", "ops.scan", "ops.inter", "bitstream.contexts",
    "bitstream.headers", "bitstream.syntax", "encoder.inter_cands"])
def test_copied_constants_equal_jax(module):
    """Every upper-case constant of a copied module equals the JAX
    package's constant of the same name."""
    port = importlib.import_module("kvazaar_tpu_torch." + module)
    ref = importlib.import_module("kvazaar_tpu." + module)
    names = [n for n in dir(port) if n.lstrip("_").isupper()
             and not n.startswith("__") and hasattr(ref, n)]
    assert names
    for n in names:
        np.testing.assert_equal(getattr(port, n), getattr(ref, n),
                                err_msg=f"{module}.{n}")


def test_copied_tables_equal_jax_arrays():
    from kvazaar_tpu.ops import deblock as jdeblock
    from kvazaar_tpu.ops import intra as jintra
    from kvazaar_tpu.ops import quant as jquant
    from kvazaar_tpu.ops import transform as jtransform
    from kvazaar_tpu_torch.ops import deblock, intra, quant, transform
    for n in (4, 8, 16, 32):
        np.testing.assert_array_equal(transform.dct_matrix_np(n),
                                      jtransform.dct_matrix_np(n))
    for n in (4, 8, 16):
        for luma in (True, False):
            for got, want in zip(intra.mode_weights_np(n, luma),
                                 jintra.mode_weights_np(n, luma)):
                np.testing.assert_array_equal(got, want)
    for n in (4, 8, 16, 32):
        assert [intra._filter_flag(m, n) for m in range(35)] == \
            [jintra._filter_flag(m, n) for m in range(35)]
    np.testing.assert_array_equal(intra.INTRA_PRED_ANGLE,
                                  jintra.INTRA_PRED_ANGLE)
    np.testing.assert_array_equal(intra.INV_ANGLE, jintra.INV_ANGLE)
    np.testing.assert_array_equal(quant.QUANT_SCALES, jquant.QUANT_SCALES)
    np.testing.assert_array_equal(quant.INV_QUANT_SCALES,
                                  jquant.INV_QUANT_SCALES)
    for qp in range(52):
        for log2n in (2, 3, 4, 5):
            assert quant.quant_params(qp, log2n, 8) == \
                jquant.quant_params(qp, log2n, 8)
    np.testing.assert_array_equal(deblock.TC_TABLE, jdeblock.TC_TABLE)
    np.testing.assert_array_equal(deblock.BETA_TABLE, jdeblock.BETA_TABLE)
    for qp in range(52):
        assert deblock.luma_params(qp, 0, 0, 8) == \
            jdeblock.luma_params(qp, 0, 0, 8)


def test_copied_helpers_equal_jax():
    from kvazaar_tpu.api import FrameInfo as JaxFrameInfo
    from kvazaar_tpu.encoder import frame_encoder as jfe
    from kvazaar_tpu.encoder.geometry import make_intra_plan
    from kvazaar_tpu.encoder.intra_recon import \
        blocks_to_plane as jax_blocks_to_plane
    from kvazaar_tpu_torch.api import FrameInfo
    from kvazaar_tpu_torch.encoder import frame_encoder as fe
    from kvazaar_tpu_torch.encoder.intra_recon import blocks_to_plane
    for qp in range(52):
        assert fe.chroma_qp(qp) == jfe.chroma_qp(qp)
        assert fe.qp_to_lambda(qp) == jfe.qp_to_lambda(qp)
    rng = np.random.default_rng(1)
    plane = rng.integers(0, 256, (21, 37)).astype(np.uint8)
    for m in (8, 16):
        np.testing.assert_array_equal(fe.pad_to_multiple(plane, m),
                                      jfe.pad_to_multiple(plane, m))
    other = rng.integers(0, 256, plane.shape).astype(np.uint8)
    assert fe.psnr(plane, other) == jfe.psnr(plane, other)
    plan = make_intra_plan(64, 32, 16, chroma=True)
    blocks = rng.integers(-99, 99, (8, 16, 16)).astype(np.int16)
    np.testing.assert_array_equal(
        blocks_to_plane(blocks, plan, 16, 64, 32),
        jax_blocks_to_plane(blocks, plan, 16, 64, 32))
    assert [f.name for f in dataclasses.fields(FrameInfo)] == \
        [f.name for f in dataclasses.fields(JaxFrameInfo)]
    assert [f.name for f in dataclasses.fields(fe.FrameResult)] == \
        [f.name for f in dataclasses.fields(jfe.FrameResult)]
    from kvazaar_tpu.bitstream.headers import \
        write_version_sei as jax_version_sei
    from kvazaar_tpu_torch.bitstream.headers import write_version_sei
    assert write_version_sei() == jax_version_sei()


def test_kernel_module_without_nvcc(tmp_path, monkeypatch):
    """Import works anywhere; building needs nvcc and says so; a tensor
    on neither CPU nor CUDA is refused rather than computed."""
    from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
    from kvazaar_tpu_torch.ops import wavefront
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(wavefront, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(wavefront, "library_path",
                        lambda: tmp_path / "kernels" / "missing.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wavefront.build()
    plan = make_intra_plan(32, 32, 16, chroma=False)
    before = dict(wavefront.LAUNCHES)
    with pytest.raises(ValueError, match="unsupported device"):
        wavefront.wavefront_recon(
            torch.zeros((1, 32, 32), dtype=torch.int32, device="meta"),
            torch.zeros((1, 2, 2), dtype=torch.int32, device="meta"),
            plan, 16, True, 22)
    assert wavefront.LAUNCHES == before


def test_require_cuda_raises_without_a_card(monkeypatch):
    import kvazaar_tpu_torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kvazaar_tpu_torch.require_cuda()
