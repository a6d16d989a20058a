"""The port stands apart from JAX and holds the JAX package's constants.

- importing and running kvazaar_tpu_torch never imports jax (checked in
  a fresh interpreter);
- every table the port copies equals the JAX package's array;
- the kernel module imports on a machine without nvcc, and asking it to
  build the kernel there raises a clear error (no fallback).
"""

import dataclasses
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
import kvazaar_tpu_torch
from kvazaar_tpu.config import Config
from kvazaar_tpu_torch.api import Encoder
rng = np.random.default_rng(0)
frames = [(rng.integers(0, 256, (32, 48), dtype=np.uint8),
           rng.integers(0, 256, (16, 24), dtype=np.uint8),
           rng.integers(0, 256, (16, 24), dtype=np.uint8))
          for _ in range(2)]
cfg = Config(width=48, height=32, qp=27, intra_max_cu=16, intra_min_cu=16,
             intra_period=1)
out = list(Encoder(cfg, device="cpu").encode_stream(frames))
assert len(out) == 2 and all(len(c) > 0 for c, _, _ in out)
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
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


def test_kernel_module_without_nvcc(tmp_path, monkeypatch):
    """Import works anywhere; building needs nvcc and says so; a tensor
    on neither CPU nor CUDA is refused rather than computed."""
    from kvazaar_tpu.encoder.geometry import make_intra_plan
    from kvazaar_tpu_torch.ops import wavefront
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(wavefront, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(wavefront, "library_path",
                        lambda: tmp_path / "kernels" / "missing.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        wavefront.build()
    plan = make_intra_plan(32, 32, 16, chroma=False)
    before = wavefront.LAUNCHES
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
