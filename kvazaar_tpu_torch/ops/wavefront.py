"""Wrapper of the CUDA wavefront reconstruction kernel (csrc/wavefront.cu).

``wavefront_recon`` reconstructs one plane kind over a batch of items,
all-intra or, given an inter mask and MC planes, as a P frame: for a
CUDA tensor it launches the hand-written kernel (or raises); for a CPU
tensor it runs the kernel's plain PyTorch version, the per-step loop of
encoder/intra_recon.py.  There is no fallback from the card to the
plain version.

The kernel is compiled with ``nvcc`` for sm_90a into a shared library
with a plain C interface at first use (``build/kernels/`` under the
repository root, keyed by the source's hash) and loaded with ctypes.
``LAUNCHES`` counts the kernel launches of this process, intra and
inter variants apart.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from kvazaar_tpu_torch.encoder.geometry import IntraFramePlan
from kvazaar_tpu_torch.encoder import plan_cached
from kvazaar_tpu_torch.ops.quant import quant_params
from kvazaar_tpu_torch.ops.transform import dct_matrix_np

# Kernel launches made by wavefront_recon (only there, after a launch),
# per variant.
LAUNCHES = {"intra": 0, "inter": 0}

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "wavefront.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
_SIZES = (4, 8, 16)

_F_L, _F_A, _F_AR, _F_BL, _F_AL = 1, 2, 4, 8, 16


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "wavefront kernel: nvcc not found (PATH, CUDA_HOME, "
        "/usr/local/cuda); the CUDA kernel cannot be built here")


def library_path() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libwavefront-{digest[:12]}.so"


def build(verbose: bool = False) -> Path:
    """Compile csrc/wavefront.cu (if not built yet) and return the
    library path.  verbose adds ``-Xptxas -v`` and prints nvcc's
    output (registers, shared memory, spills per kernel)."""
    out = library_path()
    if out.exists() and not verbose:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed building the wavefront "
                               f"kernel:\n{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr, flush=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(str(build()))
    fn = lib.ktt_wavefront_recon
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 17
                   + [ctypes.c_void_p])
    return lib


def schedule_np(plan: IntraFramePlan) -> np.ndarray:
    """(steps, slots, 2) int32 [block id, availability flags] per slot
    (copy of wavefront_pallas._schedule_np).  Pad slots carry block id
    N_blocks and flags 0."""
    nb_blocks = plan.blocks_y * plan.blocks_x
    sched = np.zeros((plan.n_steps, plan.n_slots, 2), np.int32)
    sched[:, :, 0] = nb_blocks
    for st in range(plan.n_steps):
        for sl in range(plan.n_slots):
            bid = plan.block_of_slot[st, sl]
            if bid < 0:
                continue
            by, bx = divmod(int(bid), plan.blocks_x)
            fl = 0
            for i, bit in enumerate((_F_L, _F_A, _F_AR, _F_BL, _F_AL)):
                if plan.avail[by, bx, i]:
                    fl |= bit
            sched[st, sl] = (int(bid), fl)
    return sched


@plan_cached
def _device_tables(plan: IntraFramePlan, s: int, device: torch.device):
    """Schedule and DCT matrix uploaded once per (plan, size, device)."""
    return (torch.from_numpy(schedule_np(plan)).to(device),
            torch.from_numpy(dct_matrix_np(s)).to(device))


def wavefront_recon(orig: torch.Tensor, modes: torch.Tensor,
                    plan: IntraFramePlan, s: int, luma: bool, qp: int,
                    bitdepth: int = 8, is_inter=None, mc=None):
    """Reconstruct a batch of planes of one kind.

    orig: (NB, H, W) uint8 or int32 coded-size planes (H, W = the
    plan's luma size, or half of it for chroma); modes: (Bm, By, Bx)
    int32 with NB % Bm == 0 — item i uses modes[i % Bm] (Cb and Cr go
    as one 2B batch sharing the luma modes).  P frames add is_inter
    (Bm, By, Bx) bool, shared like modes, and mc (NB, H, W) integer MC
    prediction planes in [0, 255]: inter blocks take mc and the inter
    rounding.  Returns (rec (NB, H, W) uint8, levels (NB, By*Bx, S, S)
    int16 in raster block order)."""
    if orig.device.type == "cpu":
        from kvazaar_tpu_torch.encoder.intra_recon import \
            wavefront_recon_plain
        return wavefront_recon_plain(orig, modes, plan, s, luma, qp,
                                     bitdepth, is_inter, mc)
    if orig.device.type != "cuda":
        raise ValueError(f"wavefront_recon: unsupported device "
                         f"{orig.device}")
    nb, h, w = _check(orig, modes, plan, s, luma, bitdepth, is_inter, mc)
    lib = _library()
    dev = orig.device
    orig = orig.to(torch.int32).contiguous()
    modes = modes.to(torch.int32).contiguous()
    inter_ptr = mc_ptr = None
    if is_inter is not None:
        is_inter = is_inter.to(torch.uint8).contiguous()
        mc = mc.to(torch.uint8).contiguous()
        inter_ptr, mc_ptr = is_inter.data_ptr(), mc.data_ptr()
    sched, dct = _device_tables(plan, s, dev)
    nblk = plan.blocks_y * plan.blocks_x
    rec = torch.empty((nb, h, w), dtype=torch.uint8, device=dev)
    levels = torch.empty((nb, nblk, s, s), dtype=torch.int16, device=dev)
    scale, qbits, inv_scale, inv_shift = quant_params(
        qp, s.bit_length() - 1, bitdepth)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ktt_wavefront_recon(
            orig.data_ptr(), modes.data_ptr(), sched.data_ptr(),
            dct.data_ptr(), inter_ptr, mc_ptr, rec.data_ptr(),
            levels.data_ptr(), nb, modes.shape[0], h, w, plan.blocks_x,
            nblk, plan.n_steps, plan.n_slots, s, int(luma), bitdepth,
            scale, qbits, 171 << (qbits - 9), 85 << (qbits - 9),
            inv_scale << (qp // 6), inv_shift - 4, stream)
    if err != 0:
        raise RuntimeError(f"wavefront kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["intra" if is_inter is None else "inter"] += 1
    return rec, levels


def _check(orig, modes, plan, s, luma, bitdepth, is_inter=None, mc=None):
    """Validate what the kernel takes; returns (NB, H, W)."""
    if bitdepth != 8:
        raise ValueError("wavefront kernel: 8-bit only")
    if s not in _SIZES or s != (plan.cu_size if luma
                                else plan.cu_size // 2):
        raise ValueError(f"wavefront kernel: block size {s} does not fit "
                         f"the plan (cu {plan.cu_size}, luma={luma})")
    if orig.dtype not in (torch.uint8, torch.int32) or orig.dim() != 3:
        raise ValueError("wavefront kernel: orig must be (NB, H, W) "
                         "uint8 or int32")
    if modes.device != orig.device or modes.dtype != torch.int32:
        raise ValueError("wavefront kernel: modes must be int32 on the "
                         "device of orig")
    nb, h, w = orig.shape
    if (h, w) != (plan.blocks_y * s, plan.blocks_x * s):
        raise ValueError(f"wavefront kernel: plane {h}x{w} does not match "
                         f"the plan's {plan.blocks_y}x{plan.blocks_x} "
                         f"blocks of {s}")
    if (modes.dim() != 3 or modes.shape[1:] != (plan.blocks_y,
                                                plan.blocks_x)
            or nb % modes.shape[0] != 0):
        raise ValueError("wavefront kernel: modes must be (Bm, By, Bx) "
                         "with NB a multiple of Bm")
    if (is_inter is None) != (mc is None):
        raise ValueError("wavefront kernel: is_inter and mc go together")
    if is_inter is not None:
        if (is_inter.device != orig.device or is_inter.dtype != torch.bool
                or is_inter.shape != modes.shape):
            raise ValueError("wavefront kernel: is_inter must be bool "
                             "with the shape of modes on the device of "
                             "orig")
        if mc.device != orig.device or mc.shape != orig.shape:
            raise ValueError("wavefront kernel: mc must have the shape "
                             "of orig on its device")
    return nb, h, w
