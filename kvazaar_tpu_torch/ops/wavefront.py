"""Wrapper of the CUDA wavefront reconstruction kernel (csrc/wavefront.cu).

``wavefront_recon_planes`` reconstructs the luma and chroma planes of a
batch of frames, all-intra or, given an inter mask and MC planes, as P
frames, at one QP or with a per-block QP map, or lossless (transquant
bypass, with or without implicit RDPCM), with RDOQ and sign-data hiding
where asked (the kernel's TQ instances), with a scaling list's per-position
quantizer tables where asked (the kernel's SL instances), with explicit
chroma modes (--rd 3) or DM, at 8 or 10 bits (the kernel's 10-bit instance takes
int16 planes and writes int16 recon); on a plan of 4x4 blocks (the
intra-NxN point) it reconstructs luma alone, with the DST-VII and, where
asked, the transform-skip decision (the kernel's cu 4 instances), and
``wavefront_recon_chroma`` that point's chroma, one 4x4 TB per 8x8 CU,
on the cu 8 plan (a chroma-only launch of the cu 8 instances);
``wavefront_recon`` reconstructs one plane kind.  For CUDA
tensors both launch the hand-written kernel once (or raise); for CPU
tensors they run the kernel's plain PyTorch version, the per-step loop
of encoder/intra_recon.py, once per plane kind.  There is no fallback
from the card to the plain version.

The kernel is compiled with ``nvcc`` for sm_90a into a shared library
with a plain C interface at first use (``build/kernels/`` under the
repository root, keyed by the source's hash) and loaded with ctypes.
Its per-plan tables (the schedule packed per block, the step offsets,
the tile table and the depth of the shared-memory edge ring) are
derived here, once per plan and device: each tile of a tiled plan runs
as a thread block of its own, with a ring over its own rows (tiles cut
every prediction dependency).  The launch's threads and shared memory
come from the library (``ktt_wavefront_layout``), and a plan that needs
more shared memory than the device gives raises here.  ``LAUNCHES`` counts the
kernel launches of this process, intra and inter variants apart,
``QP_MAP_LAUNCHES`` those of them that took a per-block QP map,
``LAUNCHES_10BIT`` those of the 10-bit instances, ``BYPASS_LAUNCHES``
those of the lossless (transquant bypass) instances, ``TILE_LAUNCHES``
those on a tiled plan, ``TOOL_LAUNCHES`` those of the RDOQ / sign-hiding
instances, ``CMODE_LAUNCHES`` those with explicit chroma modes,
``CU4_LAUNCHES`` those of the cu 4 (intra NxN, DST-VII) instances and of
the chroma-only launches beside them, ``TSKIP_LAUNCHES`` the cu 4
launches that took the transform-skip decision, and ``SL_LAUNCHES``
those of the scaling-list instances.
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

from kvazaar_tpu_torch.constants import CHROMA_QP_TAB
from kvazaar_tpu_torch.encoder.geometry import IntraFramePlan
from kvazaar_tpu_torch.encoder import pix_dtype, plan_cached
from kvazaar_tpu_torch.ops.quant import (_f32, _rem_bits, _tskip_bits,
                                         int32_table, quant_params,
                                         scaling_tables)

# Kernel launches made by this module (only here, after a launch), per
# variant; QP_MAP_LAUNCHES counts the launches with a per-block QP map
# among them, LAUNCHES_10BIT the 10-bit ones ("qp_map": those of them
# with a QP map), BYPASS_LAUNCHES the lossless ones ("rdpcm": those of
# them with implicit RDPCM, "10bit": those at 10-bit), TILE_LAUNCHES
# those on a plan of more than one tile.
LAUNCHES = {"intra": 0, "inter": 0}
QP_MAP_LAUNCHES = {"intra": 0, "inter": 0}
LAUNCHES_10BIT = {"intra": 0, "inter": 0, "qp_map": 0}
BYPASS_LAUNCHES = {"intra": 0, "inter": 0, "rdpcm": 0, "10bit": 0}
TILE_LAUNCHES = {"intra": 0, "inter": 0}
# The RDOQ / sign-hiding instances' launches ("rdoq", "signhide": those
# with each flag; "qp_map", "10bit", "tiled": those with a QP map, at
# 10-bit, on a tiled plan) and the launches with explicit chroma modes.
TOOL_LAUNCHES = {"intra": 0, "inter": 0, "rdoq": 0, "signhide": 0,
                 "qp_map": 0, "10bit": 0, "tiled": 0}
CMODE_LAUNCHES = {"intra": 0, "inter": 0}
# The intra-NxN point's launches: "luma" those of the cu 4 instances,
# "chroma" the chroma-only launches on its cu 8 plan; "10bit", "tq",
# "lossless": the cu 4 launches at 10-bit, with RDOQ or sign hiding,
# lossless.  TSKIP_LAUNCHES counts the cu 4 launches with the
# transform-skip decision ("10bit", "signhide": those at 10-bit, with
# sign hiding).
CU4_LAUNCHES = {"luma": 0, "chroma": 0, "10bit": 0, "tq": 0,
                "lossless": 0}
TSKIP_LAUNCHES = {"luma": 0, "10bit": 0, "signhide": 0}
# The scaling-list instances' launches ("10bit", "tq", "tiled", "cu4":
# those at 10-bit, with RDOQ or sign hiding, on a tiled plan, of the cu 4
# instances or the chroma-only launches beside them).
SL_LAUNCHES = {"intra": 0, "inter": 0, "10bit": 0, "tq": 0, "tiled": 0,
               "cu4": 0}

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "wavefront.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# --split-compile=0: nvcc optimizes the kernel instances in parallel, on
# every core of the host.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--split-compile=0", "-shared", "-Xcompiler", "-fPIC"]
_SIZES = (4, 8, 16, 32)
_BITDEPTHS = (8, 10)
# blk_info holds a block's position in its tile's step order in its low
# _POS_BITS bits and its availability mask above them (kAvailShift in the
# kernel).
_POS_BITS = 20

_F_L, _F_A, _F_AR, _F_BL, _F_AL = 1, 2, 4, 8, 16
# Neighbour offsets (dx, dy) of the availability flags, in plan.avail's
# order: left, above, above-right, below-left, above-left.
_NEIGHBOURS = ((-1, 0), (0, -1), (1, -1), (-1, 1), (-1, -1))


class _Plane(ctypes.Structure):
    """KttPlane of csrc/wavefront.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("orig", "mc", "rec",
                                                 "levels", "qp")]
                + [(n, ctypes.c_int) for n in (
                    "nb", "s", "h", "w", "luma", "orig_bytes", "mc_bytes",
                    "q_scale", "q_bits", "q_offset", "q_offset_inter",
                    "dq_mult", "dq_shift")])


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
    fn.argtypes = ([ctypes.POINTER(_Plane), ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] + [ctypes.c_int] * 2
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 5)
    lib.ktt_wavefront_layout.restype = ctypes.c_int
    lib.ktt_wavefront_layout.argtypes = ([ctypes.c_int] * 6
                                         + [ctypes.POINTER(ctypes.c_int)] * 2)
    lib.ktt_wavefront_smem_optin.restype = ctypes.c_int
    lib.ktt_wavefront_smem_optin.argtypes = [ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int)]
    return lib


@functools.lru_cache(maxsize=None)
def _smem_optin(device_index: int) -> int:
    """Shared memory (bytes) a thread block may opt in to on a device."""
    out = ctypes.c_int(0)
    err = _library().ktt_wavefront_smem_optin(device_index,
                                              ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"wavefront kernel: cannot read the device's "
                           f"shared memory limit: CUDA error {err}")
    return out.value


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


# plan.avail's columns (left, above, above-right, below-left, above-left)
# in the substitution scan order of the kernel's availability mask:
# below-left, left, above-left, above, above-right.
_SCAN_ORDER = (3, 0, 4, 1, 2)


def step_tables(plan: IntraFramePlan):
    """The kernel's schedule without pad slots, tile by tile: tiles cut
    every prediction dependency, so each tile runs as a thread block of
    its own from step 0 (an untiled plan is one tile).  Returns
    (blk_info (N_blocks,) int32 = position of the block in its tile's
    step order | availability mask in scan order << _POS_BITS;
    step_start (tiles, n + 1) int32, n the most steps of any tile = per
    tile, the first position of each of its steps, then its block count
    (repeated past its last step: a tile with fewer steps runs empty
    ones); tile_info (tiles, 4) int32 = first block column and row,
    width and height in blocks)."""
    order = plan.block_of_slot[plan.block_of_slot >= 0]   # step order
    avail = plan.avail.reshape(-1, 5)
    mask = sum(avail[:, j].astype(np.int32) << bit
               for bit, j in enumerate(_SCAN_ORDER))
    # The tiles' column and row bounds in blocks: the plan's CTU bounds,
    # cut to the grid.
    k = 64 // plan.cu_size
    cols = np.minimum(np.asarray(plan.tile_col_bounds) * k, plan.blocks_x)
    rows = np.minimum(np.asarray(plan.tile_row_bounds) * k, plan.blocks_y)
    tcol = np.searchsorted(cols[1:], np.arange(plan.blocks_x), "right")
    trow = np.searchsorted(rows[1:], np.arange(plan.blocks_y), "right")
    tile_of = (trow[:, None] * (len(cols) - 1) + tcol[None, :]).ravel()
    order = order[np.argsort(tile_of[order], kind="stable")]
    first = np.searchsorted(tile_of[order], tile_of[order])  # tile's start
    blk_info = np.zeros(len(order), np.int32)
    blk_info[order] = ((np.arange(len(order)) - first)
                       | (mask[order] << _POS_BITS))
    step = plan.step_of_block.ravel()
    counts = [np.bincount(step[tile_of == t])
              for t in range((len(cols) - 1) * (len(rows) - 1))]
    n = max(map(len, counts))
    starts = np.zeros((len(counts), n + 1), np.int32)
    for t, c in enumerate(counts):
        starts[t] = np.cumsum(np.concatenate([[0], c, np.zeros(n - len(c))]))
    info = [(cols[tx], rows[ty], cols[tx + 1] - cols[tx],
             rows[ty + 1] - rows[ty]) for ty in range(len(rows) - 1)
            for tx in range(len(cols) - 1)]
    return blk_info, starts, np.asarray(info, np.int32)


def _last_reader_step(plan: IntraFramePlan) -> np.ndarray:
    """(By, Bx) step of the last block that reads each block's edges
    (its bottom row and right column) as a reference, -1 for none."""
    step = plan.step_of_block
    by_n, bx_n = step.shape
    last = np.full((by_n, bx_n), -1, np.int64)
    for i, (dx, dy) in enumerate(_NEIGHBOURS):
        ry, rx = np.nonzero(plan.avail[:, :, i])
        np.maximum.at(last, (ry + dy, rx + dx), step[ry, rx])
    return last


def ring_depth(plan: IntraFramePlan, bounds=None) -> int:
    """Depth K of the kernel's edge ring over the whole plan or, given
    bounds = (first row, end row, first column, end column) in blocks,
    over one tile of it: block (bx, by) keeps its edges in ring row
    by % K (of its tile's ring).  The smallest K for which no block
    writes a ring entry from the step at which another block's edges
    were written there up to the step of their last reader (a write in
    the reader's own step would race with the read).  Tiles run their
    wavefronts at once, so one ring over a tiled plan needs K about the
    tile rows' block rows (16 at 1920x1088 3x3, cu 16); a tile's own is
    3."""
    w = plan.step_of_block.astype(np.int64)
    last = _last_reader_step(plan)
    if bounds is not None:
        y0, y1, x0, x1 = bounds
        w, last = w[y0:y1, x0:x1], last[y0:y1, x0:x1]
    by_n = w.shape[0]
    for k in range(1, by_n):
        clash = False
        for d in range(k, by_n, k):
            for a, b in ((w[d:], slice(None, by_n - d)),
                         (w[:by_n - d], slice(d, None))):
                # a: writer rows; b: the rows d apart whose edges live.
                if np.any((last[b] >= 0) & (w[b] <= a) & (a <= last[b])):
                    clash = True
                    break
            if clash:
                break
        if not clash:
            return k
    return max(by_n, 1)


@plan_cached
def tile_shape(plan: IntraFramePlan):
    """(steps, slots, ring depth, width in blocks, blocks) of the plan's
    largest tile on each count: what a thread block of the kernel must
    hold."""
    _, step_start, info = step_tables(plan)
    ring = max(ring_depth(plan, (by0, by0 + bh, bx0, bx0 + bw))
               for bx0, by0, bw, bh in info.tolist())
    return (step_start.shape[1] - 1, int(np.diff(step_start).max()), ring,
            int(info[:, 2].max()), int(step_start[:, -1].max()))


@plan_cached
def launch_layout(plan: IntraFramePlan, s_max: int, width: int,
                  bitdepth: int = 8):
    """(ring depth, threads, dynamic shared memory in bytes) of a launch
    whose largest block size is s_max on a plan whose widest plane is
    ``width`` samples at ``bitdepth``, the layout as the kernel's
    library computes it for the plan's largest tile (its ring is as
    wide as the widest tile).  The kernel instance is the plan's CU
    size: a chroma-only launch (s_max 4) on a cu 8 plan runs the cu 8
    instances, a plan of 4x4 blocks the cu 4 ones."""
    n_steps, n_slots, ring, tile_bw, _ = tile_shape(plan)
    threads, nbytes = ctypes.c_int(0), ctypes.c_int(0)
    err = _library().ktt_wavefront_layout(
        max(s_max, plan.cu_size), bitdepth, n_steps, n_slots, ring,
        width // plan.blocks_x * tile_bw, ctypes.byref(threads),
        ctypes.byref(nbytes))
    if err != 0:
        raise ValueError(f"wavefront kernel: no launch layout for the plan "
                         f"(CUDA error {err})")
    return ring, threads.value, nbytes.value


@plan_cached
def _plan_tables(plan: IntraFramePlan, device: torch.device):
    """Per-block schedule words, step offsets and the tile table on the
    device, once per (plan, device)."""
    return tuple(torch.from_numpy(a).to(device) for a in step_tables(plan))


def wavefront_recon(orig: torch.Tensor, modes: torch.Tensor,
                    plan: IntraFramePlan, s: int, luma: bool, qp: int,
                    bitdepth: int = 8, is_inter=None, mc=None,
                    qp_map=None, lossless=False, rdpcm=False, rdoq=False,
                    lam=0.0, signhide=False):
    """Reconstruct a batch of planes of one kind.

    orig: (NB, H, W) coded-size planes (H, W = the plan's luma size, or
    half of it for chroma), uint8 or int32 at 8-bit, int16 at 10-bit;
    modes: (Bm, By, Bx) int32 with NB % Bm == 0 — item i uses
    modes[i % Bm].  P frames add is_inter (Bm, By, Bx) bool, shared like
    modes, and mc (NB, H, W) MC prediction planes of orig's dtypes, in
    [0, 2^bitdepth - 1]: inter blocks take mc and the inter rounding.
    qp_map: (Bm, By, Bx) int32 per-block QPs of this plane kind in
    0..51, shared like modes, replacing qp.  lossless: transquant
    bypass (no qp_map), the levels the residual and rec the source;
    rdpcm: implicit RDPCM on the intra blocks of a lossless plane, the
    luma boundary fixups off.  rdoq: RDOQ at lambda lam; signhide:
    sign-data hiding by each block's scanIdx (the modes are this plane
    kind's, chroma modes for a chroma plane).  Returns (rec (NB, H, W)
    uint8 at 8-bit, int16 at 10-bit, levels (NB, By*Bx, S, S) int16 in
    raster block order)."""
    if orig.device.type == "cpu":
        from kvazaar_tpu_torch.encoder.intra_recon import \
            wavefront_recon_plain
        return wavefront_recon_plain(orig, modes, plan, s, luma, qp,
                                     bitdepth, is_inter, mc, qp_map,
                                     lossless, rdpcm, rdoq, lam, signhide)
    if orig.device.type != "cuda":
        raise ValueError(f"wavefront_recon: unsupported device "
                         f"{orig.device}")
    _check(orig, modes, plan, s, luma, bitdepth, is_inter, mc, qp_map,
           lossless, rdpcm, rdoq or signhide)
    return _launch([(orig, mc, s, luma, qp, qp_map, None)], modes, plan,
                   is_inter, bitdepth, lossless, rdpcm, rdoq, lam, signhide)


def _sl_stack(tab):
    """A plane's scaling-list tables as the kernel reads them: one
    contiguous (4, S, S) int32 tensor (qc intra, qc inter, dqc intra,
    dqc inter), each transposed (position (y, x) at x * S + y: a group's
    lanes, one row each, read consecutive words), or None without a
    list."""
    return (None if tab is None
            else torch.stack(tab).transpose(1, 2).contiguous())


def _plain_chroma(cbs, crs, modes, plan, s, qp_c, bitdepth, tabs, **kw):
    """The plain version of the Cb and Cr planes: one 2B batch (they
    share geometry, modes, inter map and QP) or, with a scaling list,
    whose tables differ by component, one batch each.  Returns (rec_cb,
    lv_cb, rec_cr, lv_cr)."""
    from kvazaar_tpu_torch.encoder.intra_recon import wavefront_recon_plain
    b = cbs.shape[0]
    mc_cb, mc_cr = kw.pop("mc_cb"), kw.pop("mc_cr")
    if tabs is None:
        mc = None if mc_cb is None else torch.cat([mc_cb, mc_cr])
        rec, lv = wavefront_recon_plain(torch.cat([cbs, crs]), modes, plan,
                                        s, False, qp_c, bitdepth, mc=mc,
                                        **kw)
        return rec[:b], lv[:b], rec[b:], lv[b:]
    return tuple(t for orig, mc, tab in ((cbs, mc_cb, tabs[0]),
                                          (crs, mc_cr, tabs[1]))
                 for t in wavefront_recon_plain(
                     orig, modes, plan, s, False, qp_c, bitdepth, mc=mc,
                     scaling_tab=tab, **kw))


def wavefront_recon_planes(ys, cbs, crs, modes, plan: IntraFramePlan,
                           qp: int, qp_c: int, bitdepth: int = 8,
                           is_inter=None, mc_y=None, mc_cb=None,
                           mc_cr=None, qp_map=None, lossless=False,
                           rdpcm=False, rdoq=False, signhide=False,
                           lam=0.0, cmodes=None, tskip=False, scaling=None):
    """Reconstruct the luma and (where cbs is given) chroma planes of a
    batch of frames in one launch.  On a plan of 4x4 blocks (the intra
    NxN point: cbs None, chroma through ``wavefront_recon_chroma``) luma
    takes the DST-VII, and tskip the transform-skip decision per block,
    whose (B, N_blocks) int32 flags come as a seventh entry.

    ys (B, H, W), cbs/crs (B, H/2, W/2) or None, uint8 or int32 at
    8-bit, int16 or int32 at 10-bit (int32 planes are narrowed to int16
    for the kernel there); modes (Bm, By, Bx) int32, shared by the three
    planes.  P frames add
    is_inter (Bm, By, Bx) bool and the MC planes mc_y/mc_cb/mc_cr of
    the shapes of ys/cbs/crs.  qp_map: (Bm, By, Bx) per-block luma QPs,
    shared like modes, replacing qp and qp_c: clipped to 0..51, and
    mapped through Table 8-10 for Cb and Cr, on the device.  lossless /
    rdpcm / rdoq / lam / signhide: as in wavefront_recon (Cb and Cr take
    the DPCM and the scan of their mode).  cmodes: (Bm, By, Bx) int32
    explicit chroma modes shared like modes (--rd 3), else Cb and Cr
    take modes.  scaling: a scaling list (ops.scaling.ScalingLists;
    neither qp_map, lossless nor tskip), each plane quantized with its
    own tables, luma at qp and Cb / Cr at qp_c (the kernel's SL
    instances).  Returns (rec_y, lv_y, rec_cb, lv_cb, rec_cr, lv_cr),
    the chroma entries None without chroma."""
    tools = dict(rdoq=rdoq, lam=lam, signhide=signhide)
    s = plan.cu_size
    if tskip and s != 4:
        raise ValueError("wavefront: transform skip needs a plan of 4x4 "
                         "blocks")
    if s == 4 and cbs is not None:
        raise ValueError("wavefront: a plan of 4x4 blocks takes luma alone "
                         "(chroma: wavefront_recon_chroma)")
    if tskip and (rdoq or lossless):
        raise ValueError("wavefront: transform skip takes neither RDOQ nor "
                         "lossless (the configuration refuses both)")
    if scaling is not None and (qp_map is not None or lossless or tskip):
        raise ValueError("wavefront: a scaling list takes no QP map, "
                         "lossless or transform skip (the configuration "
                         "refuses them)")
    qp_y = qp_c_map = None
    if qp_map is not None:
        qp_y = torch.clamp(qp_map.to(torch.int32), 0, 51)
        qp_c_map = int32_table(CHROMA_QP_TAB.astype(np.int32).tobytes(),
                          qp_y.device)[qp_y.long()].contiguous()
        qp_y = qp_y.contiguous()
    tab_y = tabs_c = None
    if scaling is not None:
        tab_y = scaling_tables(scaling, s, 0, qp, ys.device)
        if cbs is not None:
            tabs_c = tuple(scaling_tables(scaling, s // 2, c, qp_c,
                                          ys.device) for c in (1, 2))
    if ys.device.type == "cpu":
        from kvazaar_tpu_torch.encoder.intra_recon import \
            wavefront_recon_plain
        out = wavefront_recon_plain(ys, modes, plan, s, True, qp, bitdepth,
                                    is_inter, mc_y, qp_y, lossless, rdpcm,
                                    tskip=tskip, scaling_tab=tab_y, **tools)
        rec_y, lv_y = out[:2]
        if cbs is None:
            return (rec_y, lv_y, None, None, None, None) + out[2:]
        return (rec_y, lv_y) + _plain_chroma(
            cbs, crs, modes if cmodes is None else cmodes, plan, s // 2,
            qp_c, bitdepth, tabs_c, is_inter=is_inter, mc_cb=mc_cb,
            mc_cr=mc_cr, qp_map=qp_c_map, lossless=lossless, rdpcm=rdpcm,
            **tools)
    if ys.device.type != "cuda":
        raise ValueError(f"wavefront_recon_planes: unsupported device "
                         f"{ys.device}")
    if bitdepth > 8:
        ys, cbs, crs, mc_y, mc_cb, mc_cr = (
            t if t is None or t.dtype != torch.int32 else t.to(torch.int16)
            for t in (ys, cbs, crs, mc_y, mc_cb, mc_cr))
    planes = [(ys, mc_y, s, True, qp, qp_y, _sl_stack(tab_y))]
    if cbs is not None:
        planes += [(cbs, mc_cb, s // 2, False, qp_c, qp_c_map,
                    None if tabs_c is None else _sl_stack(tabs_c[0])),
                   (crs, mc_cr, s // 2, False, qp_c, qp_c_map,
                    None if tabs_c is None else _sl_stack(tabs_c[1]))]
    for orig, mc, ps, luma, _, qm, _sl in planes:
        _check(orig, modes if luma or cmodes is None else cmodes, plan, ps,
               luma, bitdepth, is_inter, mc, qm, lossless, rdpcm,
               rdoq or signhide, scaling is not None)
    out = _launch(planes, modes, plan, is_inter, bitdepth, lossless, rdpcm,
                  cmodes=None if cbs is None else cmodes, tskip=tskip,
                  **tools)
    if cbs is None:
        return (*out[:2], None, None, None, None) + out[2:]
    return out


def wavefront_recon_chroma(cbs, crs, modes, plan: IntraFramePlan, qp_c: int,
                           bitdepth: int = 8, lossless=False, rdoq=False,
                           signhide=False, lam=0.0, scaling=None):
    """The chroma of the intra-NxN point (the JAX package's
    ``reconstruct_chroma_frames``): one 4x4 TB per 8x8 CU of each of Cb
    and Cr, predicted with the CU's first PU's mode (DM), over a cu 8
    plan without luma.  cbs/crs (B, H/2, W/2); modes (Bm, By8, Bx8)
    int32; lossless / rdoq / lam / signhide as in wavefront_recon;
    scaling: a scaling list, the 4x4 Cb and Cr tables at qp_c (not
    lossless).  On CUDA tensors one chroma-only launch of the cu 8
    instances.  Returns (rec_cb, lv_cb, rec_cr, lv_cr)."""
    tools = dict(rdoq=rdoq, lam=lam, signhide=signhide)
    if scaling is not None and lossless:
        raise ValueError("wavefront: a scaling list takes no lossless "
                         "launch")
    tabs = None if scaling is None else tuple(
        scaling_tables(scaling, 4, c, qp_c, cbs.device) for c in (1, 2))
    if cbs.device.type == "cpu":
        return _plain_chroma(cbs, crs, modes, plan, plan.cu_size // 2, qp_c,
                             bitdepth, tabs, mc_cb=None, mc_cr=None,
                             lossless=lossless, **tools)
    if cbs.device.type != "cuda":
        raise ValueError(f"wavefront_recon_chroma: unsupported device "
                         f"{cbs.device}")
    if plan.cu_size != 8:
        raise ValueError("wavefront_recon_chroma: the intra-NxN chroma "
                         "runs on a cu 8 plan")
    if bitdepth > 8:
        cbs, crs = (t if t.dtype != torch.int32 else t.to(torch.int16)
                    for t in (cbs, crs))
    planes = [(cbs, None, 4, False, qp_c, None,
               None if tabs is None else _sl_stack(tabs[0])),
              (crs, None, 4, False, qp_c, None,
               None if tabs is None else _sl_stack(tabs[1]))]
    for orig, *_ in planes:
        _check(orig, modes, plan, 4, False, bitdepth, lossless=lossless,
               tools=rdoq or signhide, scaling=scaling is not None)
    rec_cb, lv_cb, rec_cr, lv_cr = _launch(planes, modes, plan, None,
                                           bitdepth, lossless, **tools)
    CU4_LAUNCHES["chroma"] += 1
    if scaling is not None:
        SL_LAUNCHES["cu4"] += 1
    return rec_cb, lv_cb, rec_cr, lv_cr


def _launch(planes, modes, plan: IntraFramePlan, is_inter, bitdepth=8,
            lossless=False, rdpcm=False, rdoq=False, lam=0.0,
            signhide=False, cmodes=None, tskip=False):
    """One kernel launch over checked (orig, mc, s, luma, qp, qp_map, sl)
    plane kinds (sl: the plane's (4, S, S) scaling-list tables or None,
    the same for every kind; cmodes: the chroma planes' modes, or None
    for modes); returns (rec, levels) per kind, flattened, then with
    tskip (a cu 4 launch) the (NB, N_blocks) int32 transform-skip
    flags."""
    lib = _library()
    dev = planes[0][0].device
    nblk = plan.blocks_y * plan.blocks_x
    width = planes[0][0].shape[2]
    ring, _, nbytes = launch_layout(plan, max(p[2] for p in planes), width,
                                    bitdepth)
    limit = _smem_optin(dev.index if dev.index is not None
                        else torch.cuda.current_device())
    if nbytes > limit:
        raise ValueError(f"wavefront kernel: the plan needs {nbytes} bytes "
                         f"of shared memory, the device gives {limit}")
    blk_info, step_start, tile_info = _plan_tables(plan, dev)
    n_steps, n_slots, _, tile_bw, tile_blocks = tile_shape(plan)
    modes = modes.contiguous()
    if cmodes is not None:
        cmodes = cmodes.contiguous()
    if is_inter is not None:
        is_inter = is_inter.contiguous()
    rem_bits = _rem_bits(dev) if rdoq else None
    nxn = plan.cu_size == 4
    skip = ts_bits = None
    if tskip:
        skip = torch.empty((planes[0][0].shape[0], nblk), dtype=torch.int32,
                           device=dev)
        ts_bits = _tskip_bits(dev)
    structs = (_Plane * len(planes))()
    scaled = planes[0][6] is not None
    if any((p[6] is not None) != scaled for p in planes):
        raise ValueError("wavefront kernel: every plane of a launch takes a "
                         "scaling list, or none does")
    sl_tabs = (ctypes.c_void_p * 3)()
    sl_shift = (ctypes.c_int * 3)()
    outs = []
    # The kernel packs each (item, tile)'s schedule words here.
    entries = torch.empty(sum(p[0].shape[0] for p in planes)
                          * tile_info.shape[0] * tile_blocks,
                          dtype=torch.int32, device=dev)
    for i, (st, (orig, mc, s, luma, qp, qp_map, sl)) in enumerate(
            zip(structs, planes)):
        nb, h, w = orig.shape
        rec = torch.empty((nb, h, w), dtype=pix_dtype(bitdepth), device=dev)
        levels = torch.empty((nb, nblk, s, s), dtype=torch.int16,
                             device=dev)
        scale, qbits, inv_scale, inv_shift = quant_params(
            qp, s.bit_length() - 1, bitdepth)
        st.orig, st.rec, st.levels = (orig.data_ptr(), rec.data_ptr(),
                                      levels.data_ptr())
        st.mc = None if mc is None else mc.data_ptr()
        st.qp = None if qp_map is None else qp_map.data_ptr()
        st.nb, st.s, st.h, st.w, st.luma = nb, s, h, w, int(luma)
        st.orig_bytes = orig.element_size()
        st.mc_bytes = 0 if mc is None else mc.element_size()
        st.q_scale, st.q_bits = scale, qbits
        st.q_offset, st.q_offset_inter = 171 << (qbits - 9), 85 << (qbits
                                                                    - 9)
        st.dq_mult, st.dq_shift = inv_scale << (qp // 6), inv_shift - 4
        if sl is not None:
            sl_tabs[i] = sl.data_ptr()
            sl_shift[i] = inv_shift - qp // 6
        outs += [rec, levels]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ktt_wavefront_recon(
            structs, len(planes), bitdepth, blk_info.data_ptr(),
            step_start.data_ptr(), modes.data_ptr(),
            None if is_inter is None else is_inter.data_ptr(),
            entries.data_ptr(), modes.shape[0], plan.blocks_x, nblk,
            n_steps, n_slots, ring, width // plan.blocks_x * tile_bw,
            int(lossless), int(rdpcm), tile_info.data_ptr(),
            tile_info.shape[0], tile_bw, tile_blocks,
            None if cmodes is None else cmodes.data_ptr(), int(rdoq),
            int(signhide), _f32(lam), _f32(_f32(lam) * _f32(0.15)),
            None if rem_bits is None else rem_bits.data_ptr(), int(tskip),
            None if skip is None else skip.data_ptr(),
            None if ts_bits is None else ts_bits.data_ptr(),
            ctypes.cast(sl_tabs, ctypes.c_void_p) if scaled else None,
            ctypes.cast(sl_shift, ctypes.c_void_p), stream)
    if err != 0:
        raise RuntimeError(f"wavefront kernel launch failed: CUDA error "
                           f"{err}")
    variant = "intra" if is_inter is None else "inter"
    LAUNCHES[variant] += 1
    if planes[0][5] is not None:
        QP_MAP_LAUNCHES[variant] += 1
    if bitdepth == 10:
        LAUNCHES_10BIT[variant] += 1
        LAUNCHES_10BIT["qp_map"] += planes[0][5] is not None
    if lossless:
        BYPASS_LAUNCHES[variant] += 1
        BYPASS_LAUNCHES["rdpcm"] += bool(rdpcm)
        BYPASS_LAUNCHES["10bit"] += bitdepth == 10
    if tile_info.shape[0] > 1:
        TILE_LAUNCHES[variant] += 1
    if rdoq or signhide:
        TOOL_LAUNCHES[variant] += 1
        TOOL_LAUNCHES["rdoq"] += bool(rdoq)
        TOOL_LAUNCHES["signhide"] += bool(signhide)
        TOOL_LAUNCHES["qp_map"] += planes[0][5] is not None
        TOOL_LAUNCHES["10bit"] += bitdepth == 10
        TOOL_LAUNCHES["tiled"] += tile_info.shape[0] > 1
    if cmodes is not None:
        CMODE_LAUNCHES[variant] += 1
    if nxn:
        CU4_LAUNCHES["luma"] += 1
        CU4_LAUNCHES["10bit"] += bitdepth == 10
        CU4_LAUNCHES["tq"] += bool(rdoq or signhide)
        CU4_LAUNCHES["lossless"] += bool(lossless)
    if scaled:
        SL_LAUNCHES[variant] += 1
        SL_LAUNCHES["10bit"] += bitdepth == 10
        SL_LAUNCHES["tq"] += bool(rdoq or signhide)
        SL_LAUNCHES["tiled"] += tile_info.shape[0] > 1
        SL_LAUNCHES["cu4"] += nxn
    if tskip:
        TSKIP_LAUNCHES["luma"] += 1
        TSKIP_LAUNCHES["10bit"] += bitdepth == 10
        TSKIP_LAUNCHES["signhide"] += bool(signhide)
        outs.append(skip)
    return tuple(outs)


def _check(orig, modes, plan, s, luma, bitdepth, is_inter=None, mc=None,
           qp_map=None, lossless=False, rdpcm=False, tools=False,
           scaling=False):
    """Validate what the kernel takes (tools: RDOQ or sign hiding;
    scaling: a scaling list's tables); returns (NB, H, W)."""
    if scaling and (lossless or qp_map is not None):
        raise ValueError("wavefront kernel: a scaling list takes neither "
                         "lossless nor a QP map")
    if bitdepth not in _BITDEPTHS:
        raise ValueError(f"wavefront kernel: bit depth {bitdepth} (8 and "
                         "10 are built)")
    if rdpcm and not lossless:
        raise ValueError("wavefront kernel: implicit RDPCM needs lossless")
    if lossless and tools:
        raise ValueError("wavefront kernel: RDOQ and sign hiding need a "
                         "lossy launch")
    if lossless and qp_map is not None:
        raise ValueError("wavefront kernel: a lossless launch takes no QP "
                         "map")
    if qp_map is not None and plan.tiles != (1, 1):
        raise ValueError("wavefront kernel: a tiled launch takes no QP map")
    if plan.cu_size == 4 and (not luma or is_inter is not None
                              or qp_map is not None or rdpcm
                              or plan.tiles != (1, 1)):
        raise ValueError("wavefront kernel: a plan of 4x4 blocks takes "
                         "intra luma alone, without QP maps, RDPCM or tiles")
    sample_dtypes = ((torch.uint8, torch.int32) if bitdepth == 8
                     else (torch.int16,))
    names = " or ".join(str(d).replace("torch.", "") for d in sample_dtypes)
    if s not in _SIZES or s != (plan.cu_size if luma
                                else plan.cu_size // 2):
        raise ValueError(f"wavefront kernel: block size {s} does not fit "
                         f"the plan (cu {plan.cu_size}, luma={luma})")
    nblk = plan.blocks_y * plan.blocks_x
    if nblk > 1 << _POS_BITS or nblk * plan.blocks_x >= 1 << 32:
        raise ValueError(f"wavefront kernel: a plane of {plan.blocks_x}x"
                         f"{plan.blocks_y} blocks is too large (at most "
                         f"2^{_POS_BITS} blocks, blocks x columns < 2^32)")
    if orig.dtype not in sample_dtypes or orig.dim() != 3:
        raise ValueError(f"wavefront kernel: orig must be (NB, H, W) "
                         f"{names} at {bitdepth}-bit")
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
        if (mc.device != orig.device or mc.shape != orig.shape
                or mc.dtype not in sample_dtypes):
            raise ValueError(f"wavefront kernel: mc must be {names} at "
                             f"{bitdepth}-bit with the shape of orig on "
                             "its device")
    if qp_map is not None and (
            qp_map.device != orig.device or qp_map.dtype != torch.int32
            or qp_map.shape != modes.shape or not qp_map.is_contiguous()):
        raise ValueError("wavefront kernel: qp_map must be contiguous "
                         "int32 with the shape of modes on the device of "
                         "orig")
    # Sample rows are read as 4- and 16-byte words.
    if any(not t.is_contiguous() or t.data_ptr() % 16
           for t in (orig, mc) if t is not None):
        raise ValueError("wavefront kernel: orig and mc must be "
                         "contiguous and 16-byte aligned")
    return nb, h, w
