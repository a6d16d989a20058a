"""The native CABAC slice-data serializer (I and P slices), built for the
host it runs on.

The port binds the same C++ source as the JAX package
(native/hevc_cabac.cpp, unchanged, with the ctypes signatures of
kvazaar_tpu/bitstream/native.py) but never loads the tracked
native/libhevc_cabac.so: that one is built with -march=native for the
machine that committed it, and may not run on another host.  This
module compiles the source into build/native/ under the repository
root at first use (keyed by the source's hash, written atomically) and
writes nothing under native/.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "hevc_cabac.cpp"
BUILD_DIR = _ROOT / "build" / "native"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread"]


def library_path() -> Path:
    digest = hashlib.sha1(_SRC.read_bytes()
                          + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libhevc_cabac-{digest[:12]}.so"


def build() -> Path:
    """Compile native/hevc_cabac.cpp (if not built yet); returns the
    library path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(_SRC)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("g++ failed building the CABAC library:\n"
                               + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=1)
def get_lib():
    lib = ctypes.CDLL(str(build()))
    lib.ktpu_encode_slice_data.restype = ctypes.c_int64
    lib.ktpu_encode_slice_data.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ktpu_encode_slice_data_wpp.restype = ctypes.c_int64
    lib.ktpu_encode_slice_data_wpp.argtypes = \
        lib.ktpu_encode_slice_data.argtypes[:-4] + [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.ktpu_encode_slice_data_p.restype = ctypes.c_int64
    lib.ktpu_encode_slice_data_p.argtypes = (
        [ctypes.c_int] * 9 + [ctypes.c_void_p] * 14
        + [ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
           ctypes.c_void_p])
    return lib


def available() -> bool:
    """True when the library builds and loads on this host."""
    try:
        get_lib()
    except (OSError, RuntimeError):
        return False
    return True


def _frame_args(params, fd):
    """Contiguous buffers of the intra FrameData fields, the explicit
    chroma modes (--rd 3) None where every cell takes DM (the caller
    keeps them alive across the native call)."""
    chroma = 1 if params.chroma_format_idc else 0
    return (np.ascontiguousarray(fd.depth8, np.uint8),
            np.ascontiguousarray(fd.mode4, np.uint8),
            np.ascontiguousarray(fd.coeff_y, np.int32),
            np.ascontiguousarray(fd.coeff_cb, np.int32) if chroma else None,
            np.ascontiguousarray(fd.coeff_cr, np.int32) if chroma else None,
            chroma,
            np.ascontiguousarray(fd.cmode4, np.uint8)
            if fd.cmode4 is not None and (fd.cmode4 != 255).any() else None)


def _ptr(a):
    return None if a is None else a.ctypes.data


def _sao_blob(params, fd):
    """FrameData's SAO fields in the native per-CTU 20-byte layout
    (merge, type x2, eo x2, band position x3, offsets x12), or None
    when SAO is off."""
    if not params.sao_enabled:
        return None
    cy, cx = fd.sao_merge.shape
    blob = np.zeros((cy * cx, 20), np.int8)
    blob[:, 0] = fd.sao_merge.reshape(-1)
    blob[:, 1:3] = fd.sao_type.reshape(-1, 2)
    blob[:, 3:5] = fd.sao_eo.reshape(-1, 2)
    blob[:, 5:8] = fd.sao_bp.reshape(-1, 3)
    blob[:, 8:20] = fd.sao_off.reshape(-1, 12)
    return blob


def _qp_ctu_arr(params, fd):
    """A writable copy of fd.qp_ctu for the native serializer, which
    turns it into the effective per-CTU QPs (a CTU without coded
    coefficients signals no cu_qp_delta and keeps its predictor), or
    None when cu_qp_delta is off."""
    if not params.cu_qp_delta or fd.qp_ctu is None:
        return None
    return np.array(fd.qp_ctu, np.int32, order="C")


def _read_back(fd, qpc) -> None:
    """fd.qp_ctu takes the effective map the serializer wrote."""
    if qpc is not None:
        fd.qp_ctu[:] = qpc


def encode_slice_data_native(params, fd, qp: int) -> bytes:
    """CABAC slice data + final alignment of an I slice (explicit chroma
    modes where fd.cmode4 holds them; per-CTU QP where params.cu_qp_delta
    is set and fd.qp_ctu holds it; fd.qp_ctu becomes the effective
    map)."""
    depth8, mode4, cy, ccb, ccr, chroma, cmode4 = _frame_args(params,
                                                              fd)
    cap = cy.nbytes * 2 + 65536
    out = np.empty(cap, np.uint8)
    sao = _sao_blob(params, fd)
    qpc = _qp_ctu_arr(params, fd)
    n = get_lib().ktpu_encode_slice_data(
        params.width, params.height, chroma, qp,
        params.log2_ctu, params.log2_min_cu, params.log2_max_tu,
        depth8.ctypes.data, mode4.ctypes.data, cy.ctypes.data,
        _ptr(ccb), _ptr(ccr), out.ctypes.data, cap,
        1 if params.sign_hiding else 0, _ptr(sao), _ptr(qpc), _ptr(cmode4))
    if n < 0:
        raise RuntimeError("native slice buffer overflow")
    _read_back(fd, qpc)
    return out[:n].tobytes()


def encode_slice_data_native_wpp(params, fd, qp: int):
    """WPP variant: returns (bytes, per-substream byte sizes)."""
    depth8, mode4, cy, ccb, ccr, chroma, cmode4 = _frame_args(params,
                                                              fd)
    cap = cy.nbytes * 2 + 65536
    out = np.empty(cap, np.uint8)
    sizes = np.zeros(params.height_in_ctus + 1, np.int64)
    nss = np.zeros(1, np.int32)
    sao = _sao_blob(params, fd)
    qpc = _qp_ctu_arr(params, fd)
    n = get_lib().ktpu_encode_slice_data_wpp(
        params.width, params.height, chroma, qp,
        params.log2_ctu, params.log2_min_cu, params.log2_max_tu,
        depth8.ctypes.data, mode4.ctypes.data, cy.ctypes.data,
        _ptr(ccb), _ptr(ccr), out.ctypes.data, cap, sizes.ctypes.data,
        nss.ctypes.data, 1 if params.sign_hiding else 0, _ptr(sao),
        _ptr(qpc), _ptr(cmode4))
    if n < 0:
        raise RuntimeError("native slice buffer overflow")
    _read_back(fd, qpc)
    return out[:n].tobytes(), [int(v) for v in sizes[:int(nss[0])]]


def encode_slice_data_native_p(params, fd, qp: int, wpp: bool,
                               slice_type: int = 1, nthreads: int = 1,
                               nref_l0: int = 1):
    """P or B slice (slice_type 1 or 0; no partitions; explicit chroma
    modes and per-CTU QP as in ``encode_slice_data_native``).  A P slice
    has nref_l0 active L0 references, whose ref_idx comes from fd.ref8;
    a B slice has one reference per list and reads fd.dir8, fd.mvp8_l1
    and fd.mvd8_l1.  Returns (bytes,
    per-substream byte sizes), the sizes empty when wpp is off.
    nthreads > 1 encodes the WPP substreams on that many threads."""
    depth8, mode4, cy, ccb, ccr, chroma, cmode4 = _frame_args(params,
                                                              fd)
    inter8 = np.ascontiguousarray(fd.inter8, np.uint8)
    skip8 = np.ascontiguousarray(fd.skip8, np.uint8)
    merge8 = np.ascontiguousarray(fd.merge8, np.int8)
    mvp8 = np.ascontiguousarray(fd.mvp8, np.uint8)
    mvd8 = np.ascontiguousarray(fd.mvd8, np.int32)
    # B-slice fields (unread in a P slice).
    dir8 = np.ascontiguousarray(fd.dir8, np.uint8)
    mvp8_l1 = np.ascontiguousarray(fd.mvp8_l1, np.uint8)
    mvd8_l1 = np.ascontiguousarray(fd.mvd8_l1, np.int32)
    cap = cy.nbytes * 2 + 65536
    out = np.empty(cap, np.uint8)
    sizes = np.zeros(params.height_in_ctus + 1, np.int64)
    nss = np.zeros(1, np.int32)
    sao = _sao_blob(params, fd)
    ref8 = (np.ascontiguousarray(fd.ref8, np.uint8) if nref_l0 > 1
            else None)
    qpc = _qp_ctu_arr(params, fd)
    part8 = (None if fd.part8 is None
             else np.ascontiguousarray(fd.part8, np.uint8))
    n = get_lib().ktpu_encode_slice_data_p(
        params.width, params.height, chroma, qp, 1 if wpp else 0,
        slice_type, params.log2_ctu, params.log2_min_cu, params.log2_max_tu,
        depth8.ctypes.data, mode4.ctypes.data, cy.ctypes.data,
        _ptr(ccb), _ptr(ccr), inter8.ctypes.data, skip8.ctypes.data,
        merge8.ctypes.data, mvp8.ctypes.data, mvd8.ctypes.data,
        dir8.ctypes.data, mvp8_l1.ctypes.data, mvd8_l1.ctypes.data,
        out.ctypes.data, cap, sizes.ctypes.data, nss.ctypes.data,
        (1 if params.sign_hiding else 0) | (int(nthreads) << 8),
        _ptr(sao), _ptr(ref8), int(nref_l0), _ptr(part8),
        1 if params.amp else 0, _ptr(qpc), _ptr(cmode4))
    if n < 0:
        raise RuntimeError("native slice buffer overflow")
    _read_back(fd, qpc)
    szs = [int(v) for v in sizes[:int(nss[0])]] if wpp else []
    return out[:n].tobytes(), szs
