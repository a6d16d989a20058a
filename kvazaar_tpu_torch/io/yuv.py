"""Planar YUV file I/O (reference behavior: src/yuv_io.c).

Reads/writes raw planar 4:2:0 or 4:0:0 frames with frame seek
(yuv_io_seek, src/yuv_io.c:256), file-depth -> encoder-depth rounding
shifts and byte-order handling (yuv_io_read's mask/shift loop,
src/yuv_io.c:100-180), and odd-dimension edge fill (the width/height
padding fill of src/yuv_io.c:204-290; further padding to CU multiples
happens in the encoder).
"""

from __future__ import annotations

import queue
import threading

import numpy as np


def frame_size_bytes(width: int, height: int, bitdepth: int,
                     chroma420: bool) -> int:
    pix = width * height
    if chroma420:
        pix += pix // 2
    return pix * (2 if bitdepth > 8 else 1)


def _convert_depth(arr: np.ndarray, file_depth: int,
                   out_depth: int) -> np.ndarray:
    """Bit-depth conversion with rounding on downshift (the reference
    converts at read time so the encoder always sees its internal
    depth, src/yuv_io.c:61-98)."""
    if file_depth == out_depth:
        return arr
    if out_depth > file_depth:
        return (arr.astype(np.uint16) << (out_depth - file_depth))
    sh = file_depth - out_depth
    out = (arr.astype(np.uint32) + (1 << (sh - 1))) >> sh
    maxv = (1 << out_depth) - 1
    dt = np.uint16 if out_depth > 8 else np.uint8
    return np.minimum(out, maxv).astype(dt)


def read_frames(path: str, width: int, height: int, bitdepth: int = 8,
                chroma420: bool = True, max_frames: int | None = None,
                skip: int = 0, file_bitdepth: int | None = None,
                big_endian: bool = False):
    """Yield (y, cb, cr) numpy arrays per frame (cb/cr None for 4:0:0).

    file_bitdepth: bit depth of the samples in the FILE (default =
    bitdepth); conversion to the encoder depth happens here.
    big_endian: 16-bit container byte order (MSB first)."""
    if file_bitdepth is None:
        file_bitdepth = bitdepth
    dtype = (np.dtype(">u2") if big_endian else np.dtype("<u2")) \
        if file_bitdepth > 8 else np.dtype(np.uint8)
    fsz = frame_size_bytes(width, height, file_bitdepth, chroma420)
    n = 0
    with open(path, "rb") as f:
        if skip:
            f.seek(skip * fsz)
        while max_frames is None or n < max_frames:
            buf = f.read(fsz)
            if len(buf) < fsz:
                return
            arr = np.frombuffer(buf, dtype=dtype)
            if arr.dtype.byteorder == ">":
                arr = arr.astype(np.uint16)
            arr = _convert_depth(arr, file_bitdepth, bitdepth)
            y = arr[:width * height].reshape(height, width)
            cb = cr = None
            if chroma420:
                cw, ch = width // 2, height // 2
                o = width * height
                cb = arr[o:o + cw * ch].reshape(ch, cw)
                cr = arr[o + cw * ch:].reshape(ch, cw)
            yield y, cb, cr
            n += 1


def read_frames_async(path: str, width: int, height: int,
                      bitdepth: int = 8, chroma420: bool = True,
                      max_frames: int | None = None, skip: int = 0,
                      file_bitdepth: int | None = None,
                      big_endian: bool = False, depth: int = 2):
    """read_frames through a dedicated reader thread so disk I/O
    overlaps encoding — the reference CLI's input_read_thread with its
    1-slot semaphore ping-pong (src/encmain.c:133-158,440-495); a
    small bounded queue is the same structure with a deeper slot."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _SENTINEL = object()

    def reader():
        try:
            for f in read_frames(path, width, height, bitdepth,
                                 chroma420, max_frames, skip,
                                 file_bitdepth, big_endian):
                q.put(f)
            q.put(_SENTINEL)
        except BaseException as e:       # surface on the consumer side
            q.put(e)

    th = threading.Thread(target=reader, daemon=True)
    th.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            break
        if isinstance(item, BaseException):
            raise item
        yield item
    th.join()


def write_frame(f, y: np.ndarray, cb=None, cr=None,
                bitdepth: int = 8) -> None:
    dtype = np.uint16 if bitdepth > 8 else np.uint8
    f.write(np.ascontiguousarray(y, dtype=dtype).tobytes())
    if cb is not None:
        f.write(np.ascontiguousarray(cb, dtype=dtype).tobytes())
        f.write(np.ascontiguousarray(cr, dtype=dtype).tobytes())
