"""Public encoder API of the port (counterpart of kvazaar_tpu/api.py).

Covers all-intra streams (``intra_period == 1``) and low-delay IPPP
streams with one reference (``intra_period == 0``: one IDR, then P
frames; ``intra_period > 1``: an IDR every N frames) on the fixed CU
grid: ``encode``/``flush`` per frame, and the pipelined
``encode_stream`` in which device compute overlaps the downloads and
host CABAC of earlier frames.  Every other structure raises
NotImplementedError: B frames and GOPs, rate control, ROI/AQ, field
pictures, selective encryption, variable CU trees, SAO.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time

import numpy as np

from kvazaar_tpu_torch.checkpoint import Checkpointer
from kvazaar_tpu_torch.config import Config
from kvazaar_tpu_torch.constants import NAL_IDR_W_RADL, NAL_TRAIL_R, \
    SLICE_I, SLICE_P
from kvazaar_tpu_torch.encoder.frame_encoder import IntraFrameEncoder, psnr


# Frames per device program in encode_stream on all-intra streams (the
# JAX package's batch); IPPP streams submit one frame at a time.
BATCH = 8


@dataclasses.dataclass
class FrameInfo:
    """Per-frame results (reference: kvz_frame_info)."""
    poc: int
    qp: int
    nal_type: int
    slice_type: int
    bits: int
    psnr_y: float
    psnr_u: float
    psnr_v: float


def _unsupported_structure(cfg: Config) -> list:
    """Stream structures the port does not cover (the frame encoder
    rejects the coding tools it does not cover)."""
    out = []
    if cfg.gop_len > 1:
        out.append("GOP structures (B frames)")
    if cfg.bitrate > 0:
        out.append("rate control")
    return out


class Encoder:
    """Streaming encoder on ``device``: results = encoder.encode(frame)
    (a list), encoder.flush() at the end, or
    encoder.encode_stream(frames) for the pipelined path."""

    def __init__(self, cfg: Config, device):
        self.cfg = cfg.validate()
        missing = _unsupported_structure(cfg)
        if missing:
            raise NotImplementedError(
                "kvazaar_tpu_torch does not cover: " + ", ".join(missing))
        self._ckpt = Checkpointer()
        self._intra = IntraFrameEncoder(cfg, device)
        self._poc = 0
        self._last_idr = 0
        self._wrote_headers = False
        self._irap_count = 0
        self.stats = {}

    def _is_intra(self, poc: int) -> bool:
        """--period semantics: 1 all-intra, N > 1 an IDR every N
        frames, 0 only the first frame intra."""
        period = self.cfg.intra_period
        return poc == 0 or period == 1 or (period > 1 and poc % period == 0)

    def headers(self) -> bytes:
        return self._intra.headers()

    def _au_prefix(self, slice_type: int) -> bytes:
        """Per-access-unit prefix: AUD, then parameter sets + version
        SEI at stream start and (--vps-period N) before every Nth IRAP."""
        out = b""
        if self.cfg.aud:
            from kvazaar_tpu_torch.bitstream.headers import write_aud
            out += write_aud(slice_type)
        reemit = False
        if slice_type == SLICE_I:
            n = self._irap_count
            self._irap_count = n + 1
            vp = self.cfg.vps_period
            reemit = (self._wrote_headers and vp > 0 and n > 0
                      and n % vp == 0)
        if not self._wrote_headers or reemit:
            out += self.headers()
            if self.cfg.info and not self._wrote_headers:
                from kvazaar_tpu_torch.bitstream.headers import \
                    write_version_sei
                out += write_version_sei()
            self._wrote_headers = True
        return out

    def encode(self, y: np.ndarray, cb=None, cr=None):
        """Encode one frame.  Returns a list with one (annexb_bytes,
        FrameInfo, recon) result (a list for API parity with the GOP
        paths of the JAX package).  P frames reference the previous
        frame; the POC restarts at every IDR (8.3.1)."""
        is_intra = self._is_intra(self._poc)
        if is_intra:
            res = self._intra.encode_frame(y, cb, cr)
            self._last_idr = self._poc
        else:
            rel = self._poc - self._last_idr
            res = self._intra.encode_p_frame(y, cb, cr, poc=rel,
                                             ref_poc=rel - 1)
        out = self._emit(res, self._poc, (y, cb, cr), is_intra)
        self._poc += 1
        return [out]

    def flush(self):
        """Low-delay streams buffer nothing."""
        return []

    def _emit(self, res, poc, src, is_intra=True):
        chunks = self._au_prefix(SLICE_I if is_intra else SLICE_P)
        y, cb, cr = src
        h, w = y.shape
        rec_y = res.recon_y[:h, :w]
        rec_cb = rec_cr = None
        p_u = p_v = 0.0
        if res.recon_cb is not None:
            rec_cb = res.recon_cb[:h // 2, :w // 2]
            rec_cr = res.recon_cr[:h // 2, :w // 2]
            p_u = psnr(rec_cb, np.asarray(cb, np.int32),
                       self.cfg.input_bitdepth)
            p_v = psnr(rec_cr, np.asarray(cr, np.int32),
                       self.cfg.input_bitdepth)
        info = FrameInfo(
            poc=poc, qp=self.cfg.qp,
            nal_type=NAL_IDR_W_RADL if is_intra else NAL_TRAIL_R,
            slice_type=SLICE_I if is_intra else SLICE_P,
            bits=len(res.nals) * 8,
            psnr_y=psnr(rec_y, np.asarray(y, np.int32),
                        self.cfg.input_bitdepth),
            psnr_u=p_u, psnr_v=p_v)
        self._ckpt.mark_frame(info.poc, info.qp, info.nal_type,
                              info.slice_type, info.bits,
                              (rec_y, rec_cb, rec_cr), res.frame_data)
        return chunks + res.nals, info, (rec_y, rec_cb, rec_cr)

    def _stream_info(self, res, poc, shape, is_intra=True):
        """FrameInfo from the device-computed SSEs (no pixel transfer)."""
        h, w = shape
        peak = (1 << self.cfg.input_bitdepth) - 1

        def p(sse, npix):
            return (10.0 * math.log10(peak * peak * npix / sse)
                    if sse > 0 else 999.99)
        sse = res.sse
        return FrameInfo(
            poc=poc, qp=self.cfg.qp,
            nal_type=NAL_IDR_W_RADL if is_intra else NAL_TRAIL_R,
            slice_type=SLICE_I if is_intra else SLICE_P,
            bits=len(res.nals) * 8,
            psnr_y=p(sse[0], h * w),
            psnr_u=p(sse[1], h * w // 4), psnr_v=p(sse[2], h * w // 4))

    def can_pipeline(self) -> bool:
        """Every config the port accepts takes the pipelined path."""
        return True

    def encode_stream(self, frames, need_recon: bool = False):
        """Pipelined streaming encode over an iterable of (y, cb, cr)
        frames.  Yields (annexb_bytes, FrameInfo, recon) in order;
        recon is (None, None, None) unless need_recon or the config
        requires pixels (picture-hash SEI).

        The main thread uploads and queues each submission on the
        device: batches of BATCH frames on all-intra streams, one frame
        at a time on IPPP streams, where each P frame's program takes
        the previous submission's device reconstruction as its
        reference (the DPB is chained on the device, in submission
        order).  One downloader thread copies finished submissions to
        the host (the copy waits for the device and releases the GIL)
        and finalizer threads run CABAC, so device compute, transfers
        and host serialization of different frames overlap."""
        ife = self._intra
        want_pixels = need_recon or self.cfg.hash != "none"
        self.stats = {"submit_s": 0.0, "download_s": 0.0,
                      "finalize_s": 0.0, "frames": 0}
        stats_lock = threading.Lock()
        n_workers = self.cfg.owf or 3
        dlq: queue.Queue = queue.Queue(maxsize=n_workers + 2)
        finq: queue.Queue = queue.Queue()
        outq: queue.Queue = queue.Queue()

        def downloader():
            while True:
                item = dlq.get()
                if item is None:
                    return
                seq, kind, handle, metas = item
                t0 = time.monotonic()
                try:
                    if kind == "i":
                        dl = ife.download_frames(handle,
                                                 need_recon=want_pixels)
                    else:
                        dl = ife.download_p(handle, need_recon=want_pixels)
                    finq.put((seq, kind, dl, metas))
                except BaseException as e:   # surface on main thread
                    outq.put((seq, None, metas, e))
                with stats_lock:
                    self.stats["download_s"] += time.monotonic() - t0

        def finalizer():
            while True:
                item = finq.get()
                if item is None:
                    return
                seq, kind, dl, metas = item
                try:
                    t1 = time.monotonic()
                    if kind == "i":
                        res = ife.finalize_downloaded(dl)
                    else:
                        (_poc, rel, _shape), = metas
                        res = [ife.finalize_p_downloaded(
                            dl, poc=rel, ref_pocs=[rel - 1],
                            need_recon=want_pixels)[0]]
                    with stats_lock:
                        self.stats["finalize_s"] += time.monotonic() - t1
                        self.stats["frames"] += len(metas)
                    outq.put((seq, res, metas, None))
                except BaseException as e:   # surface on main thread
                    outq.put((seq, None, metas, e))

        dl_th = threading.Thread(target=downloader)
        fin_ths = [threading.Thread(target=finalizer)
                   for _ in range(n_workers)]
        for th in [dl_th] + fin_ths:
            th.start()
        seq_submit = 0
        seq_next = 0
        reorder = {}
        inflight = 0
        batch = []
        batch_n = BATCH if self.cfg.intra_period == 1 else 1

        def emit(res, poc, rel, shape):
            is_intra = rel == 0
            chunks = self._au_prefix(SLICE_I if is_intra else SLICE_P)
            h, w = shape
            rec = (None, None, None)
            if want_pixels and res.recon_y is not None:
                rec = (res.recon_y[:h, :w],
                       None if res.recon_cb is None
                       else res.recon_cb[:h // 2, :w // 2],
                       None if res.recon_cr is None
                       else res.recon_cr[:h // 2, :w // 2])
            info = self._stream_info(res, poc, shape, is_intra)
            self._ckpt.mark_frame(info.poc, info.qp, info.nal_type,
                                  info.slice_type, info.bits, rec,
                                  res.frame_data)
            return chunks + res.nals, info, rec

        def finalize_batch():
            # Workers complete out of order; emit in submission order.
            nonlocal seq_next
            while seq_next not in reorder:
                seq, res, metas, err = outq.get()
                reorder[seq] = (res, metas, err)
            res, metas, err = reorder.pop(seq_next)
            seq_next += 1
            if err is not None:
                raise err
            return [emit(r, poc, rel, shape) for r, (poc, rel, shape) in
                    zip(res, metas)]

        def submit_batch():
            nonlocal seq_submit, inflight
            t0 = time.monotonic()
            metas = []
            for (y, _cb, _cr) in batch:
                if self._is_intra(self._poc):
                    self._last_idr = self._poc
                metas.append((self._poc, self._poc - self._last_idr,
                              y.shape))
                self._poc += 1
            rel = metas[0][1]
            if rel > 0:
                # ife._dpb: the previous submission's reconstruction.
                handle = ife.submit_p(*batch[0], [(rel - 1, ife._dpb)])
                ife._dpb = handle[4]
                kind = "p"
            else:
                handle = ife.submit_frames(batch)
                kind = "i"
            dlq.put((seq_submit, kind, handle, metas))
            seq_submit += 1
            batch.clear()
            inflight += 1
            with stats_lock:
                self.stats["submit_s"] += time.monotonic() - t0

        try:
            for f in frames:
                batch.append(f)
                if len(batch) == batch_n:
                    submit_batch()
                    if inflight > n_workers:
                        yield from finalize_batch()
                        inflight -= 1
            if batch:
                submit_batch()
            while inflight:
                yield from finalize_batch()
                inflight -= 1
        finally:
            dlq.put(None)
            dl_th.join()
            for _ in fin_ths:
                finq.put(None)
            for th in fin_ths:
                th.join()
