"""All-intra frame encoder: device search + wavefront recon + host CABAC.

Counterpart of the fixed-grid all-intra part of
kvazaar_tpu/encoder/frame_encoder.py (IntraFrameEncoder at cu 8/16):
the device program (mode search, wavefront reconstruction, deblocking,
per-frame SSE) is plain tensor code on the encoder's device, with the
reconstruction's inner loop in the CUDA kernel on a card; the host
serializes slice data with the native CABAC (WPP substreams) and frames
the NAL units with the shared header writers.

Transfers are dense: int16 levels, uint8 modes and recon and float32
SSEs come back with one ``.cpu()`` per tensor (no packed upload or
nibble level pack).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import math

import numpy as np
import torch

from kvazaar_tpu.bitstream.bits import BitWriter, nal_unit
from kvazaar_tpu.bitstream.cabac import CabacEncoder
from kvazaar_tpu.bitstream.contexts import Contexts
from kvazaar_tpu.bitstream.headers import (StreamParams, compute_level_idc,
                                           write_pps, write_slice_header,
                                           write_sps, write_vps)
from kvazaar_tpu.bitstream.syntax import FrameData, SliceDataEncoder
from kvazaar_tpu.config import Config
from kvazaar_tpu.constants import CHROMA_QP_TAB, NAL_IDR_W_RADL, SLICE_I
from kvazaar_tpu.encoder.geometry import make_intra_plan
from kvazaar_tpu_torch.bitstream import native
from kvazaar_tpu_torch.encoder.intra_recon import (blocks_to_plane,
                                                   reconstruct_frames)
from kvazaar_tpu_torch.encoder.intra_search import search_frame_modes
from kvazaar_tpu_torch.ops.deblock import deblock_frame


def chroma_qp(qp: int) -> int:
    """H.265 Table 8-10 chroma QP (4:2:0)."""
    return int(CHROMA_QP_TAB[min(max(qp, 0), 51)])


def qp_to_lambda(qp: int) -> float:
    """I-frame lambda: 0.57 * 2^((qp-12)/3)."""
    return 0.57 * 2.0 ** ((qp - 12) / 3.0)


def pad_to_multiple(plane: np.ndarray, mult: int) -> np.ndarray:
    h, w = plane.shape
    h2 = -(-h // mult) * mult
    w2 = -(-w // mult) * mult
    if (h2, w2) == (h, w):
        return plane
    return np.pad(plane, ((0, h2 - h), (0, w2 - w)), mode="edge")


@dataclasses.dataclass
class FrameResult:
    nals: bytes              # slice NAL (headers are emitted separately)
    recon_y: np.ndarray      # coded-size reconstruction (None when the
                             # caller skipped the pixel transfer)
    recon_cb: np.ndarray | None
    recon_cr: np.ndarray | None
    frame_data: FrameData
    bits: int
    sse: tuple = None        # (sse_y, sse_cb, sse_cr) device-computed


def unsupported(cfg: Config) -> list:
    """Names of the config features the port does not cover yet."""
    out = []
    if cfg.intra_min_cu != cfg.intra_max_cu:
        out.append("variable CU trees")
    if cfg.intra_max_cu not in (8, 16):
        out.append(f"CU size {cfg.intra_max_cu} (8 and 16 are ported)")
    if cfg.input_bitdepth != 8:
        out.append("bit depths other than 8")
    if cfg.rd >= 2:
        out.append("--rd >= 2")
    for name, on in (("SAO", cfg.sao), ("RDOQ", cfg.rdoq),
                     ("sign hiding", cfg.signhide),
                     ("transform skip", cfg.transform_skip),
                     ("lossless", cfg.lossless),
                     ("implicit RDPCM", cfg.implicit_rdpcm),
                     ("scaling lists", cfg.scaling_list != "off"),
                     ("intra TU split", cfg.tr_depth_intra > 0),
                     ("tiles", (cfg.tiles_x, cfg.tiles_y) != (1, 1)),
                     ("slices", cfg.slices != "none"),
                     ("mesh sharding", cfg.mesh_tiles > 1),
                     ("selective encryption", cfg.crypto is not None),
                     ("field (interlaced) sources",
                      cfg.source_scan_type != 0),
                     ("per-CTU QP (rate control, ROI, AQ)",
                      cfg.cu_qp_delta_active)):
        if on:
            out.append(name)
    return out


class IntraFrameEncoder:
    """Encodes all-intra frames of one fixed geometry/config on
    ``device``."""

    def __init__(self, cfg: Config, device):
        cfg.validate()
        missing = unsupported(cfg)
        if missing:
            raise NotImplementedError(
                "kvazaar_tpu_torch does not cover: " + ", ".join(missing))
        self.cfg = cfg
        self.device = torch.device(device)
        self.chroma = cfg.chroma_format == 420
        self.cu = cfg.intra_max_cu
        self.bitdepth = cfg.input_bitdepth
        self.coded_w = -(-cfg.width // self.cu) * self.cu
        self.coded_h = -(-cfg.height // self.cu) * self.cu
        self.plan = make_intra_plan(self.coded_w, self.coded_h, self.cu,
                                    self.chroma, tiles=(1, 1))
        self.params = StreamParams(
            width=self.coded_w, height=self.coded_h,
            bitdepth=self.bitdepth,
            chroma_format_idc=1 if self.chroma else 0,
            qp=cfg.qp,
            deblock_enabled=cfg.deblock,
            sao_enabled=False,
            source_scan_type=cfg.source_scan_type,
            wpp=cfg.wpp,
            conf_win=(0, self.coded_w - cfg.width, 0,
                      self.coded_h - cfg.height),
            tmvp_enabled=cfg.tmvp,
            amp=cfg.amp,
            tiles=(1, 1),
            framerate=(cfg.framerate_num, cfg.framerate_denom),
            sar=(cfg.sar_width, cfg.sar_height),
            overscan=cfg.overscan, videoformat=cfg.videoformat,
            fullrange=cfg.fullrange, colorprim=cfg.colorprim,
            transfer=cfg.transfer, colormatrix=cfg.colormatrix,
            chroma_loc=cfg.chromaloc,
            tier=1 if cfg.tier == "high" else 0,
            level_idc=int(round(float(cfg.level) * 30))
            if cfg.level is not None else compute_level_idc(
                self.coded_w, self.coded_h,
                cfg.framerate_num / max(cfg.framerate_denom, 1)))
        self.qp_c = chroma_qp(cfg.qp)
        self.lambda_satd = math.sqrt(qp_to_lambda(cfg.qp))
        self._host_pool = None

    def headers(self) -> bytes:
        return (write_vps(self.params) + write_sps(self.params)
                + write_pps(self.params))

    def _encode_from_planes(self, ys, cbs, crs):
        """Device program for a (B, H, W) batch: returns (modes uint8
        (B, By, Bx), levels int16 (y, cb, cr), recon uint8 (y, cb, cr),
        sses float32 (B, 3)), all on the encoder's device."""
        modes = torch.stack([
            search_frame_modes(y, self.plan, self.lambda_satd,
                               self.bitdepth, self.cfg.rd >= 1)[0]
            for y in ys])
        (rec_y, lv_y, rec_cb, lv_cb, rec_cr,
         lv_cr) = reconstruct_frames(ys, cbs, crs, modes, self.plan,
                                     self.cfg.qp, self.qp_c, self.bitdepth)
        if self.cfg.deblock:
            # In-loop filter as a batched post-pass: intra prediction
            # reads unfiltered samples, so deblocking never feeds the
            # wavefront.
            dy, dcb, dcr = deblock_frame(rec_y, rec_cb, rec_cr,
                                         self.cfg.qp, self.cu,
                                         self.bitdepth)
            rec_y = dy.to(torch.uint8)
            if rec_cb is not None:
                rec_cb = dcb.to(torch.uint8)
                rec_cr = dcr.to(torch.uint8)

        # Distortion over the conformance window only: padded rows and
        # columns reconstruct near-perfectly and would inflate PSNR.
        tw, th = self.cfg.width, self.cfg.height

        def sse(a, b):
            f = a.shape[1] * 2 // self.coded_h     # 2=luma, 1=chroma
            hh, ww = th * f // 2, tw * f // 2
            d = (a[:, :hh, :ww].to(torch.float32)
                 - b[:, :hh, :ww].to(torch.float32))
            return torch.sum(d * d, dim=(1, 2))

        zeros = torch.zeros(ys.shape[0], dtype=torch.float32,
                            device=ys.device)
        sses = torch.stack(
            [sse(rec_y, ys),
             sse(rec_cb, cbs) if cbs is not None else zeros,
             sse(rec_cr, crs) if crs is not None else zeros], dim=1)
        return (modes.to(torch.uint8), (lv_y, lv_cb, lv_cr),
                (rec_y, rec_cb, rec_cr), sses)

    def host_pack_sources(self, frames):
        """(y, cb, cr) list -> padded (B, H, W) uint8 host planes."""
        s = self.cu
        ys = np.stack([pad_to_multiple(np.asarray(f[0], np.uint8), s)
                       for f in frames])
        cbs = crs = None
        if self.chroma:
            cbs = np.stack([pad_to_multiple(np.asarray(f[1], np.uint8),
                                            s // 2) for f in frames])
            crs = np.stack([pad_to_multiple(np.asarray(f[2], np.uint8),
                                            s // 2) for f in frames])
        return ys, cbs, crs

    def submit_frames(self, frames):
        """Upload a batch and queue its device program (asynchronous on
        a card); pair with download_frames + finalize_downloaded."""
        def up(a):
            return None if a is None else \
                torch.from_numpy(a).to(self.device).to(torch.int32)

        ys, cbs, crs = (up(a) for a in self.host_pack_sources(frames))
        return len(frames), self._encode_from_planes(ys, cbs, crs)

    def download_frames(self, handle, need_recon: bool = True):
        """The device->host copies of a submitted batch (one per
        tensor); safe to call from a worker thread."""
        nframes, (modes, levels, recs, sses) = handle

        def host(t):
            return None if t is None else t.cpu().numpy()

        want_pixels = need_recon or self.cfg.hash != "none"
        return (nframes, host(modes), [host(lv) for lv in levels],
                [host(r) for r in recs] if want_pixels
                else [None, None, None], host(sses))

    def finalize_downloaded(self, downloaded) -> list[FrameResult]:
        """Host CABAC + NAL framing of a downloaded batch, one frame per
        pool task (the native CABAC releases the GIL)."""
        nframes, modes, (lv_y, lv_cb, lv_cr), (rec_y, rec_cb, rec_cr), \
            sses = downloaded
        if self._host_pool is None:
            self._host_pool = cf.ThreadPoolExecutor(
                max_workers=self.cfg.threads or 8)

        def pick(a, i):
            return None if a is None else a[i]

        futs = [self._host_pool.submit(
            self._host_finalize, modes[i], lv_y[i], pick(lv_cb, i),
            pick(lv_cr, i), pick(rec_y, i), pick(rec_cb, i),
            pick(rec_cr, i)) for i in range(nframes)]
        out = [f.result() for f in futs]
        for i, r in enumerate(out):
            r.sse = tuple(float(v) for v in sses[i])
        return out

    def _host_finalize(self, modes, lv_y, lv_cb, lv_cr, rec_y, rec_cb,
                       rec_cr) -> FrameResult:
        s = self.cu
        fd = FrameData.empty(self.coded_w, self.coded_h, self.chroma)
        fd.depth8[:] = 6 - int(math.log2(s))
        fd.mode4[:] = np.kron(modes, np.ones((s // 4, s // 4), np.uint8))
        fd.coeff_y[:] = blocks_to_plane(lv_y, self.plan, s, self.coded_w,
                                        self.coded_h)
        if self.chroma:
            fd.coeff_cb[:] = blocks_to_plane(lv_cb, self.plan, s // 2,
                                             self.coded_w // 2,
                                             self.coded_h // 2)
            fd.coeff_cr[:] = blocks_to_plane(lv_cr, self.plan, s // 2,
                                             self.coded_w // 2,
                                             self.coded_h // 2)
        # Slice data first (entry-point offsets go into the header).
        sizes = []
        if native.available():
            if self.params.wpp:
                data, sizes = native.encode_slice_data_native_wpp(
                    self.params, fd, self.cfg.qp)
            else:
                data = native.encode_slice_data_native(self.params, fd,
                                                       self.cfg.qp)
        else:
            dw = BitWriter()
            enc = SliceDataEncoder(self.params, fd,
                                   Contexts(SLICE_I, self.cfg.qp),
                                   CabacEncoder(dw))
            if self.params.wpp:
                sizes = enc.encode_slice_data_wpp()
            else:
                enc.encode_slice_data()
                dw.align_zero()
            data = dw.get_bytes()
        w = BitWriter()
        write_slice_header(w, self.params, SLICE_I, NAL_IDR_W_RADL,
                           self.cfg.qp, poc=0, ref_list_l0=[],
                           num_entry_points=max(len(sizes) - 1, 0),
                           entry_point_offsets=sizes[:-1])
        nal = nal_unit(w.get_bytes() + data, NAL_IDR_W_RADL)
        if self.cfg.hash in ("md5", "checksum") and rec_y is not None:
            from kvazaar_tpu.bitstream.headers import \
                write_picture_hash_sei
            nal += write_picture_hash_sei((rec_y, rec_cb, rec_cr),
                                          self.bitdepth,
                                          kind=self.cfg.hash)
        return FrameResult(nals=nal, recon_y=rec_y, recon_cb=rec_cb,
                           recon_cr=rec_cr, frame_data=fd,
                           bits=len(nal) * 8)

    def encode_frames(self, frames) -> list[FrameResult]:
        """Encode a batch of frames through one batched device program."""
        return self.finalize_downloaded(
            self.download_frames(self.submit_frames(frames)))

    def encode_frame(self, y: np.ndarray, cb=None, cr=None) -> FrameResult:
        """y: (H, W) uint8 source luma; cb/cr half size (4:2:0)."""
        return self.encode_frames([(y, cb, cr)])[0]

    def close(self) -> None:
        """Stop the host CABAC pool."""
        if self._host_pool is not None:
            self._host_pool.shutdown()
            self._host_pool = None


def psnr(a: np.ndarray, b: np.ndarray, bitdepth: int = 8) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return 999.99
    peak = (1 << bitdepth) - 1
    return 10.0 * math.log10(peak * peak / mse)
