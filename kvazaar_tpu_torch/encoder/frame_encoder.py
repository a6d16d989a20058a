"""Frame encoder: device search + wavefront recon + host CABAC.

Counterpart of the fixed-grid part of
kvazaar_tpu/encoder/frame_encoder.py (IntraFrameEncoder at cu 8/16, with
PFrameMixin's single-reference P frames): the device program (intra
mode search; for P frames motion search, the intra/inter decision and
motion compensation; wavefront reconstruction, deblocking, per-frame
SSE) is plain tensor code on the encoder's device, with the
reconstruction's inner loop in the CUDA kernel on a card; the host
decides merge/AMVP signalling, serializes slice data with the native
CABAC (WPP substreams) and frames the NAL units.

Transfers are dense: int16 levels, uint8 modes and recon, the inter map
and MVs and float32 SSEs come back with one ``.cpu()`` per tensor (no
packed upload or nibble level pack).  The reference picture of the next
P frame (the DPB) stays on the device as the deblocked reconstruction.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import math

import numpy as np
import torch

from kvazaar_tpu_torch.bitstream.bits import BitWriter, nal_unit
from kvazaar_tpu_torch.bitstream.cabac import CabacEncoder
from kvazaar_tpu_torch.bitstream.contexts import Contexts
from kvazaar_tpu_torch.bitstream.headers import (StreamParams,
                                                 compute_level_idc,
                                                 write_pps,
                                                 write_slice_header,
                                                 write_sps, write_vps)
from kvazaar_tpu_torch.bitstream.syntax import FrameData, SliceDataEncoder
from kvazaar_tpu_torch.config import Config
from kvazaar_tpu_torch.constants import (CHROMA_QP_TAB, NAL_IDR_W_RADL,
                                         NAL_TRAIL_R, SLICE_I, SLICE_P)
from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
from kvazaar_tpu_torch.bitstream import native
from kvazaar_tpu_torch.encoder.inter_cands import (amvp_candidates,
                                                   merge_candidates)
from kvazaar_tpu_torch.encoder.inter_search import (_f32, mc_planes,
                                                    search_inter_frame)
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
    if cfg.intra_period != 1:
        for name, on in (
                ("SMP/AMP inter partitions", cfg.smp or cfg.amp),
                ("TMVP", cfg.tmvp),
                ("low-delay GOP structures (--gop lp-*)",
                 cfg.lp_gop is not None),
                ("more than one reference frame", cfg.ref_frames > 1),
                ("variable inter CU sizes",
                 (cfg.inter_min_cu, cfg.inter_max_cu)
                 != (cfg.intra_max_cu, cfg.intra_max_cu))):
            if on:
                out.append(name)
    return out


def compute_bs_maps(is_inter, cbf_luma_blk, mv, ref=None):
    """Per-CU-edge boundary strengths (H.265 8.7.2.4, P slices).

    is_inter/cbf: (By, Bx) bool; mv: (By, Bx, 2) quarter-pel; ref:
    optional (By, Bx) L0 ref indices (different pictures force bS >= 1).
    Returns (bs_v, bs_h) int32 (By, Bx): bS of each block's left / top
    edge (column/row 0 entries are picture borders, never filtered)."""
    intra_b = ~is_inter

    def edge(sl_a, sl_b):
        a_i, b_i = intra_b[sl_a], intra_b[sl_b]
        cbf = cbf_luma_blk[sl_a] | cbf_luma_blk[sl_b]
        mvd = torch.any(torch.abs(mv[sl_a] - mv[sl_b]) >= 4, dim=-1)
        if ref is not None:
            mvd = mvd | (ref[sl_a] != ref[sl_b])
        return torch.where(a_i | b_i, 2,
                           torch.where(cbf | mvd, 1, 0)).to(torch.int32)

    by, bx = is_inter.shape
    all_ = slice(None)
    bs_v = torch.zeros((by, bx), dtype=torch.int32, device=mv.device)
    bs_h = torch.zeros((by, bx), dtype=torch.int32, device=mv.device)
    bs_v[:, 1:] = edge((all_, slice(0, bx - 1)), (all_, slice(1, bx)))
    bs_h[1:, :] = edge((slice(0, by - 1), all_), (slice(1, by), all_))
    return bs_v, bs_h


class PFrameMixin:
    """Single-reference P frames of the fixed grid (the non-SMP,
    one-reference, fixed-QP branch of the JAX package's PFrameMixin)."""

    def _p_predict(self, yp, ref):
        """Search and decision of one P frame: (H, W) int32 source luma
        and the (y, cb, cr) reference planes.  Returns (modes int32
        (By, Bx), inter map bool, mv int32 (By, Bx, 2), MC prediction
        planes (y, cb, cr) int32)."""
        ref_y, ref_cb, ref_cr = ref
        plan = self.plan
        modes, intra_cost = search_frame_modes(
            yp, plan, self.lambda_satd, self.bitdepth, self.cfg.rd >= 1)
        mv, inter_cost = search_inter_frame(
            yp, ref_y, plan, self.lambda_me, self.cfg.me_range,
            self.bitdepth, subpel=self.cfg.me_subpel)
        # Mode decision (a slight inter bias covers un-modelled merge
        # savings), in float32 as JAX forms it.
        inter_map = inter_cost <= intra_cost * _f32(1.02)
        mv = torch.where(inter_map[..., None], mv, 0).to(torch.int32)
        return modes, inter_map, mv, mc_planes(ref_y, ref_cb, ref_cr, mv,
                                               plan, self.bitdepth)

    def _p_from_planes(self, yp, cbp, crp, ref):
        """Device program of one P frame: (H, W) int32 source planes and
        the (y, cb, cr) reference planes.  Returns (modes uint8, inter
        map bool, mv int32 (By, Bx, 2), levels (y, cb, cr), deblocked
        recon uint8 (y, cb, cr), sses float32 (3,)), on the device."""
        plan = self.plan
        modes, inter_map, mv, (mc_y, mc_cb, mc_cr) = self._p_predict(yp,
                                                                     ref)

        def one(t):
            return None if t is None else t[None]

        rec_y, lv_y, rec_cb, lv_cb, rec_cr, lv_cr = reconstruct_frames(
            yp[None], one(cbp), one(crp), modes[None], plan, self.cfg.qp,
            self.qp_c, self.bitdepth, is_inter=inter_map[None],
            mc_y=mc_y[None], mc_cb=one(mc_cb), mc_cr=one(mc_cr))
        bs = None
        if self.cfg.deblock:
            cbf_blk = (lv_y[0] != 0).flatten(1).any(dim=1).reshape(
                plan.blocks_y, plan.blocks_x)
            bs = compute_bs_maps(inter_map, cbf_blk, mv)
        recs, sses = self._deblock_sse(
            (yp[None], one(cbp), one(crp)), (rec_y, rec_cb, rec_cr), bs)

        def first(t):
            return None if t is None else t[0]

        return (modes.to(torch.uint8), inter_map, mv,
                (lv_y[0], first(lv_cb), first(lv_cr)),
                tuple(first(r) for r in recs), sses[0])

    def submit_p(self, y, cb, cr, refs):
        """Upload one frame and queue its P program (asynchronous on a
        card).  refs: [(ref_poc, (y, cb, cr) device planes)], one
        reference."""
        if len(refs) != 1:
            raise NotImplementedError("P frames with more than one "
                                      "reference are not ported")
        ys, cbs, crs = (None if a is None else a[0] for a in
                        self._upload(self.host_pack_sources([(y, cb, cr)])))
        return self._p_from_planes(ys, cbs, crs, refs[0][1])

    def download_p(self, handle, need_recon: bool = True):
        """The device->host copies of a submitted P frame; safe to call
        from a worker thread.  The device recon stays in the result as
        the next frame's reference."""
        modes, inter_map, mv, levels, recs, sses = handle

        def host(t):
            return None if t is None else t.cpu().numpy()

        want_pixels = need_recon or self.cfg.hash != "none"
        return ((tuple(host(lv) for lv in levels), host(modes),
                 host(inter_map), host(mv), host(sses)),
                tuple(host(r) for r in recs) if want_pixels
                else (None, None, None), recs)

    def finalize_p_downloaded(self, downloaded, poc: int, ref_pocs,
                              need_recon: bool = True):
        """Host stage: merge/AMVP signalling decisions + CABAC of the
        plain single-reference IPPP stream shape (the JAX package's
        ``multi=False``).  Returns (FrameResult, the device recon
        planes)."""
        ((lv_y, lv_cb, lv_cr), modes, inter_map, mv, sses), rec_np, \
            recs = downloaded
        merge_idx, mvp_idx, mvd = self._merge_amvp_fast(inter_map, mv)
        fd = self._assemble_p_frame_data(
            modes, inter_map, mv, merge_idx, mvp_idx, mvd, lv_y, lv_cb,
            lv_cr)
        nal = self._serialize_p(fd, poc, poc - ref_pocs[0],
                                tmvp=self.cfg.tmvp)
        if not (need_recon or self.cfg.hash != "none"):
            rec_np = (None, None, None)
        if self.cfg.hash in ("md5", "checksum"):
            from kvazaar_tpu_torch.bitstream.headers import \
                write_picture_hash_sei
            nal += write_picture_hash_sei(rec_np, self.bitdepth,
                                          kind=self.cfg.hash)
        res = FrameResult(
            nals=nal, recon_y=rec_np[0], recon_cb=rec_np[1],
            recon_cr=rec_np[2], frame_data=fd, bits=len(nal) * 8,
            sse=tuple(float(v) for v in sses))
        return res, recs

    def _merge_amvp_fast(self, inter_map, mv):
        """Vectorized single-ref merge/AMVP signalling decisions (all
        MVs are final before this runs — no decode-order recurrence)."""
        mcands = merge_candidates(inter_map, mv, self.plan.avail)
        eq = np.all(mcands == mv[:, :, None, :], axis=-1)
        has_merge = eq.any(axis=-1)
        merge_idx = np.where(has_merge, eq.argmax(axis=-1), -1)
        acands = amvp_candidates(inter_map, mv, self.plan.avail)
        d0 = np.abs(mv - acands[:, :, 0]).sum(axis=-1)
        d1 = np.abs(mv - acands[:, :, 1]).sum(axis=-1)
        mvp_idx = (d1 < d0).astype(np.uint8)
        mvd = mv - np.take_along_axis(
            acands, mvp_idx[..., None, None].astype(np.int64),
            axis=2)[:, :, 0]
        return merge_idx, mvp_idx, mvd

    def _assemble_p_frame_data(self, modes, inter_map, mv, merge_idx,
                               mvp_idx, mvd, lv_y, lv_cb, lv_cr):
        s = self.cu
        c8 = s // 8
        fd = FrameData.empty(self.coded_w, self.coded_h, self.chroma)
        fd.depth8[:] = 6 - int(math.log2(s))
        fd.mode4[:] = np.kron(modes.astype(np.uint8),
                              np.ones((s // 4, s // 4), np.uint8))
        fd.coeff_y[:] = blocks_to_plane(lv_y, self.plan, s,
                                        self.coded_w, self.coded_h)
        if self.chroma:
            fd.coeff_cb[:] = blocks_to_plane(lv_cb, self.plan, s // 2,
                                             self.coded_w // 2,
                                             self.coded_h // 2)
            fd.coeff_cr[:] = blocks_to_plane(lv_cr, self.plan, s // 2,
                                             self.coded_w // 2,
                                             self.coded_h // 2)

        ones = np.ones((c8, c8), np.uint8)
        fd.inter8[:] = np.kron(inter_map.astype(np.uint8), ones)
        fd.mv8[:] = np.kron(mv, np.ones((c8, c8, 1), np.int32)) \
            .reshape(fd.mv8.shape)

        # Per-CU zero-coefficient detection → skip (merge CUs only).
        by, bx = inter_map.shape
        czero = np.ones((by, bx), bool)
        ys = fd.coeff_y.reshape(by, s, bx, s)
        czero &= ~np.any(ys, axis=(1, 3))
        if self.chroma:
            s2 = s // 2
            cbs = fd.coeff_cb.reshape(by, s2, bx, s2)
            crs = fd.coeff_cr.reshape(by, s2, bx, s2)
            czero &= ~np.any(cbs, axis=(1, 3))
            czero &= ~np.any(crs, axis=(1, 3))

        skip = inter_map & (merge_idx >= 0) & czero
        fd.skip8[:] = np.kron(skip.astype(np.uint8), ones)
        # merge8/mvp8/mvd8 live at CU marker cells.
        fd.merge8[::c8, ::c8] = np.where(inter_map, merge_idx,
                                         -1).astype(np.int8)
        use_amvp = inter_map & (merge_idx < 0)
        fd.mvp8[::c8, ::c8] = np.where(use_amvp, mvp_idx, 0)
        fd.mvd8[::c8, ::c8] = np.where(use_amvp[..., None], mvd, 0)
        return fd

    def _serialize_p(self, fd, poc, ref_poc_diff, tmvp: bool = False):
        """P slice NAL: native CABAC (WPP substreams) where the library
        builds, else the Python serializer; then the slice header."""
        qp = self.cfg.qp
        if native.available():
            data, sizes = native.encode_slice_data_native_p(
                self.params, fd, qp, self.params.wpp,
                nthreads=self.cfg.threads or 4)
        else:
            sizes = []
            dw = BitWriter()
            enc = SliceDataEncoder(self.params, fd, Contexts(SLICE_P, qp),
                                   CabacEncoder(dw), nref_l0=1)
            if self.params.wpp:
                sizes = enc.encode_slice_data_wpp()
            else:
                enc.encode_slice_data()
                dw.align_zero()
            data = dw.get_bytes()
        w = BitWriter()
        write_slice_header(w, self.params, SLICE_P, NAL_TRAIL_R, qp,
                           poc=poc, ref_poc_diff=ref_poc_diff,
                           ref_list_l0=None, retained_l0=(), tmvp=tmvp,
                           num_entry_points=max(len(sizes) - 1, 0),
                           entry_point_offsets=sizes[:-1])
        return nal_unit(w.get_bytes() + data, NAL_TRAIL_R)

    def encode_p_frame(self, y, cb=None, cr=None, poc: int = 1,
                       ref_poc: int = 0) -> FrameResult:
        """Plain IPPP P frame against the DPB (the previous frame's
        deblocked reconstruction, on the device)."""
        if self._dpb is None:
            raise RuntimeError("encode_p_frame needs a reference: encode "
                               "an intra frame first")
        handle = self.submit_p(y, cb, cr, [(ref_poc, self._dpb)])
        res, recs = self.finalize_p_downloaded(
            self.download_p(handle), poc, [ref_poc])
        self._dpb = recs
        return res


class IntraFrameEncoder(PFrameMixin):
    """Encodes I frames (batched) and single-reference P frames of one
    fixed geometry/config on ``device`` (the name follows the JAX
    package's class)."""

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
        self.lambda_me = self.lambda_satd
        self._host_pool = None
        # Reference planes of the next P frame: the last frame's
        # deblocked reconstruction (y, cb, cr) on the device.
        self._dpb = None

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
        recs, sses = self._deblock_sse((ys, cbs, crs),
                                       (rec_y, rec_cb, rec_cr))
        return modes.to(torch.uint8), (lv_y, lv_cb, lv_cr), recs, sses

    def _deblock_sse(self, srcs, recs, bs=None):
        """Deblock a (B, H, W) batch of reconstructions (bs: the (bs_v,
        bs_h) maps of a P frame, None = all-intra) and take each frame's
        SSE against its source.  Returns (recon uint8 (y, cb, cr), sses
        float32 (B, 3))."""
        ys, cbs, crs = srcs
        rec_y, rec_cb, rec_cr = recs
        if self.cfg.deblock:
            # In-loop filter as a batched post-pass: intra prediction
            # reads unfiltered samples, so deblocking never feeds the
            # wavefront.
            bs_v, bs_h = (None, None) if bs is None else bs
            dy, dcb, dcr = deblock_frame(rec_y, rec_cb, rec_cr,
                                         self.cfg.qp, self.cu,
                                         self.bitdepth, bs_v=bs_v,
                                         bs_h=bs_h)
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
        return (rec_y, rec_cb, rec_cr), sses

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

    def _upload(self, planes):
        """Host (B, H, W) uint8 planes -> int32 tensors on the device."""
        return tuple(None if a is None else
                     torch.from_numpy(a).to(self.device).to(torch.int32)
                     for a in planes)

    def submit_frames(self, frames):
        """Upload a batch of I frames and queue its device program
        (asynchronous on a card); pair with download_frames +
        finalize_downloaded.  The batch's last reconstruction becomes
        the DPB."""
        ys, cbs, crs = self._upload(self.host_pack_sources(frames))
        out = self._encode_from_planes(ys, cbs, crs)
        self._dpb = tuple(None if r is None else r[-1] for r in out[2])
        return len(frames), out

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
            from kvazaar_tpu_torch.bitstream.headers import \
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
