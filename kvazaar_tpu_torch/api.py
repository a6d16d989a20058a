"""Public encoder API of the port (counterpart of kvazaar_tpu/api.py).

Covers all-intra streams (``intra_period == 1``) on the fixed CU grid
(with SAO) or with variable CU trees (with RDOQ, sign hiding and SAO),
so every preset's all-intra operating point, and low-delay streams
(``intra_period == 0``: one IDR, then P frames; ``intra_period > 1``:
an IDR every N frames): plain IPPP with one reference, on the fixed CU
grid or, where the config's CU ranges make it one, as variable CU trees
(with RDOQ, sign hiding and SAO; so every preset at ``--gop 0`` with
one reference), and the multi-reference stream shape of low-delay GOP
structures (``lp_gop``, with a QP offset per position) and
``ref_frames > 1`` on the fixed grid, after fixed-grid or variable-tree
I frames, with SAO on the I frames.  So the low-delay presets
ultrafast..fast encode at their defaults, as does ``Config()``.  B
pyramids (``gop_len`` 4 or 8: an IDR, then GOPs coded in the order of
``GOP_TABLES`` from a reorder buffer, each picture at its layer's QP
and lambda) encode on the fixed grid or as variable trees, the latter
with open-GOP CRA anchors and RASL pictures under periodic intra; so
medium..placebo encode at their defaults too.  ``encode``/``flush`` run
per frame (a GOP's pictures come out when its last source arrives; the
tail of a stream codes as a P chain); ``encode_stream`` is pipelined on
all-intra fixed-grid streams and plain fixed-grid IPPP without SAO
(device compute overlaps the downloads and host CABAC of earlier
frames) and per frame otherwise.  ``set_base_qp`` and ``reset_stream``
run a QP ladder on one encoder.  Rate control (``bitrate``) runs on
every one of these structures: the R-lambda controller of
encoder/rate_control.py picks each picture's QP (a GOP's pictures from
the GOP's allocation), within 3 of the previous picture's; where the
config makes per-CTU QP active (the fixed grid, all-intra or IPPP with
one reference) the frame's QP rides a per-CTU map, allocated over the
CTUs by the previous frame's complexity and coded with cu_qp_delta, and
elsewhere a frame encoder per QP codes it.  ROI maps and variance AQ
add to that map.  Scaling lists run on every structure their config
accepts; with them, GOP layer QPs, lp-GOP positions and rate-controlled
pictures of variable trees take a frame encoder per QP (the JAX
package's scaling-list programs bake QP and lambda in), and
``set_base_qp`` raises.  SMP/AMP partitions encode on one-reference
fixed-grid IPPP (pipelined where plain IPPP is), and TMVP in the
multi-reference stream shape, each P picture's temporal candidates
taken from the motion of its first reference (reset at every IDR).
Every other structure raises NotImplementedError: field pictures and
selective encryption.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
import time

import numpy as np

from kvazaar_tpu_torch.bitstream.decoder import _motion_of
from kvazaar_tpu_torch.checkpoint import Checkpointer
from kvazaar_tpu_torch.config import Config, lp_gop_table
from kvazaar_tpu_torch.constants import NAL_CRA_NUT, NAL_IDR_W_RADL, \
    NAL_RASL_R, NAL_TRAIL_R, SLICE_I, SLICE_P
from kvazaar_tpu_torch.encoder.frame_encoder import (IntraFrameEncoder,
                                                    psnr, var_inter)
from kvazaar_tpu_torch.encoder.rate_control import RateController


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


# Hierarchical GOP structures (the JAX package's table): entries in
# coding order, (POC offset from the previous anchor, L0 distance back,
# L1 distance forward or None for the P anchor, QP offset, lambda
# factor).  GOP 8 is the reference's B pyramid; GOP 4 is a 3-layer one.
GOP_TABLES = {
    4: [(4, 4, None, 1, 0.442), (2, 2, 2, 2, 0.3536),
        (1, 1, 1, 3, 0.68), (3, 1, 1, 3, 0.68)],
    8: [(8, 8, None, 1, 0.442), (4, 4, 4, 2, 0.3536),
        (2, 2, 2, 3, 0.3536), (1, 1, 1, 4, 0.68), (3, 1, 1, 4, 0.68),
        (6, 2, 2, 3, 0.3536), (5, 1, 1, 4, 0.68), (7, 1, 1, 4, 0.68)],
}


def _unsupported_structure(cfg: Config) -> list:
    """Stream structures the port does not cover (the frame encoder
    rejects the coding tools it does not cover)."""
    out = []
    if cfg.gop_len > 1 and cfg.gop_len not in GOP_TABLES:
        out.append(f"GOP length {cfg.gop_len} (4 and 8 are ported)")
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
        self._device = device
        self._intra = IntraFrameEncoder(cfg, device)
        # One frame encoder per QP (QP is fixed in an encoder's tables);
        # the low-delay GOP positions' QP offsets pick theirs.
        self._encoders = {cfg.qp: self._intra}
        # Low-delay GOP structures, --ref N and TMVP code the
        # multi-reference stream shape, with a POC-keyed DPB of device
        # planes (relative POC -> (y, cb, cr)) and, under TMVP, of each
        # picture's collocated motion (relative POC -> _motion_of's grids,
        # None for the IDR).
        self._multi = (cfg.lp_gop is not None or cfg.ref_frames > 1
                       or cfg.tmvp)
        self._lp_table = (None if cfg.lp_gop is None
                          else lp_gop_table(*cfg.lp_gop, cfg.ref_frames))
        self._dpb_ld = {}
        self._motion_ld = {}
        # B pyramids: the display-order sources of the GOP being
        # buffered, the POC-keyed DPB (POC -> device planes) and the POC
        # of the GOP's previous anchor.
        self._gop = cfg.gop_len if cfg.gop_len > 1 else 0
        self._pending = []
        self._dpb_map = {}
        self._base_poc = 0
        self._poc = 0
        self._last_idr = 0
        self._wrote_headers = False
        self._irap_count = 0
        self.stats = {}
        # The low-delay encoder that coded the last picture: the owner of
        # the DPB when rate control switches frame encoders.
        self._ld_enc = self._intra
        # Rate control: the controller, the QP of the last picture (each
        # picture's QP stays within 3 of it) and the per-CTU complexity of
        # the last I and P frame (the LCU allocation's weights).
        self._rc = None
        if cfg.bitrate > 0:
            self._rc = RateController(
                cfg.bitrate, cfg.framerate_num / max(cfg.framerate_denom, 1),
                cfg.width, cfg.height)
        self._prev_qp = cfg.qp
        self._rc_wts = {}
        # ROI: "W H" then W*H QP offsets on a grid scaled to the CTUs.
        self._roi_map = None
        if cfg.roi is not None:
            with open(cfg.roi) as f:
                toks = f.read().split()
            rw, rh = int(toks[0]), int(toks[1])
            vals = np.array([int(t) for t in toks[2:2 + rw * rh]], np.int32)
            if vals.size != rw * rh:
                raise ValueError("ROI file: expected %d deltas" % (rw * rh))
            self._roi_map = vals.reshape(rh, rw)

    def _is_intra(self, poc: int) -> bool:
        """--period semantics: 1 all-intra, N > 1 an IDR every N
        frames, 0 only the first frame intra."""
        period = self.cfg.intra_period
        return poc == 0 or period == 1 or (period > 1 and poc % period == 0)

    def _encoder_for_qp(self, qp: int) -> IntraFrameEncoder:
        """The frame encoder of QP qp, made at first use.  The stream
        has one PPS: every encoder's slices code their QP against the
        base config's."""
        if qp not in self._encoders:
            enc = IntraFrameEncoder(dataclasses.replace(self.cfg, qp=qp),
                                    self._device)
            enc.params.qp = self.cfg.qp
            self._encoders[qp] = enc
        return self._encoders[qp]

    def close(self) -> None:
        """Stop the frame encoders' host pools."""
        for enc in self._encoders.values():
            enc.close()

    def headers(self) -> bytes:
        return self._intra.headers()

    def set_base_qp(self, qp: int) -> None:
        """Change the stream's base QP, from the next picture on (the JAX
        package's Encoder.set_base_qp).  The frame encoders of other QPs
        are dropped and made again at first use.  With reset_stream(),
        one encoder runs a BD-rate ladder: each QP's stream equals a
        fresh Encoder's at that QP on the variable-tree operating
        points.  With a scaling list it raises (ROADMAP §3, F5)."""
        if self._intra.scaling is not None:
            self._intra.set_base_qp(qp)     # raises NotImplementedError
        self.cfg = dataclasses.replace(self.cfg, qp=qp).validate()
        for enc in self._encoders.values():
            if enc is not self._intra:
                enc.close()
        self._intra.set_base_qp(qp)
        self._encoders = {qp: self._intra}
        self._ld_enc = self._intra
        self._prev_qp = qp

    def reset_stream(self) -> None:
        """Start a new bitstream on this encoder: the parameter sets are
        written again, the POC restarts at 0 (the next picture is an
        IDR) and the DPBs and the GOP reorder buffer are emptied (call
        flush() first to code a buffered GOP tail)."""
        if self._pending:
            raise RuntimeError("flush() before reset_stream()")
        self._dpb_map = {}
        self._base_poc = 0
        self._poc = 0
        self._last_idr = 0
        self._wrote_headers = False
        self._irap_count = 0
        self._dpb_ld = {}
        self._motion_ld = {}
        self._intra._dpb = None
        self._ld_enc = self._intra

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
        """Encode one frame.  Returns a list of (annexb_bytes, FrameInfo,
        recon) results in coding order: one per frame on low-delay
        streams, where plain IPPP P frames reference the previous frame,
        multi-reference ones the structure's references, and the POC
        restarts at every IDR (8.3.1); in a B pyramid empty while a GOP
        is buffering, then the GOP's pictures (call flush() after the
        last frame)."""
        if self._gop:
            return self._encode_gop_input(y, cb, cr)
        is_intra = self._is_intra(self._poc)
        enc, lam, frame_qp = self._intra, None, self.cfg.qp
        if self._rc is not None:
            lam, frame_qp = self._rc_qp(*self._rc.frame_lambda_qp(is_intra))
            # With per-CTU QP the frame's QP rides the map (the slice QP
            # stays the config's); otherwise a frame encoder per QP.
            if not self.cfg.cu_qp_delta_active:
                enc = self._encoder_for_qp(frame_qp)
        enc._dpb = self._ld_enc._dpb
        qp_ctu = self._qp_ctu_for(frame_qp, y, is_intra)
        if is_intra:
            res = enc.encode_frame(y, cb, cr, qp_ctu=qp_ctu)
            self._last_idr = self._poc
            if self._multi:
                self._dpb_ld = {0: enc._dpb}
                self._motion_ld = {0: None}
        elif self._multi:
            res, enc = self._encode_p_multi(enc, y, cb, cr,
                                            self._poc - self._last_idr)
        else:
            rel = self._poc - self._last_idr
            res = enc.encode_p_frame(y, cb, cr, poc=rel, ref_poc=rel - 1,
                                     qp_ctu=qp_ctu)
        self._note_ctu_weights(res.frame_data, is_intra)
        if lam is not None:
            self._rc.update(len(res.nals) * 8, lam)
            self._ld_enc = enc
        out = self._emit(res, self._poc, (y, cb, cr), is_intra,
                         qp=enc.cfg.qp)
        self._poc += 1
        return [out]

    def _rc_qp(self, lam, qp):
        """(lambda, QP) of the next picture under rate control: the
        controller's QP within 3 of the previous picture's."""
        qp = min(max(qp, self._prev_qp - 3), self._prev_qp + 3)
        self._prev_qp = qp
        return lam, qp

    def _rc_enc(self, is_intra: bool):
        """(frame encoder, lambda) of the next picture under frame-level
        rate control, or (the base encoder, None) at a fixed QP."""
        if self._rc is None:
            return self._intra, None
        lam, qp = self._rc_qp(*self._rc.frame_lambda_qp(is_intra))
        return self._encoder_for_qp(qp), lam

    def _qp_ctu_for(self, base_qp: int, y: np.ndarray, is_intra: bool):
        """The next frame's (Cy, Cx) per-CTU QP map, or None where per-CTU
        QP is off: the LCU allocation around base_qp (weights of the last
        frame of the same slice type), plus the ROI map's offsets, plus
        variance AQ (log2 of each CTU's luma variance against the frame's
        mean, times the strength, within +-3), clipped to 0..51."""
        if not self.cfg.cu_qp_delta_active:
            return None
        p = self._intra.params
        cy, cx = p.height_in_ctus, p.width_in_ctus
        if self._rc is not None and self.cfg.lcu_rc:
            qmap = self._rc.lcu_qp_map(base_qp, (cy, cx),
                                       self._rc_wts.get(is_intra))
        else:
            qmap = np.full((cy, cx), base_qp, np.int32)
        if self._roi_map is not None:
            rh, rw = self._roi_map.shape
            iy = np.minimum(np.arange(cy) * rh // cy, rh - 1)
            ix = np.minimum(np.arange(cx) * rw // cx, rw - 1)
            qmap = qmap + self._roi_map[np.ix_(iy, ix)]
        if self.cfg.aq > 0:
            h, w = y.shape
            yp = np.pad(np.asarray(y, np.float64),
                        ((0, cy * 64 - h), (0, cx * 64 - w)), mode="edge")
            lv = np.log2(yp.reshape(cy, 64, cx, 64).var(axis=(1, 3)) + 1.0)
            dqp = np.rint(self.cfg.aq * (lv - lv.mean()))
            qmap = qmap + np.clip(dqp, -3, 3).astype(np.int32)
        return np.clip(qmap, 0, 51).astype(np.int32)

    def _note_ctu_weights(self, fd, is_intra: bool) -> None:
        """Keeps a coded frame's per-CTU complexity for the LCU
        allocation of the next frame of its slice type."""
        if self._rc is not None and self.cfg.lcu_rc:
            self._rc_wts[is_intra] = RateController.ctu_weights_from_levels(
                fd, self._intra.coded_w, self._intra.coded_h)

    def _lp_pattern(self, rel_poc: int) -> dict:
        """Structure entry of the low-delay frame at relative POC
        rel_poc >= 1: reference POC deltas and QP offset."""
        if self._lp_table is not None:
            return self._lp_table[(rel_poc - 1) % len(self._lp_table)]
        return dict(poc_offset=rel_poc, layer=1, qp_offset=0,
                    ref_neg=list(range(1, self.cfg.ref_frames + 1)))

    def _encode_p_multi(self, enc, y, cb, cr, rel: int):
        """One P frame of the multi-reference stream shape: the active
        references (the structure's deltas present in the DPB, at most
        ref_frames of them), the retained pictures that a frame within
        one structure period still needs, and the DPB pruned to those
        pictures; on enc or, without rate control, on the frame encoder
        of the position's QP.  Under TMVP the first reference's motion is
        the collocated one, and each coded picture's motion is kept while
        its picture is.  Returns (FrameResult, the frame encoder that
        coded it)."""
        pat = self._lp_pattern(rel)
        deltas = []
        for d in pat["ref_neg"]:
            if d <= rel and (rel - d) in self._dpb_ld and d not in deltas:
                deltas.append(d)
        deltas = deltas[:self.cfg.ref_frames] or [1]
        used = [rel - d for d in deltas]
        needed = set()
        horizon = (len(self._lp_table) if self._lp_table
                   else self.cfg.ref_frames)
        for f in range(rel + 1, rel + horizon + 1):
            for d in self._lp_pattern(f)["ref_neg"]:
                needed.add(f - d)
        retained = sorted(rel - p for p in self._dpb_ld
                          if p not in used and p in needed)
        refs = [(rel - d, self._dpb_ld[rel - d]) for d in deltas]
        if pat["qp_offset"] and self._rc is None:
            enc = self._encoder_for_qp(self.cfg.qp + pat["qp_offset"])
        tctx = (self._motion_ld.get(rel - deltas[0]) if self.cfg.tmvp
                else None)
        res, recs = enc.encode_p_frame_multi(y, cb, cr, poc=rel, refs=refs,
                                             retained=retained, tctx=tctx)
        self._dpb_ld[rel] = recs
        self._dpb_ld = {p: v for p, v in self._dpb_ld.items()
                        if p == rel or p in needed}
        if self.cfg.tmvp:
            self._motion_ld[rel] = _motion_of(res.frame_data, enc.params,
                                              rel, deltas)
            self._motion_ld = {p: v for p, v in self._motion_ld.items()
                               if p == rel or p in needed}
        return res, enc

    def flush(self):
        """The buffered tail of a B pyramid (shorter than a GOP), coded
        as a low-delay P chain; low-delay streams buffer nothing."""
        if not self._pending:
            return []
        out = []
        for i, src in enumerate(self._pending):
            poc = self._base_poc + 1 + i
            ife, lam = self._rc_enc(False)
            ife._dpb = self._dpb_map[poc - 1]
            res = ife.encode_p_frame(*src, poc=poc, ref_poc=poc - 1)
            self._rc_update(res, lam)
            self._dpb_map[poc] = ife._dpb
            out.append(self._emit_gop(res, poc, src, ife.cfg.qp))
        self._pending = []
        self._poc = self._base_poc + 1
        return out

    def _encode_gop_input(self, y, cb, cr):
        """B pyramid input: the IDR at POC 0 codes at once; later frames
        fill the reorder buffer, and a full GOP is coded."""
        if self._poc == 0:
            enc, lam = self._rc_enc(True)
            res = enc.encode_frame(y, cb, cr)
            self._rc_update(res, lam)
            self._dpb_map[0] = enc._dpb
            self._poc = 1
            return [self._emit_gop(res, 0, (y, cb, cr), enc.cfg.qp)]
        self._pending.append((y, cb, cr))
        if len(self._pending) < self._gop:
            return []
        # Variable trees with a scaling list take the per-QP path (the JAX
        # package's scaling-list programs bake QP and lambda in).
        out = (self._flush_gop_var()
               if var_inter(self.cfg) and self._intra.scaling is None
               else self._flush_gop_fixed())
        self._base_poc += self._gop
        # Keep only the pictures the next GOP can reference.
        self._dpb_map = {p: v for p, v in self._dpb_map.items()
                         if p >= self._base_poc}
        self._pending = []
        self._poc = self._base_poc + 1
        return out

    def _rc_update(self, res, lam) -> None:
        """The controller learns a coded picture's bits (lam: the
        lambda it chose for it; None at a fixed QP)."""
        if lam is not None:
            self._rc.update(len(res.nals) * 8, lam)

    def _gop_entries(self):
        """(POC, source, L0 distance, L1 distance or None, QP offset,
        lambda factor, RC lambda, RC QP) of the buffered GOP's pictures in
        coding order, the last two None at a fixed QP.  Under rate control
        the GOP's allocation gives each picture its bit target, whose
        lambda and QP (within 3 of the previous picture's) replace the
        layer's QP offset; the QP of a picture is taken when its entry
        is reached, after the controller has learnt the pictures before
        it."""
        base = self._base_poc
        table = GOP_TABLES[self._gop]
        targets = (None if self._rc is None
                   else self._rc.allocate_gop(table))
        for gi, (off, l0, l1, qp_off, fac) in enumerate(table):
            lam = rc_qp = None
            if targets is not None:
                lam, rc_qp = self._rc_qp(
                    *self._rc.pic_lambda_qp(targets[gi]))
            yield (base + off, self._pending[off - 1], l0, l1, qp_off, fac,
                   lam, rc_qp)

    def _flush_gop_var(self):
        """A GOP of variable trees on the base frame encoder, each
        picture at its layer's QP (the base QP plus the layer's offset,
        clipped to 0..51) and lambda.  Under periodic intra the anchor at
        a period boundary codes as a CRA (the POC runs on) and the GOP's
        B pictures, which precede it in display order and reference
        across it, as RASL_R (the JAX package's open-GOP rule; it codes
        the same bytes with two finalize workers).  Under rate control
        each picture takes its allocated QP at its layer's lambda factor,
        and the anchor codes as a P frame (the JAX package's rate
        controlled GOP path has no CRA)."""
        ife = self._intra
        period = self.cfg.intra_period
        cra_poc = self._base_poc + self._gop
        is_cra_gop = (self._rc is None and period > 1
                      and cra_poc % period == 0)
        out = []
        for poc, src, l0, l1, qp_off, fac, lam, rc_qp in \
                self._gop_entries():
            frame_qp = (rc_qp if lam is not None
                        else min(max(self.cfg.qp + qp_off, 0), 51) if qp_off
                        else None)
            if l1 is None and is_cra_gop:
                res = ife.encode_frame(*src, nal_type=NAL_CRA_NUT, poc=poc)
                self._dpb_map[poc] = ife._dpb
                out.append(self._emit_gop(res, poc, src, ife.cfg.qp,
                                          nal_type=NAL_CRA_NUT,
                                          slice_type=SLICE_I))
                continue
            if l1 is None:
                ife._dpb = self._dpb_map[poc - l0]
                res = ife.encode_p_frame(*src, poc=poc, ref_poc=poc - l0,
                                         qp=frame_qp, qp_factor=fac)
                self._dpb_map[poc] = ife._dpb
            else:
                res, self._dpb_map[poc] = ife.encode_b_frame(
                    *src, poc=poc,
                    ref0=(poc - l0, self._dpb_map[poc - l0]),
                    ref1=(poc + l1, self._dpb_map[poc + l1]), qp=frame_qp,
                    qp_factor=fac,
                    nal_type=NAL_RASL_R if is_cra_gop else None)
            self._rc_update(res, lam)
            out.append(self._emit_gop(
                res, poc, src, ife.cfg.qp if frame_qp is None else frame_qp))
        return out

    def _flush_gop_fixed(self):
        """A GOP on the fixed grid, or of variable trees with a scaling
        list: each picture on the frame encoder of its layer's QP, or
        under rate control of its allocated QP, with its layer's lambda
        factor (which only variable trees take), and periodic intra adds
        no CRA, as in the JAX package."""
        out = []
        for poc, src, l0, l1, qp_off, fac, lam, rc_qp in \
                self._gop_entries():
            ife = self._intra
            if lam is not None:
                ife = self._encoder_for_qp(rc_qp)
            elif qp_off:
                ife = self._encoder_for_qp(
                    min(max(self.cfg.qp + qp_off, 0), 51))
            if l1 is None:
                ife._dpb = self._dpb_map[poc - l0]
                res = ife.encode_p_frame(*src, poc=poc, ref_poc=poc - l0,
                                         qp_factor=fac)
                self._dpb_map[poc] = ife._dpb
            else:
                res, self._dpb_map[poc] = ife.encode_b_frame(
                    *src, poc=poc, ref0=(poc - l0, self._dpb_map[poc - l0]),
                    ref1=(poc + l1, self._dpb_map[poc + l1]), qp_factor=fac)
            self._rc_update(res, lam)
            out.append(self._emit_gop(res, poc, src, ife.cfg.qp))
        return out

    def _emit_gop(self, res, poc, src, qp, nal_type=None, slice_type=None):
        """_emit of a B-pyramid picture, as the JAX package's GOP path
        reports it: the AUD's pic_type is I for the IDR and a CRA and 0
        otherwise; FrameInfo gives NAL type 1 and slice type 1 to every P
        and B picture (RASL ones included) and the CRA its own types."""
        is_i = poc == 0 or slice_type == SLICE_I
        return self._emit(
            res, poc, src, is_intra=is_i, qp=qp, aud_type=SLICE_I if is_i
            else 0, nal_type=(NAL_IDR_W_RADL if poc == 0 else nal_type
                              or NAL_TRAIL_R),
            slice_type=SLICE_I if poc == 0 else slice_type or SLICE_P)

    def _emit(self, res, poc, src, is_intra=True, qp=None, aud_type=None,
              nal_type=None, slice_type=None):
        chunks = self._au_prefix(
            (SLICE_I if is_intra else SLICE_P) if aud_type is None
            else aud_type)
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
            poc=poc, qp=self.cfg.qp if qp is None else qp,
            nal_type=(nal_type if nal_type is not None else
                      NAL_IDR_W_RADL if is_intra else NAL_TRAIL_R),
            slice_type=(slice_type if slice_type is not None else
                        SLICE_I if is_intra else SLICE_P),
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
        """All-intra streams on the fixed grid and plain IPPP without SAO
        take the pipelined path (the JAX package's rule); variable trees
        plan each frame on the host, rate control and per-CTU QP maps
        decide each frame's QP from the frames before it, and B
        pyramids, multi-reference streams (TMVP among them) and SAO
        streams with P frames run per frame; SMP/AMP IPPP pipelines as
        plain IPPP does."""
        if self.cfg.cu_qp_delta_active or self._rc is not None:
            return False
        if self.cfg.intra_period == 1:
            return not self._intra.var
        if var_inter(self.cfg):
            return False
        return not self._gop and not self._multi and not self.cfg.sao

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
        and host serialization of different frames overlap.  Variable
        trees, B pyramids, multi-reference streams and SAO streams with
        P frames loop ``encode`` (and ``flush``) instead."""
        if not self.can_pipeline():
            for f in frames:
                yield from self.encode(*f)
            yield from self.flush()
            return
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
                            need_recon=want_pixels, multi=False)[0]]
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
                ife._dpb = handle[5]
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
