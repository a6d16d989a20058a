"""Slice-data syntax: coding quadtree, intra CU, transform tree, residual
coding — both the CABAC serializer and its exact inverse parser.

Reference behavior being matched: src/encode_coding_tree.c (serializer
only; the reference has no decoder).  We additionally implement the
*decoder* direction so every bitstream we emit can be verified end-to-end
without an external HEVC decoder (SURVEY.md §4 gate).  Spec clauses:
7.3.8.4 (coding quadtree), 7.3.8.5 (coding unit), 7.3.8.8 (transform
tree), 7.3.8.11 (residual coding), 9.3.4.2 (ctxInc derivations).

Data model: the device hands the host dense frame-shaped tensors (depth
per 8x8 cell, intra mode per 4x4 cell, quantized levels per pixel
position); the serializer walks the quadtree they imply.  This is the
compact device→host layout planned in SURVEY.md §7.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from kvazaar_tpu_torch.bitstream.cabac import CabacDecoder, CabacEncoder
from kvazaar_tpu_torch.bitstream.contexts import Contexts
from kvazaar_tpu_torch.bitstream.headers import StreamParams
from kvazaar_tpu_torch.constants import INTRA_DC, INTRA_PLANAR
from kvazaar_tpu_torch.ops.scan import (SCAN_DIAG, SCAN_VER, coeff_scan,
                                  intra_scan_idx, scan_order)

# H.265 9.3.4.2.5: sig_coeff_flag ctx map for 4x4 TBs, indexed (yC<<2)+xC.
CTX_IDX_MAP_4X4 = (0, 1, 4, 5, 2, 3, 4, 5, 6, 6, 8, 8, 7, 7, 8, 8)


@dataclasses.dataclass
class FrameData:
    """Dense per-frame syntax tensors exchanged between device and host.

    Inter fields live on the 8x8 CU-marker grid (valid at each CU's
    top-left cell; mv8/inter8 are filled across the whole CU for
    neighbor derivations)."""
    depth8: np.ndarray       # (H/8, W/8) uint8 — CU depth per 8x8 cell
    mode4: np.ndarray        # (H/4, W/4) uint8 — luma intra mode per 4x4
    coeff_y: np.ndarray      # (H, W) int32 — quantized levels, pixel layout
    coeff_cb: np.ndarray     # (H/2, W/2) int32 (empty for 4:0:0)
    coeff_cr: np.ndarray
    inter8: np.ndarray = None   # (H/8, W/8) uint8 — 1 = inter CU
    skip8: np.ndarray = None    # (H/8, W/8) uint8 — 1 = cu_skip_flag
    merge8: np.ndarray = None   # (H/8, W/8) int8 — merge_idx or -1
    mvp8: np.ndarray = None     # (H/8, W/8) uint8 — mvp_l0_flag
    ref8: np.ndarray = None     # (H/8, W/8) uint8 — L0 ref_idx (filled
                                # across the CU for neighbor derivation)
    mvd8: np.ndarray = None     # (H/8, W/8, 2) int32
    mv8: np.ndarray = None      # (H/8, W/8, 2) int32 — final qpel MVs
    # B slices: prediction direction + list-1 motion (list-0 reuses the
    # fields above).  dir8: 0 = L0, 1 = L1, 2 = BI.
    dir8: np.ndarray = None     # (H/8, W/8) uint8
    mvp8_l1: np.ndarray = None  # (H/8, W/8) uint8
    mvd8_l1: np.ndarray = None  # (H/8, W/8, 2) int32
    mv8_l1: np.ndarray = None   # (H/8, W/8, 2) int32
    # SAO per CTU (resolved post-merge values; sao_merge records what
    # the serializer signals): type/eo index 0 = luma, 1 = chroma
    # (cb+cr share type and eo_class per 7.3.8.3); offsets/band_pos per
    # component 0=Y 1=Cb 2=Cr; offsets stored signed as applied.
    sao_merge: np.ndarray = None   # (Cy, Cx) uint8: 0/1=left/2=up
    sao_type: np.ndarray = None    # (Cy, Cx, 2) uint8: 0 off/1 band/2 edge
    sao_eo: np.ndarray = None      # (Cy, Cx, 2) uint8
    sao_bp: np.ndarray = None      # (Cy, Cx, 3) uint8
    sao_off: np.ndarray = None     # (Cy, Cx, 3, 4) int8
    # 1 = min-size intra CU partitioned PART_NxN: four 4x4 PUs with
    # per-PU modes in mode4, forced 4x4 TU split (IntraSplitFlag,
    # 7.3.8.5/7.3.8.8; reference intra CU src/encode_coding_tree.c:683).
    nxn8: np.ndarray = None        # (H/8, W/8) uint8
    # split_transform_flag per intra 2Nx2N CU (7.3.8.8, coded when the
    # SPS max_transform_hierarchy_depth_intra > 0; reference
    # kvz_encode_transform_coeff src/encode_coding_tree.c:461-472).
    # CU-filled: 1 = the CU codes one explicit TU split level.
    trsplit8: np.ndarray = None    # (H/8, W/8) uint8
    # transform_skip_flag per 4x4 TB (7.3.8.11, coded only when the PPS
    # enables it and log2TrafoSize == 2; reference src/transform.c:151).
    tskip4: np.ndarray = None      # (H/4, W/4) uint8 — luma
    tskip_cb: np.ndarray = None    # (H/8, W/8) uint8 — chroma TBs
    tskip_cr: np.ndarray = None
    # Per-CTU luma QP (LCU rate control / ROI, reference
    # kvz_set_lcu_lambda_and_qp src/rate_control.c:278).  Encoder fills
    # the intended QP; the serializer/parser normalize it to the
    # EFFECTIVE QP (prediction chain value where no cu_qp_delta was
    # coded because the CTU has no coded coefficients, 8.6.1).
    qp_ctu: np.ndarray = None      # (Cy, Cx) int32
    # Inter partition mode per CU (at the CU marker cell): 0 = 2Nx2N,
    # 1 = 2NxN, 2 = Nx2N (SMP; reference kvz_search_cu_smp,
    # src/search_inter.c:1627).  Motion fields hold per-PU values at
    # each PU's marker cell and are region-filled for derivation.
    part8: np.ndarray = None       # (H/8, W/8) uint8
    # Explicit chroma prediction mode per 8x8 cell (--rd 3 chroma-mode
    # RDO; reference kvz_search_cu_intra_chroma src/search_intra.c:736).
    # 255 = DM (chroma shares the luma mode) — the default everywhere.
    cmode4: np.ndarray = None      # (H/8, W/8) uint8

    @staticmethod
    def empty(width: int, height: int, chroma: bool = True) -> "FrameData":
        cw, ch = (width // 2, height // 2) if chroma else (0, 0)
        g8 = (height // 8, width // 8)
        cg = (-(-height // 64), -(-width // 64))
        return FrameData(
            depth8=np.zeros(g8, dtype=np.uint8),
            mode4=np.zeros((height // 4, width // 4), dtype=np.uint8),
            coeff_y=np.zeros((height, width), dtype=np.int32),
            coeff_cb=np.zeros((ch, cw), dtype=np.int32),
            coeff_cr=np.zeros((ch, cw), dtype=np.int32),
            inter8=np.zeros(g8, dtype=np.uint8),
            skip8=np.zeros(g8, dtype=np.uint8),
            merge8=np.full(g8, -1, dtype=np.int8),
            mvp8=np.zeros(g8, dtype=np.uint8),
            ref8=np.zeros(g8, dtype=np.uint8),
            mvd8=np.zeros(g8 + (2,), dtype=np.int32),
            mv8=np.zeros(g8 + (2,), dtype=np.int32),
            dir8=np.zeros(g8, dtype=np.uint8),
            mvp8_l1=np.zeros(g8, dtype=np.uint8),
            mvd8_l1=np.zeros(g8 + (2,), dtype=np.int32),
            mv8_l1=np.zeros(g8 + (2,), dtype=np.int32),
            sao_merge=np.zeros(cg, dtype=np.uint8),
            sao_type=np.zeros(cg + (2,), dtype=np.uint8),
            sao_eo=np.zeros(cg + (2,), dtype=np.uint8),
            sao_bp=np.zeros(cg + (3,), dtype=np.uint8),
            sao_off=np.zeros(cg + (3, 4), dtype=np.int8),
            nxn8=np.zeros(g8, dtype=np.uint8),
            trsplit8=np.zeros(g8, dtype=np.uint8),
            tskip4=np.zeros((height // 4, width // 4), dtype=np.uint8),
            tskip_cb=np.zeros(g8, dtype=np.uint8),
            tskip_cr=np.zeros(g8, dtype=np.uint8),
            part8=np.zeros(g8, dtype=np.uint8),
            cmode4=np.full(g8, 255, dtype=np.uint8),
        )


@functools.lru_cache(maxsize=None)
def _inv_coeff_scan(log2_size: int, scan_idx: int) -> np.ndarray:
    """(size, size) map from (y, x) to linear scan index."""
    scan = coeff_scan(log2_size, scan_idx)
    size = 1 << log2_size
    inv = np.zeros((size, size), dtype=np.int32)
    for i, (x, y) in enumerate(scan):
        inv[y, x] = i
    return inv


def _last_prefix_ctx_params(log2_size: int, is_chroma: bool):
    """(ctx_offset, ctx_shift) for last_sig_coeff_{x,y}_prefix
    (9.3.4.2.3)."""
    if is_chroma:
        return 15, log2_size - 2
    return 3 * (log2_size - 2) + ((log2_size - 1) >> 2), (log2_size + 1) >> 2


def _sig_ctx(xc: int, yc: int, log2_size: int, scan_idx: int,
             is_chroma: bool, csbf_right: int, csbf_below: int) -> int:
    """sig_coeff_flag ctxInc (9.3.4.2.5), before the +27 chroma offset is
    folded into the context array split (we keep separate luma/chroma
    halves in one 42-entry array)."""
    if log2_size == 2:
        sig = CTX_IDX_MAP_4X4[(yc << 2) + xc]
    elif xc + yc == 0:
        sig = 0
    else:
        xb, yb = xc & 3, yc & 3
        prev = csbf_right + 2 * csbf_below
        if prev == 0:
            sig = 2 if xb + yb == 0 else (1 if xb + yb < 3 else 0)
        elif prev == 1:
            sig = 2 if yb == 0 else (1 if yb == 1 else 0)
        elif prev == 2:
            sig = 2 if xb == 0 else (1 if xb == 1 else 0)
        else:
            sig = 2
        if not is_chroma and (xc >> 2, yc >> 2) != (0, 0):
            sig += 3
        if log2_size == 3:
            sig += (9 if scan_idx == SCAN_DIAG else 15) if not is_chroma \
                else 9
        else:
            sig += 12 if is_chroma else 21
    return sig + (27 if is_chroma else 0)


def intra_mpm(cand_left: int, cand_above: int) -> list[int]:
    """The 3 most probable intra modes (H.265 8.4.2)."""
    if cand_left == cand_above:
        if cand_left < 2:
            return [INTRA_PLANAR, INTRA_DC, 26]
        m = cand_left
        return [m, 2 + ((m + 29) % 32), 2 + ((m - 2 + 1) % 32)]
    mpm = [cand_left, cand_above]
    if INTRA_PLANAR not in mpm:
        mpm.append(INTRA_PLANAR)
    elif INTRA_DC not in mpm:
        mpm.append(INTRA_DC)
    else:
        mpm.append(26)
    return mpm


class _SliceSyntaxBase:
    """Geometry and context-derivation shared by serializer and parser."""

    def __init__(self, params: StreamParams, data: FrameData,
                 contexts: Contexts):
        self.p = params
        self.d = data
        self.ctx = contexts
        self.chroma = params.chroma_format_idc != 0
        # cu_qp_delta state (QG = CTU, diff_cu_qp_delta_depth = 0, so
        # qPY_A/B always fall back to qPY_PREV — 8.6.1): one predictor
        # chain per slice, reset at WPP row / tile starts.
        self.dqp = bool(getattr(params, "cu_qp_delta", False)
                        and data.qp_ctu is not None)
        self._slice_qp = contexts.qp
        self._qp_pred = contexts.qp
        self._qg_coded = False
        self._qg_qp = contexts.qp
        self._qg_cur = (0, 0)
        # Selective encryption (--crypto): AES-CTR keystream XORed into
        # sign bypass bins, consumed in parse order (one cipher per
        # slice on both sides — reference extras/crypto.cpp hooks).
        self.cipher = None
        if getattr(params, "crypto_key", None):
            raise NotImplementedError("selective encryption is not "
                                      "ported")
        self._tcol = self._trow = None
        if params.tiles_enabled:
            from kvazaar_tpu_torch.encoder.geometry import \
                uniform_tile_bounds
            tx, ty = params.tiles
            cbx = uniform_tile_bounds(params.width_in_ctus, tx)
            cby = uniform_tile_bounds(params.height_in_ctus, ty)
            self._tcol = np.searchsorted(
                cbx[1:], np.arange(params.width_in_ctus), "right")
            self._trow = np.searchsorted(
                cby[1:], np.arange(params.height_in_ctus), "right")
            self._tile_ctus = [
                [(cx, cy) for cy in range(cby[tr], cby[tr + 1])
                 for cx in range(cbx[tc], cbx[tc + 1])]
                for tr in range(ty) for tc in range(tx)]

    def set_crypto_iv(self, iv: int) -> None:
        """Per-picture CTR nonce (both sides count pictures in stream
        order) — never reuse a keystream across pictures."""
        if self.cipher is not None:
            raise NotImplementedError("selective encryption is not "
                                      "ported")

    @staticmethod
    def _pu_rects(x0, y0, size, part):
        """PU rectangles (x, y, w, h) in pixels, decode order — the
        pixel view of inter_cands.pu_cell_rects (the ONE partition
        geometry table; every PU offset is an 8-multiple in the
        supported operating points)."""
        from kvazaar_tpu_torch.encoder.inter_cands import pu_cell_rects
        return [(rx * 8, ry * 8, rw * 8, rh * 8)
                for (ry, rx, rh, rw) in pu_cell_rects(
                    y0 >> 3, x0 >> 3, size >> 3, part)]

    def _tile_rows(self):
        """Tiles in raster order; each as a list of CTU rows, each row
        a list of (cx, cy) (the tiles x WPP substream structure)."""
        out = []
        for ctus in self._tile_ctus:
            rows: dict = {}
            for (cx, cy) in ctus:
                rows.setdefault(cy, []).append((cx, cy))
            out.append([rows[k] for k in sorted(rows)])
        return out

    def _same_tile(self, xa: int, ya: int, xb: int, yb: int) -> bool:
        """Prediction/context availability never crosses a tile
        boundary (6.4.1)."""
        if self._tcol is None:
            return True
        s = self.p.log2_ctu
        return (self._tcol[xa >> s] == self._tcol[xb >> s]
                and self._trow[ya >> s] == self._trow[yb >> s])

    # -- neighbor queries against the (partially filled) frame data --

    def _neighbor_depth(self, x: int, y: int) -> int:
        if x < 0 or y < 0:
            return -1
        return int(self.d.depth8[y >> 3, x >> 3])

    def split_ctx(self, x0: int, y0: int, depth: int) -> int:
        inc = 0
        if x0 > 0 and self._same_tile(x0 - 1, y0, x0, y0) \
                and self._neighbor_depth(x0 - 1, y0) > depth:
            inc += 1
        if y0 > 0 and self._same_tile(x0, y0 - 1, x0, y0) \
                and self._neighbor_depth(x0, y0 - 1) > depth:
            inc += 1
        return inc

    def _is_inter_cu(self, x0: int, y0: int) -> bool:
        return bool(self.d.inter8 is not None
                    and self.d.inter8[y0 >> 3, x0 >> 3])

    def _is_nxn(self, x0: int, y0: int, log2_size: int) -> bool:
        """PART_NxN intra CU (only defined at min CU size 8)."""
        return (log2_size == 3 and self.d.nxn8 is not None
                and bool(self.d.nxn8[y0 >> 3, x0 >> 3]))

    def _codes_tr_split(self, x0, y0, log2_size, tr_depth) -> bool:
        """split_transform_flag presence (7.3.8.8): intra 2Nx2N CUs at
        trafoDepth 0 when the SPS allows one explicit level.
        MaxTrafoDepth(intra) = max_tr_depth_intra (+1 for NxN, whose
        depth-0 split is inferred, not coded)."""
        return (self.p.max_tr_depth_intra > 0 and tr_depth == 0
                and log2_size <= self.p.log2_max_tu
                and log2_size > 2
                and not self._is_inter_cu(x0, y0)
                and not self._is_nxn(x0, y0, log2_size))

    def skip_ctx(self, x0: int, y0: int) -> int:
        inc = 0
        if x0 > 0 and self._same_tile(x0 - 1, y0, x0, y0) \
                and self.d.skip8[y0 >> 3, (x0 - 1) >> 3]:
            inc += 1
        if y0 > 0 and self._same_tile(x0, y0 - 1, x0, y0) \
                and self.d.skip8[(y0 - 1) >> 3, x0 >> 3]:
            inc += 1
        return inc

    def mpm_for(self, x0: int, y0: int) -> list[int]:
        # Left neighbor PU; above must be inside the same CTU row
        # (above outside the CTU → DC); unavailable or NON-INTRA
        # neighbors default to DC (8.4.2).
        cand_l = INTRA_DC
        cand_a = INTRA_DC
        if x0 > 0 and self._same_tile(x0 - 1, y0, x0, y0) \
                and not self._is_inter_cu(x0 - 1, y0):
            cand_l = int(self.d.mode4[y0 >> 2, (x0 - 1) >> 2])
        if y0 > 0 and (y0 % self.p.ctu_size) != 0 \
                and not self._is_inter_cu(x0, y0 - 1):
            cand_a = int(self.d.mode4[(y0 - 1) >> 2, x0 >> 2])
        return intra_mpm(cand_l, cand_a)

    def _plane(self, c_idx: int) -> np.ndarray:
        return (self.d.coeff_y, self.d.coeff_cb, self.d.coeff_cr)[c_idx]

    def _crypt(self, bit: int) -> int:
        """XOR a sign bypass bin with the selective-encryption
        keystream (no-op without a key)."""
        if self.cipher is None:
            return bit
        return bit ^ self.cipher.next_bit()

    # -- cu_qp_delta quant-group bookkeeping (shared by both dirs) --

    def _qg_reset_pred(self) -> None:
        """Start of slice / WPP CTU row / tile: qPY_PREV = SliceQpY
        (8.6.1)."""
        self._qp_pred = self._slice_qp

    def _qg_end(self) -> None:
        """CTU finished: commit the effective QP and advance the
        predictor chain."""
        if not self.dqp:
            return
        cyi, cxi = self._qg_cur
        eff = self._qg_qp if self._qg_coded else self._qp_pred
        self.d.qp_ctu[cyi, cxi] = eff
        self._qp_pred = eff

    def _chroma_mode_of(self, x0, y0) -> int:
        """Effective chroma prediction mode of the CU covering luma
        position (x0, y0): cmode4 when explicit (--rd 3), else DM =
        the luma mode of the first PU (8.4.3)."""
        cm = 255 if self.d.cmode4 is None else \
            int(self.d.cmode4[y0 >> 3, x0 >> 3])
        return int(self.d.mode4[y0 >> 2, x0 >> 2]) if cm == 255 else cm


class SliceDataEncoder(_SliceSyntaxBase):
    """Serialize a fully populated FrameData into CABAC slice data."""

    def __init__(self, params, data, contexts, cabac: CabacEncoder,
                 nref_l0: int = 1):
        super().__init__(params, data, contexts)
        self.c = cabac
        self.nref_l0 = nref_l0

    def _qg_start(self, cxi: int, cyi: int) -> None:
        if not self.dqp:
            return
        self._qg_cur = (cyi, cxi)
        self._qg_coded = False
        self._qg_qp = int(self.d.qp_ctu[cyi, cxi])

    def _maybe_code_dqp(self, any_cbf) -> None:
        """cu_qp_delta_abs/sign at the first TU with coded coefficients
        in this quant group (7.3.8.10; binarization 9.3.3.1.3: TR cMax 5
        prefix + EG0 suffix; ctx 0 for bin 0, ctx 1 for bins 1..4)."""
        if not self.dqp or self._qg_coded or not any_cbf:
            return
        delta = self._qg_qp - self._qp_pred
        a = abs(delta)
        prefix = min(a, 5)
        self.c.encode_bin(self.ctx("cu_qp_delta", 0), 1 if prefix else 0)
        if prefix:
            for _ in range(1, prefix):
                self.c.encode_bin(self.ctx("cu_qp_delta", 1), 1)
            if prefix < 5:
                self.c.encode_bin(self.ctx("cu_qp_delta", 1), 0)
            else:
                self._encode_egk(a - 5, 0)
        if a:
            self.c.encode_bypass(1 if delta < 0 else 0)
        self._qg_coded = True

    def encode_slice_data(self) -> None:
        ctus_x = self.p.width_in_ctus
        ctus_y = self.p.height_in_ctus
        n = ctus_x * ctus_y
        self._qg_reset_pred()
        for i in range(n):
            x0 = (i % ctus_x) << self.p.log2_ctu
            y0 = (i // ctus_x) << self.p.log2_ctu
            self.encode_sao(i % ctus_x, i // ctus_x)
            self._qg_start(i % ctus_x, i // ctus_x)
            self.coding_quadtree(x0, y0, self.p.log2_ctu, 0)
            self._qg_end()
            self.c.encode_terminate(1 if i == n - 1 else 0)

    def encode_sao(self, cxi: int, cyi: int) -> None:
        """sao() per CTU (7.3.8.3), interleaved before the coding
        quadtree (reference: encode_sao, src/encoderstate.c:513)."""
        if not self.p.sao_enabled:
            return
        d = self.d
        s = self.p.log2_ctu
        merge = int(d.sao_merge[cyi, cxi])
        if cxi > 0 and self._same_tile((cxi - 1) << s, cyi << s,
                                       cxi << s, cyi << s):
            self.c.encode_bin(self.ctx("sao_merge", 0),
                              1 if merge == 1 else 0)
        if merge != 1 and cyi > 0 \
                and self._same_tile(cxi << s, (cyi - 1) << s,
                                    cxi << s, cyi << s):
            self.c.encode_bin(self.ctx("sao_merge", 0),
                              1 if merge == 2 else 0)
        if merge:
            return
        ncomp = 3 if self.p.chroma_format_idc else 1
        for ci in range(ncomp):
            t = int(d.sao_type[cyi, cxi, 0 if ci == 0 else 1])
            if ci in (0, 1):
                self.c.encode_bin(self.ctx("sao_type", 0),
                                  1 if t else 0)
                if t:
                    self.c.encode_bypass(1 if t == 2 else 0)
            if not t:
                continue
            offs = d.sao_off[cyi, cxi, ci]
            for i in range(4):
                a = abs(int(offs[i]))
                for _ in range(a):
                    self.c.encode_bypass(1)
                if a < 7:
                    self.c.encode_bypass(0)
            if t == 1:
                for i in range(4):
                    if offs[i]:
                        self.c.encode_bypass(1 if offs[i] < 0 else 0)
                self.c.encode_bypass_bins(int(d.sao_bp[cyi, cxi, ci]),
                                          5)
            elif ci != 2:
                self.c.encode_bypass_bins(
                    int(d.sao_eo[cyi, cxi, 0 if ci == 0 else 1]), 2)

    def encode_slice_data_wpp(self) -> list[int]:
        """WPP: one CABAC substream per CTU row, contexts inherited from
        the row above after its 2nd CTU (9.3.2.3; reference:
        src/encoderstate.c:685-721).  Returns the byte size of each
        substream (for slice-header entry points)."""
        from kvazaar_tpu_torch.bitstream.cabac import CabacEncoder
        w = self.c.writer
        assert w.byte_aligned
        ctus_x = self.p.width_in_ctus
        ctus_y = self.p.height_in_ctus
        sizes = []
        saved = None
        for row in range(ctus_y):
            start = len(w.get_bytes())
            if row > 0:
                if saved is not None:
                    self.ctx.copy_from(saved)
                else:
                    self.ctx = Contexts(self.ctx.slice_type, self.ctx.qp)
                self.c = CabacEncoder(w)
            self._qg_reset_pred()
            for cx in range(ctus_x):
                x0 = cx << self.p.log2_ctu
                y0 = row << self.p.log2_ctu
                self.encode_sao(cx, row)
                self._qg_start(cx, row)
                self.coding_quadtree(x0, y0, self.p.log2_ctu, 0)
                self._qg_end()
                last_ctu = (row == ctus_y - 1) and (cx == ctus_x - 1)
                self.c.encode_terminate(1 if last_ctu else 0)
                if cx == 1:
                    # Spec stores sync state only after the 2nd CTU; a
                    # 1-CTU-wide picture re-inits every row.
                    saved = self.ctx.clone()
                if cx == ctus_x - 1 and not last_ctu:
                    self.c.encode_terminate(1)  # end_of_subset_one_bit
            w.align_zero()
            sizes.append(len(w.get_bytes()) - start)
        return sizes

    def encode_slice_data_tiles(self) -> list[int]:
        """Tiles: one CABAC substream per tile, contexts re-initialized
        at each tile start (9.3.1), CTU raster order within the tile.
        Returns per-tile byte sizes (slice-header entry points).
        Reference: the per-tile encoder states of
        src/encoderstate.c:860-965."""
        from kvazaar_tpu_torch.bitstream.cabac import CabacEncoder
        w = self.c.writer
        assert w.byte_aligned
        n_tiles = len(self._tile_ctus)
        sizes = []
        for ti, ctus in enumerate(self._tile_ctus):
            start = len(w.get_bytes())
            if ti > 0:
                self.ctx = Contexts(self.ctx.slice_type, self.ctx.qp)
                self.c = CabacEncoder(w)
            self._qg_reset_pred()
            for k, (cx, cy) in enumerate(ctus):
                self.encode_sao(cx, cy)
                self._qg_start(cx, cy)
                self.coding_quadtree(cx << self.p.log2_ctu,
                                     cy << self.p.log2_ctu,
                                     self.p.log2_ctu, 0)
                self._qg_end()
                last = ti == n_tiles - 1 and k == len(ctus) - 1
                self.c.encode_terminate(1 if last else 0)
                if k == len(ctus) - 1 and not last:
                    self.c.encode_terminate(1)  # end_of_subset_one_bit
            w.align_zero()
            sizes.append(len(w.get_bytes()) - start)
        return sizes

    def encode_row_slices(self) -> list[bytes]:
        """--slices=wpp: each CTU row is its own DEPENDENT slice
        segment (src/kvazaar.h:198-201; dependent-segment emission
        src/encoder_state-bitstream.c:964-980).  Returns per-row slice
        DATA byte strings; WPP context inheritance still applies across
        segments (9.3.1), and each segment's last CTU carries
        end_of_slice_segment_flag = 1 (7.3.8.1)."""
        from kvazaar_tpu_torch.bitstream.bits import BitWriter
        from kvazaar_tpu_torch.bitstream.cabac import CabacEncoder
        ctus_x = self.p.width_in_ctus
        ctus_y = self.p.height_in_ctus
        out = []
        saved = None
        for row in range(ctus_y):
            w = BitWriter()
            if row > 0:
                if saved is not None:
                    self.ctx.copy_from(saved)
                else:
                    self.ctx = Contexts(self.ctx.slice_type,
                                        self.ctx.qp)
            self.c = CabacEncoder(w)
            self._qg_reset_pred()
            for cx in range(ctus_x):
                self.encode_sao(cx, row)
                self._qg_start(cx, row)
                self.coding_quadtree(cx << self.p.log2_ctu,
                                     row << self.p.log2_ctu,
                                     self.p.log2_ctu, 0)
                self._qg_end()
                self.c.encode_terminate(1 if cx == ctus_x - 1 else 0)
                if cx == 1:
                    saved = self.ctx.clone()
            w.align_zero()
            out.append(w.get_bytes())
        return out

    def encode_tile_slices(self) -> list[bytes]:
        """--slices=tiles: each tile is its own INDEPENDENT slice.
        Returns per-tile slice DATA byte strings (contexts re-init per
        slice; prediction was already cut at tile boundaries)."""
        from kvazaar_tpu_torch.bitstream.bits import BitWriter
        from kvazaar_tpu_torch.bitstream.cabac import CabacEncoder
        out = []
        for ti, ctus in enumerate(self._tile_ctus):
            w = BitWriter()
            if ti > 0:
                self.ctx = Contexts(self.ctx.slice_type, self.ctx.qp)
            self.c = CabacEncoder(w)
            self._qg_reset_pred()
            for k, (cx, cy) in enumerate(ctus):
                self.encode_sao(cx, cy)
                self._qg_start(cx, cy)
                self.coding_quadtree(cx << self.p.log2_ctu,
                                     cy << self.p.log2_ctu,
                                     self.p.log2_ctu, 0)
                self._qg_end()
                self.c.encode_terminate(1 if k == len(ctus) - 1 else 0)
            w.align_zero()
            out.append(w.get_bytes())
        return out

    def encode_slice_data_tiles_wpp(self) -> list[int]:
        """Tiles x WPP combined: each CTU row OF EACH TILE is its own
        substream (7.4.3.3 entry points with both tiles_enabled and
        entropy_coding_sync); contexts fully re-init at tile starts and
        sync from the 2nd CTU of the row above WITHIN the tile
        (9.3.1).  The reference supports the combination through its
        encoder-state tree (flagged experimental, README.md:383-388)."""
        from kvazaar_tpu_torch.bitstream.cabac import CabacEncoder
        w = self.c.writer
        assert w.byte_aligned
        tiles = self._tile_rows()
        s = self.p.log2_ctu
        sizes = []
        first = True
        for ti, rows in enumerate(tiles):
            saved = None
            for ri, row in enumerate(rows):
                start = len(w.get_bytes())
                if not first:
                    if ri == 0 or saved is None:
                        self.ctx = Contexts(self.ctx.slice_type,
                                            self.ctx.qp)
                    else:
                        self.ctx.copy_from(saved)
                    self.c = CabacEncoder(w)
                first = False
                for k, (cx, cy) in enumerate(row):
                    self.encode_sao(cx, cy)
                    self.coding_quadtree(cx << s, cy << s, s, 0)
                    last = (ti == len(tiles) - 1
                            and ri == len(rows) - 1
                            and k == len(row) - 1)
                    self.c.encode_terminate(1 if last else 0)
                    if k == 1:
                        saved = self.ctx.clone()
                    if k == len(row) - 1 and not last:
                        self.c.encode_terminate(1)
                w.align_zero()
                sizes.append(len(w.get_bytes()) - start)
        return sizes

    def coding_quadtree(self, x0, y0, log2_size, depth) -> None:
        size = 1 << log2_size
        inside = x0 + size <= self.p.width and y0 + size <= self.p.height
        split = int(self.d.depth8[y0 >> 3, x0 >> 3]) > depth
        if inside and log2_size > self.p.log2_min_cu:
            self.c.encode_bin(
                self.ctx("split_flag", self.split_ctx(x0, y0, depth)),
                1 if split else 0)
        elif log2_size > self.p.log2_min_cu:
            split = True   # boundary: inferred split, no flag
        if split:
            half = size >> 1
            for dy in (0, half):
                for dx in (0, half):
                    x1, y1 = x0 + dx, y0 + dy
                    if x1 < self.p.width and y1 < self.p.height:
                        self.coding_quadtree(x1, y1, log2_size - 1,
                                             depth + 1)
        else:
            self.coding_unit(x0, y0, log2_size)

    def coding_unit(self, x0, y0, log2_size) -> None:
        from kvazaar_tpu_torch.constants import SLICE_I
        c8y, c8x = y0 >> 3, x0 >> 3
        if self.p.transquant_bypass:
            # Lossless operating point: every CU bypasses (7.3.8.5
            # order: this flag precedes cu_skip_flag).
            self.c.encode_bin(self.ctx("transquant_bypass", 0), 1)
        if self.ctx.slice_type != SLICE_I:
            skip = int(self.d.skip8[c8y, c8x])
            self.c.encode_bin(self.ctx("skip", self.skip_ctx(x0, y0)),
                              skip)
            if skip:
                self._encode_merge_idx(int(self.d.merge8[c8y, c8x]))
                return
            inter = int(self.d.inter8[c8y, c8x])
            self.c.encode_bin(self.ctx("pred_mode", 0),
                              0 if inter else 1)
            if inter:
                self._encode_inter_cu(x0, y0, log2_size)
                return
        self._encode_intra_cu(x0, y0, log2_size)

    def _encode_merge_idx(self, idx: int) -> None:
        """TR cMax=4: first bin context-coded, rest bypass unary."""
        assert 0 <= idx <= 4
        self.c.encode_bin(self.ctx("merge_idx", 0), 1 if idx else 0)
        if idx:
            for k in range(1, idx):
                self.c.encode_bypass(1)
            if idx < 4:
                self.c.encode_bypass(0)

    def _encode_ref_idx(self, idx: int, nref: int) -> None:
        """ref_idx_lX: TR cMax=nref-1; bin0 ctx0, bin1 ctx1, rest
        bypass (9.3.3, Table 9-42)."""
        self.c.encode_bin(self.ctx("ref_pic", 0), 1 if idx else 0)
        if idx:
            for i in range(nref - 2):
                sym = 0 if i == idx - 1 else 1
                if i == 0:
                    self.c.encode_bin(self.ctx("ref_pic", 1), sym)
                else:
                    self.c.encode_bypass(sym)
                if sym == 0:
                    break

    def _encode_mvd(self, mvd) -> None:
        """mvd_coding (7.3.8.9): greater0/greater1 flags then EG1
        remainders + signs, x before y."""
        ax, ay = abs(int(mvd[0])), abs(int(mvd[1]))
        self.c.encode_bin(self.ctx("mvd", 0), 1 if ax else 0)
        self.c.encode_bin(self.ctx("mvd", 0), 1 if ay else 0)
        if ax:
            self.c.encode_bin(self.ctx("mvd", 1), 1 if ax > 1 else 0)
        if ay:
            self.c.encode_bin(self.ctx("mvd", 1), 1 if ay > 1 else 0)
        for a, v in ((ax, int(mvd[0])), (ay, int(mvd[1]))):
            if a:
                if a > 1:
                    self._encode_egk(a - 2, 1)
                self.c.encode_bypass(self._crypt(1 if v < 0 else 0))

    def _encode_egk(self, value: int, k: int) -> None:
        """Exp-Golomb order-k, bypass bins (9.3.3.3)."""
        while value >= (1 << k):
            self.c.encode_bypass(1)
            value -= 1 << k
            k += 1
        self.c.encode_bypass(0)
        if k:
            self.c.encode_bypass_bins(value, k)

    def _encode_pu_motion(self, c8x: int, c8y: int) -> None:
        """One PU's motion syntax at its marker cell (P slices)."""
        merge_idx = int(self.d.merge8[c8y, c8x])
        if merge_idx >= 0:
            self.c.encode_bin(self.ctx("merge_flag", 0), 1)
            self._encode_merge_idx(merge_idx)
            return
        self.c.encode_bin(self.ctx("merge_flag", 0), 0)
        if self.nref_l0 > 1:
            self._encode_ref_idx(int(self.d.ref8[c8y, c8x]),
                                 self.nref_l0)
        self._encode_mvd(self.d.mvd8[c8y, c8x])
        self.c.encode_bin(self.ctx("mvp_idx", 0),
                          int(self.d.mvp8[c8y, c8x]))

    def _encode_inter_cu(self, x0, y0, log2_size) -> None:
        c8y, c8x = y0 >> 3, x0 >> 3
        part = int(self.d.part8[c8y, c8x]) \
            if self.d.part8 is not None else 0
        # part_mode, Table 9-34 (inter, NxN disallowed): without AMP
        # 2Nx2N "1", 2NxN "01", Nx2N "00"; with AMP the third bin
        # (bypass above min CU size) selects symmetric vs asymmetric
        # and a fourth bypass bin picks nU/nD (nL/nR).
        self.c.encode_bin(self.ctx("part_size", 0),
                          1 if part == 0 else 0)
        if part:
            horiz = part in (1, 4, 5)
            self.c.encode_bin(self.ctx("part_size", 1),
                              1 if horiz else 0)
            if self.p.amp:
                sym = part in (1, 2)
                self.c.encode_bypass(1 if sym else 0)
                if not sym:
                    self.c.encode_bypass(1 if part in (5, 7) else 0)
            for pu_idx, (px, py, _pw, _ph) in enumerate(
                    self._pu_rects(x0, y0, 1 << log2_size, part)):
                self._encode_pu_motion(px >> 3, py >> 3)
            # rqt_root_cbf is always coded for non-2Nx2N inter CUs
            # (7.3.8.5 codes it unless PartMode==2Nx2N && merge_flag).
            root = self._root_cbf(x0, y0, log2_size)
            self.c.encode_bin(self.ctx("qt_root_cbf", 0), root)
            if root:
                self.transform_tree(x0, y0, log2_size, 0)
            return
        merge_idx = int(self.d.merge8[c8y, c8x])
        if merge_idx >= 0:
            self.c.encode_bin(self.ctx("merge_flag", 0), 1)
            self._encode_merge_idx(merge_idx)
        else:
            from kvazaar_tpu_torch.constants import SLICE_B
            self.c.encode_bin(self.ctx("merge_flag", 0), 0)
            if self.ctx.slice_type == SLICE_B:
                # inter_pred_idc (9.3.3.7, 2Nx2N): bin0 ctx[ctDepth]
                # bi-vs-uni, bin1 ctx[4] L1-vs-L0.
                d = int(self.d.dir8[c8y, c8x])
                depth = int(self.d.depth8[c8y, c8x])
                self.c.encode_bin(self.ctx("inter_dir", depth),
                                  1 if d == 2 else 0)
                if d != 2:
                    self.c.encode_bin(self.ctx("inter_dir", 4),
                                      1 if d == 1 else 0)
                if d != 1:     # L0 motion (one active ref: no ref_idx)
                    self._encode_mvd(self.d.mvd8[c8y, c8x])
                    self.c.encode_bin(self.ctx("mvp_idx", 0),
                                      int(self.d.mvp8[c8y, c8x]))
                if d != 0:     # L1 motion
                    self._encode_mvd(self.d.mvd8_l1[c8y, c8x])
                    self.c.encode_bin(self.ctx("mvp_idx", 0),
                                      int(self.d.mvp8_l1[c8y, c8x]))
            else:
                # P: L0 only — no inter_pred_idc; ref_idx_l0 when more
                # than one active reference (TR, ctx bins 0/1 then
                # bypass; reference: src/encode_coding_tree.c:590).
                if self.nref_l0 > 1:
                    self._encode_ref_idx(int(self.d.ref8[c8y, c8x]),
                                         self.nref_l0)
                self._encode_mvd(self.d.mvd8[c8y, c8x])
                self.c.encode_bin(self.ctx("mvp_idx", 0),
                                  int(self.d.mvp8[c8y, c8x]))
        root = self._root_cbf(x0, y0, log2_size)
        if merge_idx < 0:
            self.c.encode_bin(self.ctx("qt_root_cbf", 0), root)
        else:
            assert root, "merge non-skip CU must carry coefficients"
        if root:
            self.transform_tree(x0, y0, log2_size, 0)

    def _root_cbf(self, x0, y0, log2_size) -> int:
        if self._tu_cbf(0, x0, y0, log2_size):
            return 1
        if self.chroma and (self._tu_cbf(1, x0, y0, log2_size)
                            or self._tu_cbf(2, x0, y0, log2_size)):
            return 1
        return 0

    def _encode_intra_cu(self, x0, y0, log2_size) -> None:
        nxn = self._is_nxn(x0, y0, log2_size)
        if log2_size == self.p.log2_min_cu:
            # part_mode (9.3.3.5, intra): 1 = PART_2Nx2N, 0 = PART_NxN.
            self.c.encode_bin(self.ctx("part_size", 0), 0 if nxn else 1)
        pus = ([(x0, y0)] if not nxn else
               [(x0, y0), (x0 + 4, y0), (x0, y0 + 4), (x0 + 4, y0 + 4)])
        # 7.3.8.5: all prev_intra_luma_pred_flags first, then per-PU
        # mpm_idx / rem_intra_luma_pred_mode.
        in_mpm = []
        for px, py in pus:
            mode = int(self.d.mode4[py >> 2, px >> 2])
            hit = mode in self.mpm_for(px, py)
            in_mpm.append(hit)
            self.c.encode_bin(self.ctx("intra_mode", 0), 1 if hit else 0)
        for (px, py), hit in zip(pus, in_mpm):
            mode = int(self.d.mode4[py >> 2, px >> 2])
            mpm = self.mpm_for(px, py)
            if hit:
                idx = mpm.index(mode)
                self.c.encode_bypass(1 if idx else 0)
                if idx:
                    self.c.encode_bypass(idx - 1)
            else:
                rem = mode
                for m in sorted(mpm, reverse=True):
                    if rem > m:
                        rem -= 1
                self.c.encode_bypass_bins(rem, 5)
        if self.chroma:
            # intra_chroma_pred_mode (9.3.3.8): DM = one context bin 0;
            # explicit = context bin 1 + 2-bit FL bypass index into the
            # Table 8-3 list (luma-dup entry replaced by angular-34).
            luma_mode = int(self.d.mode4[y0 >> 2, x0 >> 2])
            cm = self._chroma_mode_of(x0, y0)
            if cm == luma_mode:
                self.c.encode_bin(self.ctx("chroma_pred_mode", 0), 0)
            else:
                lst = [34 if m == luma_mode else m
                       for m in (0, 26, 10, 1)]
                idx = lst.index(cm)
                self.c.encode_bin(self.ctx("chroma_pred_mode", 0), 1)
                self.c.encode_bypass((idx >> 1) & 1)
                self.c.encode_bypass(idx & 1)
        self.transform_tree(x0, y0, log2_size, 0)

    def transform_tree(self, x0, y0, log2_size, tr_depth) -> None:
        # Forced splits (never coded, 7.3.8.8 inference): size exceeds
        # max TU, or IntraSplitFlag (NxN) forces 4x4 TUs.  With SPS
        # max_transform_hierarchy_depth_intra > 0, intra 2Nx2N CUs code
        # an explicit split_transform_flag at trafoDepth 0 (reference
        # src/encode_coding_tree.c:461-472; ctx 5 - log2TrafoSize).
        split = (log2_size > self.p.log2_max_tu
                 or (tr_depth == 0 and self._is_nxn(x0, y0, log2_size)
                     and not self._is_inter_cu(x0, y0)))
        if self._codes_tr_split(x0, y0, log2_size, tr_depth):
            split = bool(self.d.trsplit8 is not None
                         and self.d.trsplit8[y0 >> 3, x0 >> 3])
            self.c.encode_bin(
                self.ctx("trans_subdiv", 5 - log2_size), int(split))
        cbf_cb = cbf_cr = 0
        if self.chroma and log2_size > 2:
            cb = self._tu_cbf(1, x0, y0, log2_size)
            cr = self._tu_cbf(2, x0, y0, log2_size)
            self.c.encode_bin(self.ctx("cbf_chroma", tr_depth), cb)
            self.c.encode_bin(self.ctx("cbf_chroma", tr_depth), cr)
            cbf_cb, cbf_cr = cb, cr
        if split:
            half = 1 << (log2_size - 1)
            for dy in (0, half):
                for dx in (0, half):
                    self._transform_leaf_or_split(
                        x0 + dx, y0 + dy, log2_size - 1, tr_depth + 1,
                        cbf_cb, cbf_cr)
            if self.chroma and log2_size == 3:
                # 4x4 luma children: the 8x8 area's single 4x4 chroma
                # TBs ride after the last child (7.3.8.10,
                # log2TrafoSize == 2 rule).
                if cbf_cb:
                    self.residual_coding(x0 >> 1, y0 >> 1, 2, 1)
                if cbf_cr:
                    self.residual_coding(x0 >> 1, y0 >> 1, 2, 2)
        else:
            cbf_luma = self._tu_cbf(0, x0, y0, log2_size)
            if (not self._is_inter_cu(x0, y0) or tr_depth != 0
                    or cbf_cb or cbf_cr):
                self.c.encode_bin(
                    self.ctx("cbf_luma", 1 if tr_depth == 0 else 0),
                    cbf_luma)
            else:
                # Inter depth-0 TU, no chroma cbf: luma cbf inferred 1
                # (7.3.8.10); encoder guarantees via root-cbf/skip.
                assert cbf_luma == 1, "inter TU with no coefficients"
            self._transform_unit(x0, y0, log2_size, cbf_luma,
                                 cbf_cb, cbf_cr)

    def _transform_leaf_or_split(self, x0, y0, log2_size, tr_depth,
                                 parent_cb, parent_cr) -> None:
        # Children of a (forced) split: chroma cbf re-coded per child only
        # if the parent cbf was set; we keep tr-depth <= 1 (64x64 CU).
        cbf_cb = cbf_cr = 0
        if self.chroma and log2_size > 2:
            if parent_cb:
                cbf_cb = self._tu_cbf(1, x0, y0, log2_size)
                self.c.encode_bin(self.ctx("cbf_chroma", tr_depth), cbf_cb)
            if parent_cr:
                cbf_cr = self._tu_cbf(2, x0, y0, log2_size)
                self.c.encode_bin(self.ctx("cbf_chroma", tr_depth), cbf_cr)
        cbf_luma = self._tu_cbf(0, x0, y0, log2_size)
        self.c.encode_bin(
            self.ctx("cbf_luma", 1 if tr_depth == 0 else 0), cbf_luma)
        # Spec 7.3.8.10: for the last 4x4 child of an 8x8 split, the
        # transform_unit condition includes the PARENT chroma cbfs
        # (whose residuals ride after this child).
        extra = 0
        if log2_size == 2 and (x0 & 4) and (y0 & 4):
            extra = parent_cb or parent_cr
        self._transform_unit(x0, y0, log2_size, cbf_luma, cbf_cb,
                             cbf_cr, dqp_extra=extra)

    def _tu_cbf(self, c_idx, x0, y0, log2_size) -> int:
        shift = 1 if c_idx else 0
        n = 1 << (log2_size - shift)
        x, y = x0 >> shift, y0 >> shift
        block = self._plane(c_idx)[y:y + n, x:x + n]
        return 1 if np.any(block) else 0

    def _transform_unit(self, x0, y0, log2_size, cbf_luma, cbf_cb,
                        cbf_cr, dqp_extra=0) -> None:
        self._maybe_code_dqp(cbf_luma or cbf_cb or cbf_cr or dqp_extra)
        if cbf_luma:
            self.residual_coding(x0, y0, log2_size, 0)
        if self.chroma and log2_size > 2:
            if cbf_cb:
                self.residual_coding(x0 >> 1, y0 >> 1, log2_size - 1, 1)
            if cbf_cr:
                self.residual_coding(x0 >> 1, y0 >> 1, log2_size - 1, 2)

    def residual_coding(self, x0, y0, log2_size, c_idx) -> None:
        """7.3.8.11 — serialize one TB's quantized levels."""
        p, c, ctx = self.p, self.c, self.ctx
        size = 1 << log2_size
        chroma = c_idx > 0
        plane = self._plane(c_idx)
        block = plane[y0:y0 + size, x0:x0 + size]

        if (p.transform_skip and log2_size == 2
                and not p.transquant_bypass):
            tmap = (self.d.tskip4, self.d.tskip_cb,
                    self.d.tskip_cr)[c_idx]
            flag = int(tmap[y0 >> 2, x0 >> 2]) if tmap is not None \
                else 0
            c.encode_bin(ctx("transform_skip", 1 if chroma else 0),
                         flag)

        lx0 = x0 * 2 if chroma else x0
        ly0 = y0 * 2 if chroma else y0
        if self._is_inter_cu(lx0, ly0):
            scan_idx = SCAN_DIAG       # mode-dependent scan is intra-only
        else:
            mode = (self._chroma_mode_of(lx0, ly0) if chroma
                    else int(self.d.mode4[ly0 >> 2, lx0 >> 2]))
            scan_idx = intra_scan_idx(mode, log2_size, chroma)
        scan = coeff_scan(log2_size, scan_idx)
        levels = block[scan[:, 1], scan[:, 0]]       # scan-ordered
        nz = np.nonzero(levels)[0]
        assert len(nz), "residual_coding called with all-zero block"
        last = int(nz[-1])
        lx, ly = int(scan[last, 0]), int(scan[last, 1])
        if scan_idx == SCAN_VER:
            lx, ly = ly, lx
        self._encode_last_xy(lx, ly, log2_size, chroma)

        n_sb = size >> 2
        sb_scan = scan_order(n_sb, scan_idx)
        last_sb, last_pos = last >> 4, last & 15
        csbf = np.zeros((n_sb, n_sb), dtype=np.int32)
        for i in range(last_sb + 1):
            sx, sy = int(sb_scan[i, 0]), int(sb_scan[i, 1])
            if np.any(levels[i * 16:(i + 1) * 16]):
                csbf[sy, sx] = 1
        csbf[int(sb_scan[0, 1]), int(sb_scan[0, 0])] = 1
        csbf[int(sb_scan[last_sb, 1]), int(sb_scan[last_sb, 0])] = 1

        gt1_state = 1   # "c1": persists across subblocks (9.3.4.2.6)
        for i in range(last_sb, -1, -1):
            sx, sy = int(sb_scan[i, 0]), int(sb_scan[i, 1])
            sb_levels = levels[i * 16:(i + 1) * 16]
            infer_dc = False
            if 0 < i < last_sb:
                right = csbf[sy, sx + 1] if sx + 1 < n_sb else 0
                below = csbf[sy + 1, sx] if sy + 1 < n_sb else 0
                ctx_i = (1 if (right or below) else 0) + (2 if chroma else 0)
                c.encode_bin(ctx("sig_cg", ctx_i), int(csbf[sy, sx]))
                infer_dc = True
            if not csbf[sy, sx]:
                continue

            # sig_coeff_flag
            sig = (sb_levels != 0).astype(np.int32)
            start_n = last_pos - 1 if i == last_sb else 15
            right_csbf = int(csbf[sy, sx + 1]) if sx + 1 < n_sb else 0
            below_csbf = int(csbf[sy + 1, sx]) if sy + 1 < n_sb else 0
            for n in range(start_n, -1, -1):
                if n > 0 or not infer_dc:
                    xc = int(scan[i * 16 + n, 0])
                    yc = int(scan[i * 16 + n, 1])
                    s_ctx = _sig_ctx(xc, yc, log2_size, scan_idx, chroma,
                                     right_csbf, below_csbf)
                    c.encode_bin(ctx("sig", s_ctx), int(sig[n]))
                    if sig[n]:
                        infer_dc = False

            sig_pos = [n for n in range(15, -1, -1) if sig[n]]
            if i == last_sb:
                assert sig_pos[0] == last_pos
            if not sig_pos:
                # Forced-on DC subblock with no levels: gt1 state and
                # context-set selection skip empty subsets entirely.
                continue

            # greater1 / greater2 flags
            ctx_set = 0 if (i == 0 or chroma) else 2
            if gt1_state == 0:
                ctx_set += 1
            gt1_state = 1
            abs_levels = np.abs(sb_levels)
            first_gt1 = -1
            for n in sig_pos[:8]:
                flag = 1 if abs_levels[n] > 1 else 0
                inc = ctx_set * 4 + min(3, gt1_state) + \
                    (16 if chroma else 0)
                c.encode_bin(ctx("gt1", inc), flag)
                if flag:
                    gt1_state = 0
                    if first_gt1 < 0:
                        first_gt1 = n
                elif gt1_state > 0:
                    gt1_state = min(3, gt1_state + 1)
            if first_gt1 >= 0:
                flag = 1 if abs_levels[first_gt1] > 2 else 0
                c.encode_bin(ctx("gt2", ctx_set + (4 if chroma else 0)),
                             flag)

            # signs; with sign hiding the first (DC-ward) coeff's sign
            # is omitted when the group spans > 3 scan positions —
            # the device guarantees the parity invariant.
            hide = (p.sign_hiding and not p.transquant_bypass
                    and sig_pos[0] - sig_pos[-1] > 3)
            for n in sig_pos:
                if hide and n == sig_pos[-1]:
                    continue
                c.encode_bypass(self._crypt(
                    1 if sb_levels[n] < 0 else 0))

            # remaining levels: present iff the coded flags saturated
            rice = 0
            for k, n in enumerate(sig_pos):
                a = int(abs_levels[n])
                if k < 8:
                    base = 3 if n == first_gt1 else 2
                else:
                    base = 1
                if a >= base:
                    self._encode_remaining(a - base, rice)
                    if a > (3 << rice):
                        rice = min(rice + 1, 4)

    def _encode_last_xy(self, lx, ly, log2_size, chroma) -> None:
        off, shift = _last_prefix_ctx_params(log2_size, chroma)
        cmax = (log2_size << 1) - 1
        for val, name in ((lx, "last_x"), (ly, "last_y")):
            prefix = self._last_prefix(val)
            for b in range(min(prefix, cmax)):
                self.c.encode_bin(self.ctx(name, off + (b >> shift)), 1)
            if prefix < cmax:
                self.c.encode_bin(self.ctx(name, off + (prefix >> shift)),
                                  0)
        for val in (lx, ly):
            prefix = self._last_prefix(val)
            if prefix > 3:
                nbits = (prefix >> 1) - 1
                suffix = val - ((2 + (prefix & 1)) << nbits)
                self.c.encode_bypass_bins(suffix, nbits)

    @staticmethod
    def _last_prefix(val: int) -> int:
        """Prefix index for a last-coefficient coordinate (9.3.3.2
        inverse: val -> groupIdx)."""
        if val < 4:
            return val
        return ((val >> (val.bit_length() - 2)) & 1) + \
            ((val.bit_length() - 2) << 1) + 2

    def _encode_remaining(self, value: int, rice: int) -> None:
        """coeff_abs_level_remaining Golomb-Rice/EGk (9.3.3.9)."""
        c = self.c
        if (value >> rice) < 3:
            q = value >> rice
            for _ in range(q):
                c.encode_bypass(1)
            c.encode_bypass(0)
            if rice:
                c.encode_bypass_bins(value & ((1 << rice) - 1), rice)
        else:
            v = value - (3 << rice)
            length = rice
            while v >= (1 << length):
                v -= 1 << length
                length += 1
            for _ in range(3 + length - rice):
                c.encode_bypass(1)
            c.encode_bypass(0)
            if length:
                c.encode_bypass_bins(v, length)


class SliceDataDecoder(_SliceSyntaxBase):
    """Parse CABAC slice data back into a FrameData — the conformance
    oracle's front half (exact inverse of SliceDataEncoder)."""

    def __init__(self, params, data, contexts, cabac: CabacDecoder,
                 nref_l0: int = 1):
        super().__init__(params, data, contexts)
        self.c = cabac
        self.nref_l0 = nref_l0

    def decode_slice_data(self) -> None:
        ctus_x = self.p.width_in_ctus
        ctus_y = self.p.height_in_ctus
        n = ctus_x * ctus_y
        self._qg_reset_pred()
        for i in range(n):
            x0 = (i % ctus_x) << self.p.log2_ctu
            y0 = (i // ctus_x) << self.p.log2_ctu
            self.parse_sao(i % ctus_x, i // ctus_x)
            self._qg_start(i % ctus_x, i // ctus_x)
            self.coding_quadtree(x0, y0, self.p.log2_ctu, 0)
            self._qg_end()
            end = self.c.decode_terminate()
            if end != (1 if i == n - 1 else 0):
                raise ValueError(f"end_of_slice at CTU {i}/{n} mismatched")

    def parse_sao(self, cxi: int, cyi: int) -> None:
        """Inverse of encode_sao; stores RESOLVED (post-merge) params
        plus the signalled merge flag."""
        if not self.p.sao_enabled:
            return
        d = self.d
        s = self.p.log2_ctu
        merge = 0
        if cxi > 0 and self._same_tile((cxi - 1) << s, cyi << s,
                                       cxi << s, cyi << s) \
                and self.c.decode_bin(self.ctx("sao_merge", 0)):
            merge = 1
        if merge == 0 and cyi > 0 \
                and self._same_tile(cxi << s, (cyi - 1) << s,
                                    cxi << s, cyi << s) \
                and self.c.decode_bin(self.ctx("sao_merge", 0)):
            merge = 2
        d.sao_merge[cyi, cxi] = merge
        if merge:
            sy, sx = (cyi, cxi - 1) if merge == 1 else (cyi - 1, cxi)
            d.sao_type[cyi, cxi] = d.sao_type[sy, sx]
            d.sao_eo[cyi, cxi] = d.sao_eo[sy, sx]
            d.sao_bp[cyi, cxi] = d.sao_bp[sy, sx]
            d.sao_off[cyi, cxi] = d.sao_off[sy, sx]
            return
        ncomp = 3 if self.p.chroma_format_idc else 1
        for ci in range(ncomp):
            if ci in (0, 1):
                t = 0
                if self.c.decode_bin(self.ctx("sao_type", 0)):
                    t = 2 if self.c.decode_bypass() else 1
                d.sao_type[cyi, cxi, 0 if ci == 0 else 1] = t
            else:
                t = int(d.sao_type[cyi, cxi, 1])
            if not t:
                continue
            absv = []
            for i in range(4):
                a = 0
                while a < 7 and self.c.decode_bypass():
                    a += 1
                absv.append(a)
            if t == 1:
                offs = []
                for i in range(4):
                    s = self.c.decode_bypass() if absv[i] else 0
                    offs.append(-absv[i] if s else absv[i])
                d.sao_off[cyi, cxi, ci] = offs
                d.sao_bp[cyi, cxi, ci] = self.c.decode_bypass_bins(5)
            else:
                d.sao_off[cyi, cxi, ci] = (absv[0], absv[1], -absv[2],
                                           -absv[3])
                if ci != 2:
                    d.sao_eo[cyi, cxi, 0 if ci == 0 else 1] = \
                        self.c.decode_bypass_bins(2)

    def decode_slice_data_wpp(self, rbsp: bytes, data_offset: int,
                              sizes: list[int]) -> None:
        """Parse WPP substreams: one per CTU row at the given byte
        offsets (slice-header entry points + final substream)."""
        from kvazaar_tpu_torch.bitstream.bits import BitReader
        from kvazaar_tpu_torch.bitstream.cabac import CabacDecoder
        ctus_x = self.p.width_in_ctus
        ctus_y = self.p.height_in_ctus
        assert len(sizes) == ctus_y
        off = data_offset
        saved = None
        for row in range(ctus_y):
            if row > 0:
                if saved is not None:
                    self.ctx.copy_from(saved)
                else:
                    self.ctx = Contexts(self.ctx.slice_type, self.ctx.qp)
                self.c = CabacDecoder(BitReader(rbsp[off:]))
            self._qg_reset_pred()
            for cx in range(ctus_x):
                x0 = cx << self.p.log2_ctu
                y0 = row << self.p.log2_ctu
                self.parse_sao(cx, row)
                self._qg_start(cx, row)
                self.coding_quadtree(x0, y0, self.p.log2_ctu, 0)
                self._qg_end()
                last_ctu = (row == ctus_y - 1) and (cx == ctus_x - 1)
                end = self.c.decode_terminate()
                if end != (1 if last_ctu else 0):
                    raise ValueError("end_of_slice mismatch (wpp)")
                if cx == 1:
                    saved = self.ctx.clone()
                if cx == ctus_x - 1 and not last_ctu:
                    if self.c.decode_terminate() != 1:
                        raise ValueError("missing end_of_subset bit")
            off += sizes[row]

    def decode_row_slices(self, segments: list[bytes]) -> None:
        """Inverse of encode_row_slices: per-row dependent slice
        segment payloads."""
        from kvazaar_tpu_torch.bitstream.bits import BitReader
        from kvazaar_tpu_torch.bitstream.cabac import CabacDecoder
        ctus_x = self.p.width_in_ctus
        ctus_y = self.p.height_in_ctus
        assert len(segments) == ctus_y
        saved = None
        for row, seg in enumerate(segments):
            if row > 0:
                if saved is not None:
                    self.ctx.copy_from(saved)
                else:
                    self.ctx = Contexts(self.ctx.slice_type,
                                        self.ctx.qp)
            self.c = CabacDecoder(BitReader(seg))
            self._qg_reset_pred()
            for cx in range(ctus_x):
                self.parse_sao(cx, row)
                self._qg_start(cx, row)
                self.coding_quadtree(cx << self.p.log2_ctu,
                                     row << self.p.log2_ctu,
                                     self.p.log2_ctu, 0)
                self._qg_end()
                if self.c.decode_terminate() != \
                        (1 if cx == ctus_x - 1 else 0):
                    raise ValueError(
                        "end_of_slice_segment mismatch (row slices)")
                if cx == 1:
                    saved = self.ctx.clone()

    def decode_tile_slices(self, segments: list[bytes]) -> None:
        """Inverse of encode_tile_slices."""
        from kvazaar_tpu_torch.bitstream.bits import BitReader
        from kvazaar_tpu_torch.bitstream.cabac import CabacDecoder
        assert len(segments) == len(self._tile_ctus)
        for ti, (ctus, seg) in enumerate(zip(self._tile_ctus,
                                             segments)):
            if ti > 0:
                self.ctx = Contexts(self.ctx.slice_type, self.ctx.qp)
            self.c = CabacDecoder(BitReader(seg))
            self._qg_reset_pred()
            for k, (cx, cy) in enumerate(ctus):
                self.parse_sao(cx, cy)
                self._qg_start(cx, cy)
                self.coding_quadtree(cx << self.p.log2_ctu,
                                     cy << self.p.log2_ctu,
                                     self.p.log2_ctu, 0)
                self._qg_end()
                if self.c.decode_terminate() != \
                        (1 if k == len(ctus) - 1 else 0):
                    raise ValueError(
                        "end_of_slice_segment mismatch (tile slices)")

    def decode_slice_data_tiles_wpp(self, rbsp: bytes,
                                    data_offset: int,
                                    sizes: list[int]) -> None:
        """Inverse of encode_slice_data_tiles_wpp: one substream per
        CTU row per tile."""
        from kvazaar_tpu_torch.bitstream.bits import BitReader
        from kvazaar_tpu_torch.bitstream.cabac import CabacDecoder
        tiles = self._tile_rows()
        s = self.p.log2_ctu
        n_rows = sum(len(rows) for rows in tiles)
        assert len(sizes) == n_rows
        off = data_offset
        si = 0
        first = True
        for ti, rows in enumerate(tiles):
            saved = None
            for ri, row in enumerate(rows):
                if not first:
                    if ri == 0 or saved is None:
                        self.ctx = Contexts(self.ctx.slice_type,
                                            self.ctx.qp)
                    else:
                        self.ctx.copy_from(saved)
                    self.c = CabacDecoder(BitReader(rbsp[off:]))
                first = False
                for k, (cx, cy) in enumerate(row):
                    self.parse_sao(cx, cy)
                    self.coding_quadtree(cx << s, cy << s, s, 0)
                    last = (ti == len(tiles) - 1
                            and ri == len(rows) - 1
                            and k == len(row) - 1)
                    if self.c.decode_terminate() != (1 if last else 0):
                        raise ValueError(
                            "end_of_slice mismatch (tiles+wpp)")
                    if k == 1:
                        saved = self.ctx.clone()
                    if k == len(row) - 1 and not last:
                        if self.c.decode_terminate() != 1:
                            raise ValueError(
                                "missing end_of_subset bit")
                off += sizes[si]
                si += 1

    def decode_slice_data_tiles(self, rbsp: bytes, data_offset: int,
                                sizes: list[int]) -> None:
        """Parse tile substreams at the given byte offsets; contexts
        re-initialize at each tile start."""
        from kvazaar_tpu_torch.bitstream.bits import BitReader
        from kvazaar_tpu_torch.bitstream.cabac import CabacDecoder
        n_tiles = len(self._tile_ctus)
        assert len(sizes) == n_tiles
        off = data_offset
        for ti, ctus in enumerate(self._tile_ctus):
            if ti > 0:
                self.ctx = Contexts(self.ctx.slice_type, self.ctx.qp)
                self.c = CabacDecoder(BitReader(rbsp[off:]))
            self._qg_reset_pred()
            for k, (cx, cy) in enumerate(ctus):
                self.parse_sao(cx, cy)
                self._qg_start(cx, cy)
                self.coding_quadtree(cx << self.p.log2_ctu,
                                     cy << self.p.log2_ctu,
                                     self.p.log2_ctu, 0)
                self._qg_end()
                last = ti == n_tiles - 1 and k == len(ctus) - 1
                if self.c.decode_terminate() != (1 if last else 0):
                    raise ValueError("end_of_slice mismatch (tiles)")
                if k == len(ctus) - 1 and not last:
                    if self.c.decode_terminate() != 1:
                        raise ValueError("missing end_of_subset bit")
            off += sizes[ti]

    def coding_quadtree(self, x0, y0, log2_size, depth) -> None:
        size = 1 << log2_size
        inside = x0 + size <= self.p.width and y0 + size <= self.p.height
        if inside and log2_size > self.p.log2_min_cu:
            split = self.c.decode_bin(
                self.ctx("split_flag", self.split_ctx(x0, y0, depth)))
        elif log2_size > self.p.log2_min_cu:
            split = 1
        else:
            split = 0
        if split:
            half = size >> 1
            for dy in (0, half):
                for dx in (0, half):
                    x1, y1 = x0 + dx, y0 + dy
                    if x1 < self.p.width and y1 < self.p.height:
                        self.coding_quadtree(x1, y1, log2_size - 1,
                                             depth + 1)
        else:
            cells = max(size >> 3, 1)
            self.d.depth8[y0 >> 3:(y0 >> 3) + cells,
                          x0 >> 3:(x0 >> 3) + cells] = depth
            self.coding_unit(x0, y0, log2_size)

    def coding_unit(self, x0, y0, log2_size) -> None:
        from kvazaar_tpu_torch.constants import SLICE_I
        c8y, c8x = y0 >> 3, x0 >> 3
        cells = 1 << (log2_size - 3)
        if self.p.transquant_bypass:
            if self.c.decode_bin(self.ctx("transquant_bypass", 0)) != 1:
                raise NotImplementedError(
                    "mixed bypass/coded CUs not in v1 subset")
        if self.ctx.slice_type != SLICE_I:
            skip = self.c.decode_bin(
                self.ctx("skip", self.skip_ctx(x0, y0)))
            if skip:
                self.d.skip8[c8y:c8y + cells, c8x:c8x + cells] = 1
                self.d.inter8[c8y:c8y + cells, c8x:c8x + cells] = 1
                self.d.merge8[c8y, c8x] = self._decode_merge_idx()
                return
            intra = self.c.decode_bin(self.ctx("pred_mode", 0))
            if not intra:
                self.d.inter8[c8y:c8y + cells, c8x:c8x + cells] = 1
                self._decode_inter_cu(x0, y0, log2_size)
                return
        self._decode_intra_cu(x0, y0, log2_size)

    def _decode_merge_idx(self) -> int:
        if not self.c.decode_bin(self.ctx("merge_idx", 0)):
            return 0
        idx = 1
        while idx < 4 and self.c.decode_bypass():
            idx += 1
        return idx

    def _decode_ref_idx(self, nref: int) -> int:
        if not self.c.decode_bin(self.ctx("ref_pic", 0)):
            return 0
        idx = 1
        for i in range(nref - 2):
            sym = (self.c.decode_bin(self.ctx("ref_pic", 1)) if i == 0
                   else self.c.decode_bypass())
            if sym == 0:
                break
            idx += 1
        return idx

    def _decode_mvd(self):
        g0x = self.c.decode_bin(self.ctx("mvd", 0))
        g0y = self.c.decode_bin(self.ctx("mvd", 0))
        g1x = self.c.decode_bin(self.ctx("mvd", 1)) if g0x else 0
        g1y = self.c.decode_bin(self.ctx("mvd", 1)) if g0y else 0
        out = []
        for g0, g1 in ((g0x, g1x), (g0y, g1y)):
            if not g0:
                out.append(0)
                continue
            a = 2 + self._decode_egk(1) if g1 else 1
            out.append(-a if self._crypt(self.c.decode_bypass())
                       else a)
        return out

    def _decode_egk(self, k: int) -> int:
        value = 0
        while self.c.decode_bypass():
            value += 1 << k
            k += 1
            if k > 30:
                raise ValueError("runaway EGk")
        if k:
            value += self.c.decode_bypass_bins(k)
        return value

    def _decode_pu_motion(self, c8x: int, c8y: int) -> None:
        if self.c.decode_bin(self.ctx("merge_flag", 0)):
            self.d.merge8[c8y, c8x] = self._decode_merge_idx()
            return
        self.d.merge8[c8y, c8x] = -1
        if self.nref_l0 > 1:
            self.d.ref8[c8y, c8x] = self._decode_ref_idx(self.nref_l0)
        self.d.mvd8[c8y, c8x] = self._decode_mvd()
        self.d.mvp8[c8y, c8x] = self.c.decode_bin(
            self.ctx("mvp_idx", 0))

    def _decode_inter_cu(self, x0, y0, log2_size) -> None:
        c8y, c8x = y0 >> 3, x0 >> 3
        if not self.c.decode_bin(self.ctx("part_size", 0)):
            horiz = self.c.decode_bin(self.ctx("part_size", 1))
            if self.p.amp:
                if self.c.decode_bypass():          # symmetric
                    part = 1 if horiz else 2
                else:
                    second = self.c.decode_bypass()
                    part = (5 if second else 4) if horiz \
                        else (7 if second else 6)
            else:
                part = 1 if horiz else 2
            if self.d.part8 is not None:
                self.d.part8[c8y, c8x] = part
            for px, py, _w, _h in self._pu_rects(
                    x0, y0, 1 << log2_size, part):
                self._decode_pu_motion(px >> 3, py >> 3)
            root = self.c.decode_bin(self.ctx("qt_root_cbf", 0))
            if root:
                self.transform_tree(x0, y0, log2_size, 0)
            return
        if self.c.decode_bin(self.ctx("merge_flag", 0)):
            self.d.merge8[c8y, c8x] = self._decode_merge_idx()
            root = 1                      # inferred for 2Nx2N merge
        else:
            from kvazaar_tpu_torch.constants import SLICE_B
            if self.ctx.slice_type == SLICE_B:
                depth = int(self.d.depth8[c8y, c8x])
                if self.c.decode_bin(self.ctx("inter_dir", depth)):
                    d = 2
                else:
                    d = 1 if self.c.decode_bin(
                        self.ctx("inter_dir", 4)) else 0
                self.d.dir8[c8y, c8x] = d
                if d != 1:
                    self.d.mvd8[c8y, c8x] = self._decode_mvd()
                    self.d.mvp8[c8y, c8x] = self.c.decode_bin(
                        self.ctx("mvp_idx", 0))
                if d != 0:
                    self.d.mvd8_l1[c8y, c8x] = self._decode_mvd()
                    self.d.mvp8_l1[c8y, c8x] = self.c.decode_bin(
                        self.ctx("mvp_idx", 0))
            else:
                if self.nref_l0 > 1:
                    cells_cu = 1 << (log2_size - 3)
                    self.d.ref8[c8y:c8y + cells_cu,
                                c8x:c8x + cells_cu] = \
                        self._decode_ref_idx(self.nref_l0)
                self.d.mvd8[c8y, c8x] = self._decode_mvd()
                self.d.mvp8[c8y, c8x] = self.c.decode_bin(
                    self.ctx("mvp_idx", 0))
            root = self.c.decode_bin(self.ctx("qt_root_cbf", 0))
        if root:
            self.transform_tree(x0, y0, log2_size, 0)

    def _decode_intra_cu(self, x0, y0, log2_size) -> None:
        nxn = False
        if log2_size == self.p.log2_min_cu:
            part = self.c.decode_bin(self.ctx("part_size", 0))
            if part != 1:
                if log2_size != 3:
                    raise ValueError("PART_NxN requires 8x8 CU")
                nxn = True
                self.d.nxn8[y0 >> 3, x0 >> 3] = 1
        pus = ([(x0, y0)] if not nxn else
               [(x0, y0), (x0 + 4, y0), (x0, y0 + 4), (x0 + 4, y0 + 4)])
        flags = [self.c.decode_bin(self.ctx("intra_mode", 0))
                 for _ in pus]
        n4 = (1 << (log2_size - 2)) if not nxn else 1
        for (px, py), hit in zip(pus, flags):
            # MPMs derive from modes of already-decoded PUs (spec
            # 8.4.2) — fill mode4 per PU as we go.
            mpm = self.mpm_for(px, py)
            if hit:
                idx = self.c.decode_bypass()
                if idx:
                    idx = 1 + self.c.decode_bypass()
                mode = mpm[idx]
            else:
                rem = self.c.decode_bypass_bins(5)
                for m in sorted(mpm):
                    if rem >= m:
                        rem += 1
                mode = rem
            self.d.mode4[py >> 2:(py >> 2) + n4,
                         px >> 2:(px >> 2) + n4] = mode
        if self.chroma:
            explicit = self.c.decode_bin(self.ctx("chroma_pred_mode", 0))
            luma_mode = int(self.d.mode4[y0 >> 2, x0 >> 2])
            if explicit:
                idx = (self.c.decode_bypass() << 1) \
                    | self.c.decode_bypass()
                lst = [34 if m == luma_mode else m
                       for m in (0, 26, 10, 1)]
                cmode = lst[idx]
            else:
                cmode = luma_mode            # DM (8.4.3: PU0's mode)
            if self.d.cmode4 is not None:
                n8 = max(1 << (log2_size - 3), 1)
                self.d.cmode4[y0 >> 3:(y0 >> 3) + n8,
                              x0 >> 3:(x0 >> 3) + n8] = cmode
        self.transform_tree(x0, y0, log2_size, 0)

    def transform_tree(self, x0, y0, log2_size, tr_depth) -> None:
        split = (log2_size > self.p.log2_max_tu
                 or (tr_depth == 0 and self._is_nxn(x0, y0, log2_size)
                     and not self._is_inter_cu(x0, y0)))
        if self._codes_tr_split(x0, y0, log2_size, tr_depth):
            split = bool(self.c.decode_bin(
                self.ctx("trans_subdiv", 5 - log2_size)))
            if split and self.d.trsplit8 is not None:
                c = 1 << (log2_size - 3)
                self.d.trsplit8[y0 >> 3:(y0 >> 3) + c,
                                x0 >> 3:(x0 >> 3) + c] = 1
        cbf_cb = cbf_cr = 0
        if self.chroma and log2_size > 2:
            cbf_cb = self.c.decode_bin(self.ctx("cbf_chroma", tr_depth))
            cbf_cr = self.c.decode_bin(self.ctx("cbf_chroma", tr_depth))
        if split:
            half = 1 << (log2_size - 1)
            for dy in (0, half):
                for dx in (0, half):
                    self._transform_leaf_or_split(
                        x0 + dx, y0 + dy, log2_size - 1, tr_depth + 1,
                        cbf_cb, cbf_cr)
            if self.chroma and log2_size == 3:
                if cbf_cb:
                    self.residual_coding(x0 >> 1, y0 >> 1, 2, 1)
                if cbf_cr:
                    self.residual_coding(x0 >> 1, y0 >> 1, 2, 2)
        else:
            if (not self._is_inter_cu(x0, y0) or tr_depth != 0
                    or cbf_cb or cbf_cr):
                cbf_luma = self.c.decode_bin(
                    self.ctx("cbf_luma", 1 if tr_depth == 0 else 0))
            else:
                cbf_luma = 1               # inferred (7.3.8.10)
            self._transform_unit(x0, y0, log2_size, cbf_luma,
                                 cbf_cb, cbf_cr)

    def _transform_leaf_or_split(self, x0, y0, log2_size, tr_depth,
                                 parent_cb, parent_cr) -> None:
        cbf_cb = cbf_cr = 0
        if self.chroma and log2_size > 2:
            if parent_cb:
                cbf_cb = self.c.decode_bin(self.ctx("cbf_chroma", tr_depth))
            if parent_cr:
                cbf_cr = self.c.decode_bin(self.ctx("cbf_chroma", tr_depth))
        cbf_luma = self.c.decode_bin(
            self.ctx("cbf_luma", 1 if tr_depth == 0 else 0))
        extra = 0
        if log2_size == 2 and (x0 & 4) and (y0 & 4):
            extra = parent_cb or parent_cr
        self._transform_unit(x0, y0, log2_size, cbf_luma, cbf_cb,
                             cbf_cr, dqp_extra=extra)

    def _qg_start(self, cxi: int, cyi: int) -> None:
        if not self.dqp:
            return
        self._qg_cur = (cyi, cxi)
        self._qg_coded = False
        self._qg_qp = None

    def _maybe_parse_dqp(self, any_cbf) -> None:
        """Inverse of _maybe_code_dqp."""
        if not self.dqp or self._qg_coded or not any_cbf:
            return
        a = 0
        if self.c.decode_bin(self.ctx("cu_qp_delta", 0)):
            a = 1
            while a < 5 and self.c.decode_bin(
                    self.ctx("cu_qp_delta", 1)):
                a += 1
            if a == 5:
                a += self._decode_egk(0)
        delta = 0
        if a:
            delta = -a if self.c.decode_bypass() else a
        self._qg_qp = self._qp_pred + delta
        self._qg_coded = True

    def _transform_unit(self, x0, y0, log2_size, cbf_luma, cbf_cb,
                        cbf_cr, dqp_extra=0) -> None:
        self._maybe_parse_dqp(cbf_luma or cbf_cb or cbf_cr or dqp_extra)
        if cbf_luma:
            self.residual_coding(x0, y0, log2_size, 0)
        if self.chroma and log2_size > 2:
            if cbf_cb:
                self.residual_coding(x0 >> 1, y0 >> 1, log2_size - 1, 1)
            if cbf_cr:
                self.residual_coding(x0 >> 1, y0 >> 1, log2_size - 1, 2)

    def residual_coding(self, x0, y0, log2_size, c_idx) -> None:
        p, c, ctx = self.p, self.c, self.ctx
        size = 1 << log2_size
        chroma = c_idx > 0
        if (p.transform_skip and log2_size == 2
                and not p.transquant_bypass):
            flag = c.decode_bin(ctx("transform_skip",
                                    1 if chroma else 0))
            tmap = (self.d.tskip4, self.d.tskip_cb,
                    self.d.tskip_cr)[c_idx]
            if tmap is not None:
                tmap[y0 >> 2, x0 >> 2] = flag
        lx0 = x0 * 2 if chroma else x0
        ly0 = y0 * 2 if chroma else y0
        if self._is_inter_cu(lx0, ly0):
            scan_idx = SCAN_DIAG
        else:
            mode = (self._chroma_mode_of(lx0, ly0) if chroma
                    else int(self.d.mode4[ly0 >> 2, lx0 >> 2]))
            scan_idx = intra_scan_idx(mode, log2_size, chroma)
        scan = coeff_scan(log2_size, scan_idx)
        inv = _inv_coeff_scan(log2_size, scan_idx)

        lx, ly = self._decode_last_xy(log2_size, chroma)
        if scan_idx == SCAN_VER:
            lx, ly = ly, lx
        last = int(inv[ly, lx])
        last_sb, last_pos = last >> 4, last & 15

        levels = np.zeros(size * size, dtype=np.int64)
        n_sb = size >> 2
        sb_scan = scan_order(n_sb, scan_idx)
        csbf = np.zeros((n_sb, n_sb), dtype=np.int32)
        csbf[int(sb_scan[0, 1]), int(sb_scan[0, 0])] = 1
        csbf[int(sb_scan[last_sb, 1]), int(sb_scan[last_sb, 0])] = 1

        gt1_state = 1
        for i in range(last_sb, -1, -1):
            sx, sy = int(sb_scan[i, 0]), int(sb_scan[i, 1])
            infer_dc = False
            if 0 < i < last_sb:
                right = csbf[sy, sx + 1] if sx + 1 < n_sb else 0
                below = csbf[sy + 1, sx] if sy + 1 < n_sb else 0
                ctx_i = (1 if (right or below) else 0) + (2 if chroma else 0)
                csbf[sy, sx] = c.decode_bin(ctx("sig_cg", ctx_i))
                infer_dc = True
            if not csbf[sy, sx]:
                continue

            sig = np.zeros(16, dtype=np.int32)
            start_n = last_pos - 1 if i == last_sb else 15
            if i == last_sb:
                sig[last_pos] = 1
            right_csbf = int(csbf[sy, sx + 1]) if sx + 1 < n_sb else 0
            below_csbf = int(csbf[sy + 1, sx]) if sy + 1 < n_sb else 0
            for n in range(start_n, -1, -1):
                if n > 0 or not infer_dc:
                    xc = int(scan[i * 16 + n, 0])
                    yc = int(scan[i * 16 + n, 1])
                    s_ctx = _sig_ctx(xc, yc, log2_size, scan_idx, chroma,
                                     right_csbf, below_csbf)
                    sig[n] = c.decode_bin(ctx("sig", s_ctx))
                    if sig[n]:
                        infer_dc = False
                elif infer_dc:
                    sig[0] = 1

            sig_pos = [n for n in range(15, -1, -1) if sig[n]]
            if not sig_pos:
                continue

            ctx_set = 0 if (i == 0 or chroma) else 2
            if gt1_state == 0:
                ctx_set += 1
            gt1_state = 1
            gt1 = {}
            first_gt1 = -1
            for n in sig_pos[:8]:
                inc = ctx_set * 4 + min(3, gt1_state) + \
                    (16 if chroma else 0)
                flag = c.decode_bin(ctx("gt1", inc))
                gt1[n] = flag
                if flag:
                    gt1_state = 0
                    if first_gt1 < 0:
                        first_gt1 = n
                elif gt1_state > 0:
                    gt1_state = min(3, gt1_state + 1)
            gt2 = 0
            if first_gt1 >= 0:
                gt2 = c.decode_bin(ctx("gt2",
                                       ctx_set + (4 if chroma else 0)))

            hide = (p.sign_hiding and not p.transquant_bypass
                    and sig_pos[0] - sig_pos[-1] > 3)
            signs = {}
            for n in sig_pos:
                if hide and n == sig_pos[-1]:
                    signs[n] = None         # inferred from parity below
                else:
                    signs[n] = self._crypt(c.decode_bypass())

            rice = 0
            absvals = {}
            for k, n in enumerate(sig_pos):
                if k < 8:
                    base = 1 + gt1[n] + (gt2 if n == first_gt1 else 0)
                    saturated = gt1[n] == 1 and \
                        (n != first_gt1 or gt2 == 1)
                else:
                    base = 1
                    saturated = True
                a = base
                if saturated:
                    a += self._decode_remaining(rice)
                    if a > (3 << rice):
                        rice = min(rice + 1, 4)
                absvals[n] = a
            sum_abs = sum(absvals.values())
            for n in sig_pos:
                sgn = signs[n]
                if sgn is None:
                    sgn = 1 if (sum_abs & 1) else 0
                levels[i * 16 + n] = -absvals[n] if sgn else absvals[n]

        block = np.zeros((size, size), dtype=np.int64)
        block[scan[:, 1], scan[:, 0]] = levels
        plane = self._plane(c_idx)
        plane[y0:y0 + size, x0:x0 + size] = block

    def _decode_last_xy(self, log2_size, chroma):
        off, shift = _last_prefix_ctx_params(log2_size, chroma)
        cmax = (log2_size << 1) - 1
        prefixes = []
        for name in ("last_x", "last_y"):
            prefix = 0
            while prefix < cmax and self.c.decode_bin(
                    self.ctx(name, off + (prefix >> shift))):
                prefix += 1
            prefixes.append(prefix)
        coords = []
        for prefix in prefixes:
            if prefix > 3:
                nbits = (prefix >> 1) - 1
                suffix = self.c.decode_bypass_bins(nbits)
                coords.append(((2 + (prefix & 1)) << nbits) + suffix)
            else:
                coords.append(prefix)
        return coords[0], coords[1]

    def _decode_remaining(self, rice: int) -> int:
        c = self.c
        prefix = 0
        while c.decode_bypass():
            prefix += 1
            if prefix > 40:
                raise ValueError("runaway coeff_abs_level_remaining")
        if prefix < 3:
            value = prefix << rice
            if rice:
                value += c.decode_bypass_bins(rice)
            return value
        length = rice + prefix - 3
        return (3 << rice) + (1 << length) - (1 << rice) + \
            c.decode_bypass_bins(length)
