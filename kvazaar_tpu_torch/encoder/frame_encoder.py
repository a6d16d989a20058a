"""Frame encoder: device search + wavefront recon + host CABAC.

Counterpart of kvazaar_tpu/encoder/frame_encoder.py for the fixed grid
(IntraFrameEncoder at cu 8/16/32, with PFrameMixin's P frames against
one or more references and B frames against one reference per list),
for variable CU trees on I frames (``encode_frame_var``: CUs 8..32 or
8..64, rd 0-3, RDOQ and sign hiding), on P frames with one reference
(``encode_frame_var_p``) and on B frames (``encode_frame_var_b``), where
``var_inter`` holds; the P frames of low-delay GOP structures and of
more than one reference run on the fixed grid of min(intra_max_cu,
32).  The fixed grid's frames take RDOQ and sign hiding where the config
sets them (at the lambda of the frame encoder's QP), its I frames rd 2's
roundtrip re-rank and rd 3's chroma-mode search.  Its one-reference P
frames take SMP/AMP partitions where the config sets them
(``_p_predict_smp``: the MC planes of the PUs' 8x8-cell motion field,
PU edges deblocked on the 8 grid, merge/AMVP per PU in decode order),
and its multi-reference P frames TMVP's temporal candidates.  The P and B
frames of a B pyramid take their GOP layer's QP and lambda
(``frame_lambda``).  The device program (intra mode search; for
P/B frames motion search, the intra/inter decision and motion
compensation (bi-averaged for BI blocks); wavefront
reconstruction, deblocking, per-frame SSE; SAO) is plain tensor code on
the encoder's device, with the fixed grid's reconstruction in the CUDA
kernel on a card; the host picks a variable tree and plans its
wavefront, runs the merge RD of a P tree, decides merge/AMVP signalling,
serializes slice data with the native CABAC (WPP substreams) and frames
the NAL units.  Tiles (a uniform grid: the plan's decode order becomes
tile-major and prediction stops at tile boundaries) and --slices (CTU
rows as dependent slice segments, or a slice per tile) go to the Python
serializer, as in the JAX package.

SAO runs on the device right after deblocking (statistics, decision and
filter, ``_sao_stage``) on I frames and variable-tree P frames; only the
packed per-CTU parameters come back, and the filtered reconstruction is
the reference of the next P frame; under tiles the decision runs on the
host (its merges stop at tile boundaries).  Fixed-grid P frames run no SAO
stage and code every CTU's SAO as off, as the JAX package's do.  The
per-frame SSEs are taken before SAO, as the JAX package takes them on
its pipelined path.

Transfers are dense: int16 levels, uint8 modes and recon, the inter map
and MVs and float32 SSEs come back with one ``.cpu()`` per tensor (no
packed upload or nibble level pack).  The reference picture of the next
P frame (the DPB) stays on the device as the deblocked reconstruction.

A scaling list (``--scaling-list default`` or ``--cqmfile``,
``self.scaling``) reaches every reconstruction (``_recon_tools`` on the
fixed grid, the kernel's SL instances on a card; the variable trees'
TB passes) but no search, as in the JAX package; there the variable P
and B trees' RDOQ takes the frame encoder's QP and plain lambda
(``_var_recon_inter``) and a per-frame QP override raises, so a GOP layer
QP takes a frame encoder of its own (api.py).

Fixed-grid I frames and one-reference P frames also take a per-CTU QP
map (LCU rate control, ROI and AQ; ``encode_frame(qp_ctu=)``,
``encode_p_frame(qp_ctu=)``): the search stays at the config's QP, each
block reconstructs at its CTU's QP (the wavefront kernel takes the map),
deblocking takes the effective map a decoder derives from the
cu_qp_delta syntax, and the slice data codes cu_qp_delta.
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
                                         NAL_TRAIL_R, SLICE_B, SLICE_I,
                                         SLICE_P)
from kvazaar_tpu_torch.encoder import host_pixels, pix_dtype
from kvazaar_tpu_torch.encoder.geometry import (make_intra_plan,
                                                z_order_index)
from kvazaar_tpu_torch.bitstream import native
from kvazaar_tpu_torch.encoder.inter_cands import (
    _integral, amvp_candidates, amvp_pair_b_at, amvp_pair_p_multiref_at,
    amvp_pair_pu_at, merge_amvp_var_b_vec, merge_amvp_var_vec,
    merge_candidates, merge_list_b_at, merge_list_p_multiref_at,
    merge_list_pu_at, pu_cell_rects, var_b_derive, var_origin_maps,
    var_p_derive, var_skip8_vec)
from kvazaar_tpu_torch.encoder.inter_search import (
    bi_check, bi_mc_planes, bi_mc_planes_cells, mc_planes, mc_planes_cells,
    merge_satd_maps_b, merge_satd_maps_p, search_inter_frame,
    search_inter_frame_smp)
from kvazaar_tpu_torch.encoder.intra_recon import (
    blocks_to_plane, reconstruct_chroma_frames, reconstruct_frames)
from kvazaar_tpu_torch.encoder.intra_search import (_f32,
                                                   search_chroma_modes,
                                                   search_frame_modes)
from kvazaar_tpu_torch.encoder.quadtree import (SPLIT_FLAG_BINS,
                                                build_cell_fields,
                                                choose_tree,
                                                reconstruct_frame_var,
                                                search_quadtree,
                                                search_quadtree_b,
                                                search_quadtree_p,
                                                var_bs_maps, var_edge_masks)
from kvazaar_tpu_torch.encoder.var_schedule import build_var_plan
from kvazaar_tpu_torch.ops.deblock import deblock_frame
from kvazaar_tpu_torch.ops.quant import int32_table
from kvazaar_tpu_torch.ops.scaling import ScalingLists, parse_cqmfile
from kvazaar_tpu_torch.ops.sao import (apply_sao_plane, sao_decide_frame,
                                       sao_decide_frame_device, sao_stats)
from kvazaar_tpu_torch.ops.sse import FrameSse, PlaneSse


def chroma_qp(qp: int) -> int:
    """H.265 Table 8-10 chroma QP (4:2:0)."""
    return int(CHROMA_QP_TAB[min(max(qp, 0), 51)])


def qp_to_lambda(qp: int) -> float:
    """I-frame lambda: 0.57 * 2^((qp-12)/3)."""
    return 0.57 * 2.0 ** ((qp - 12) / 3.0)


def frame_lambda(qp: int, slice_type: int, gop_len: int = 0,
                 intra_period: int = 0, qp_factor=None,
                 keyframe: bool = False) -> float:
    """Per-picture lambda (the JAX package's frame_lambda):
    2^((qp-12)/3) scaled by the slice kind (I: 0.57 with a reduction by
    the intra period; GOP pictures: the GOP entry's qp_factor; plain P:
    0.4624), then the non-keyframe boost clip(2, 4, (qp-12)/6)."""
    period = gop_len if gop_len > 0 else intra_period
    lam = 2.0 ** ((qp - 12) / 3.0)
    if slice_type == SLICE_I:
        lam *= 0.57
        if period == 0:
            lam *= 0.5
        else:
            lam *= 1.0 - min(max(0.05 * (period - 1), 0.0), 0.5)
    elif gop_len > 0 and qp_factor is not None:
        lam *= qp_factor
    else:
        lam *= 0.4624
    if period > 0 and not keyframe:
        lam *= min(max((qp - 12) / 6.0, 2.0), 4.0)
    return lam


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


def var_tree(cfg: Config) -> bool:
    """Variable intra CU trees (intra_min_cu < intra_max_cu)."""
    return cfg.intra_min_cu < cfg.intra_max_cu


def var_inter(cfg: Config) -> bool:
    """P/B frames run variable CU trees (the JAX package's
    ``_var_inter_active``): either tool's CU range is not degenerate, or
    the inter size differs from the fixed working grid, on structures
    with one reference per list (IPPP with one reference, B pyramids).
    Low-delay GOP structures, more than one reference, TMVP and SMP keep
    the fixed grid: SMP/AMP P frames take its SMP branch
    (``_p_predict_smp``; one reference, per frame or pipelined), TMVP
    streams the multi-reference stream shape
    (``encode_p_frame_multi(tctx=)``)."""
    fixed_cu = min(max(cfg.intra_max_cu, 8), 32)
    return ((cfg.intra_min_cu != cfg.intra_max_cu
             or cfg.inter_min_cu != cfg.inter_max_cu
             or cfg.inter_max_cu != fixed_cu)
            and not cfg.smp and cfg.ref_frames == 1
            and cfg.lp_gop is None and not cfg.tmvp)


def unsupported(cfg: Config) -> list:
    """Names of the config features the port does not cover yet: fixed
    CU 64, the configs whose JAX streams do not decode to their recon
    (ROADMAP §3: F3, F4), mesh sharding, selective encryption and field
    sources.  SMP/AMP and TMVP encode wherever the config accepts them
    (``var_inter`` says which path)."""
    out = []
    if not var_tree(cfg) and cfg.intra_max_cu not in (4, 8, 16, 32):
        out.append(f"fixed CU size {cfg.intra_max_cu} (4, 8, 16 and 32 "
                   "are ported; 64 inside a variable tree)")
    # The JAX package's --rd 3 can give a 64 CU's quadrants different
    # chroma modes while its stream codes one: its decoded picture then
    # differs from its reconstruction (ROADMAP §3, F3).
    if (var_tree(cfg) and cfg.intra_max_cu == 64 and cfg.rd >= 3
            and cfg.chroma_format == 420):
        out.append("--rd 3 with 64x64 intra CUs")
    # The JAX package's intra-NxN chroma quantizes Cr with the Cb tables
    # while its oracle (and a spec decoder) takes Cr's: with a cqmfile
    # whose intra 4x4 Cb and Cr matrices differ its Cr decodes to another
    # picture than its reconstruction (ROADMAP §3, F4).
    if (not var_tree(cfg) and cfg.intra_max_cu == 4 and cfg.cqmfile
            and cfg.chroma_format == 420):
        sl = parse_cqmfile(cfg.cqmfile)
        if not np.array_equal(sl.custom[(0, 1)], sl.custom[(0, 2)]):
            out.append("cu 4 with different intra 4x4 Cb and Cr scaling "
                       "lists")
    for name, on in (("mesh sharding", cfg.mesh_tiles > 1),
                     ("selective encryption", cfg.crypto is not None),
                     ("field (interlaced) sources",
                      cfg.source_scan_type != 0)):
        if on:
            out.append(name)
    return out


def compute_bs_maps_b(is_inter, cbf_luma_blk, dirs, mv0, mv1):
    """Per-CU-edge boundary strengths of a fixed-grid B frame (8.7.2.4):
    inter-inter edges get bS 1 where the sides' directions differ or a
    list the first side uses moves by a sample or more."""
    intra_b = ~is_inter

    def edge(sl_a, sl_b):
        cbf = cbf_luma_blk[sl_a] | cbf_luma_blk[sl_b]
        d_a = dirs[sl_a]
        d0 = torch.any(torch.abs(mv0[sl_a] - mv0[sl_b]) >= 4, dim=-1)
        d1 = torch.any(torch.abs(mv1[sl_a] - mv1[sl_b]) >= 4, dim=-1)
        mvd = ((d_a != dirs[sl_b]) | ((d_a != 1) & d0)
               | ((d_a != 0) & d1))
        return torch.where(intra_b[sl_a] | intra_b[sl_b], 2,
                           torch.where(cbf | mvd, 1, 0)).to(torch.int32)

    by, bx = is_inter.shape
    all_ = slice(None)
    bs_v = torch.zeros((by, bx), dtype=torch.int32, device=mv0.device)
    bs_h = torch.zeros((by, bx), dtype=torch.int32, device=mv0.device)
    bs_v[:, 1:] = edge((all_, slice(0, bx - 1)), (all_, slice(1, bx)))
    bs_h[1:, :] = edge((slice(0, by - 1), all_), (slice(1, by), all_))
    return bs_v, bs_h


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


def compute_bs_maps_smp(inter8, cbf8, mv_cells, cu: int, part8):
    """Boundary strengths on the 8 grid of an SMP P frame (8.7.2.4): the
    full rules on CU edges (every cu-multiple), the MV-difference rule on
    the PU edges inside inter CUs, 0 elsewhere.  inter8 / cbf8: (h8, w8)
    bool, CU-filled; mv_cells: (h8, w8, 2) quarter-pel; part8: (h8, w8)
    int32 CU-filled part mode.  Returns (bs_v, bs_h) int32 (h8, w8)."""
    cells = cu // 8
    h8, w8 = inter8.shape
    dev = inter8.device
    intra8 = ~inter8
    col = (torch.arange(w8, device=dev) % cells)[None, :]
    row = (torch.arange(h8, device=dev) % cells)[:, None]

    def edge(sl_a, sl_b, is_cu_edge, is_pu_edge):
        cbf = cbf8[sl_a] | cbf8[sl_b]
        mvd = torch.any(torch.abs(mv_cells[sl_a] - mv_cells[sl_b]) >= 4,
                        dim=-1)
        bs = torch.where(intra8[sl_a] | intra8[sl_b], 2,
                         torch.where(cbf | mvd, 1, 0))
        return torch.where(is_cu_edge, bs,
                           torch.where(is_pu_edge & mvd, 1, 0)).to(
                               torch.int32)

    pu_v = torch.zeros((h8, w8), dtype=torch.bool, device=dev)
    pu_h = torch.zeros_like(pu_v)
    if cells > 1:
        half = cells // 2
        quarter = max(cells // 4, 1)
        pu_v = (((part8 == 2) & (col == half))
                | ((part8 == 6) & (col == quarter))
                | ((part8 == 7) & (col == cells - quarter))) & inter8
        pu_h = (((part8 == 1) & (row == half))
                | ((part8 == 4) & (row == quarter))
                | ((part8 == 5) & (row == cells - quarter))) & inter8
    all_ = slice(None)
    bs_v = torch.zeros((h8, w8), dtype=torch.int32, device=dev)
    bs_h = torch.zeros((h8, w8), dtype=torch.int32, device=dev)
    bs_v[:, 1:] = edge((all_, slice(0, w8 - 1)), (all_, slice(1, w8)),
                       (col == 0)[:, 1:], pu_v[:, 1:])
    bs_h[1:, :] = edge((slice(0, h8 - 1), all_), (slice(1, h8), all_),
                       (row == 0)[1:, :], pu_h[1:, :])
    return bs_v, bs_h


def _up(a: torch.Tensor, k: int) -> torch.Tensor:
    """Each entry of a (By, Bx, ...) grid repeated over k x k cells."""
    return torch.repeat_interleave(torch.repeat_interleave(a, k, dim=0), k,
                                   dim=1)


def _pu1_cells(part_cells, row_in, col_in, cells: int):
    """The cells of each CU's second PU under its part mode (HEVC
    PartMode 1 2NxN, 2 Nx2N, 4 2NxnU, 5 2NxnD, 6 nLx2N, 7 nRx2N); row_in
    / col_in: each cell's row / column inside its CU.  Works on torch
    tensors and numpy arrays alike."""
    half = cells // 2
    quarter = max(cells // 4, 1)
    return (((part_cells == 1) & (row_in >= half))
            | ((part_cells == 2) & (col_in >= half))
            | ((part_cells == 4) & (row_in >= quarter))
            | ((part_cells == 5) & (row_in >= cells - quarter))
            | ((part_cells == 6) & (col_in >= quarter))
            | ((part_cells == 7) & (col_in >= cells - quarter)))


class PFrameMixin:
    """P frames of the fixed grid with one or more L0 references (the
    JAX package's PFrameMixin, TMVP's temporal candidates included), at
    the config's QP or, with one reference, a per-CTU QP map; SMP/AMP
    partitions with one reference; and the per-CTU QP machinery that
    fixed-grid I frames share."""

    # ---- Per-CTU QP (LCU rate control, ROI, AQ): each block quantizes
    # at its CTU's QP; deblocking takes the effective map, the QP a
    # decoder derives from the cu_qp_delta syntax (8.6.1, quantization
    # group = CTU). ----

    def _qp_grid_idx(self):
        """(CTU rows, CTU columns, the CTU row of each block row, the CTU
        column of each block column)."""
        ctus_y = -(-self.coded_h // 64)
        ctus_x = -(-self.coded_w // 64)
        by = np.minimum(np.arange(self.plan.blocks_y) * self.cu // 64,
                        ctus_y - 1)
        bx = np.minimum(np.arange(self.plan.blocks_x) * self.cu // 64,
                        ctus_x - 1)
        return ctus_y, ctus_x, by, bx

    def _qp_blk_of(self, qp_ctu: torch.Tensor) -> torch.Tensor:
        """(B, Cy, Cx) per-CTU values -> (B, By, Bx) per block."""
        _, _, by, bx = self._qp_grid_idx()

        def idx(a):
            return int32_table(a.astype(np.int32).tobytes(),
                               qp_ctu.device).long()

        return qp_ctu[:, idx(by)][:, :, idx(bx)]

    def _cbf_ctu_of(self, lv_y, lv_cb, lv_cr) -> torch.Tensor:
        """(B, Cy, Cx) bool: the CTU codes a coefficient, from raster-order
        levels (B, N_blocks, S, S)."""
        b = lv_y.shape[0]
        cy, cx, byi, bxi = self._qp_grid_idx()
        cbf = (lv_y != 0).flatten(2).any(dim=2)
        for lv in (lv_cb, lv_cr):
            if lv is not None:
                cbf = cbf | (lv != 0).flatten(2).any(dim=2)
        ctu = (byi[:, None] * cx + bxi[None, :]).astype(np.int32).ravel()
        idx = int32_table(ctu.tobytes(), lv_y.device).long()
        out = torch.zeros((b, cy * cx), dtype=torch.int32,
                          device=lv_y.device)
        out.scatter_reduce_(1, idx.expand(b, -1), cbf.to(torch.int32),
                            reduce="amax")
        return out.reshape(b, cy, cx) != 0

    def _effective_qp_ctu(self, qp_ctu, cbf_ctu) -> torch.Tensor:
        """Intended (B, Cy, Cx) map + cbf -> the effective map: a CTU with
        no coded coefficient signals no cu_qp_delta and takes its
        predictor, the QP of the last coded CTU before it, or the slice
        QP at the start of the slice and, under WPP, of each CTU row."""
        b, cy, cx = qp_ctu.shape
        q, c = qp_ctu, cbf_ctu
        if not self.params.wpp:
            q, c = q.reshape(b, 1, cy * cx), c.reshape(b, 1, cy * cx)
        idx = torch.arange(q.shape[2], device=q.device).expand(q.shape)
        last = torch.cummax(torch.where(c, idx, -1), dim=2).values
        eff = torch.where(last >= 0,
                          torch.take_along_dim(q, last.clamp(min=0), dim=2),
                          self.cfg.qp)
        return eff.reshape(b, cy, cx).to(torch.int32)

    def _deblock_qp_map(self, qp_ctu, levels):
        """(By, Bx) effective per-block QP of a one-frame batch for
        deblocking, or None without a QP map or deblocking."""
        if qp_ctu is None or not self.cfg.deblock:
            return None
        return self._qp_blk_of(self._effective_qp_ctu(
            qp_ctu, self._cbf_ctu_of(*levels)))[0]

    def _recon_tools(self) -> dict:
        """The coding tools of a fixed-grid reconstruction: lossless, or
        RDOQ and sign hiding where the config sets them, at the lambda of
        the frame encoder's QP (also under a per-CTU QP map, as the JAX
        package quantizes), and its scaling list."""
        cfg = self.cfg
        return dict(lossless=cfg.lossless,
                    signhide=cfg.signhide and not cfg.lossless,
                    rdoq=cfg.rdoq, lam=qp_to_lambda(cfg.qp),
                    scaling=self.scaling)

    def _p_predict(self, yp, refs):
        """Search and decision of one P frame: (H, W) int32 source luma
        and the references' (y, cb, cr) planes in L0 order.  Returns
        (modes int32 (By, Bx), inter map bool, ref_sel int32 (By, Bx)
        L0 index of each inter block (0 for intra blocks), mv int32
        (By, Bx, 2), MC prediction planes (y, cb, cr) int32)."""
        plan = self.plan
        nref = len(refs)
        modes, intra_cost = search_frame_modes(
            yp, plan, self.lambda_satd, self.bitdepth, self.cfg.rd >= 1)
        mvs, costs = [], []
        for ri, (ref_y, _cb, _cr) in enumerate(refs):
            mv_r, c_r = search_inter_frame(
                yp, ref_y, plan, self.lambda_me, self.cfg.me_range,
                self.bitdepth, subpel=self.cfg.me_subpel)
            # The ref_idx bits: 0 with one reference, else ri + 1 below
            # the last index and ri for the last (truncated unary).
            rb = 0 if nref == 1 else (ri + 1 if ri < nref - 1 else ri)
            mvs.append(mv_r)
            costs.append(c_r + _f32(self.lambda_me * rb) if rb else c_r)
        costs = torch.stack(costs)
        sel = torch.argmin(costs, dim=0)
        mv = torch.take_along_dim(torch.stack(mvs), sel[None, ..., None],
                                  dim=0)[0]
        # Mode decision (a slight inter bias covers un-modelled merge
        # savings), in float32 as JAX forms it.
        inter_map = costs.min(dim=0).values <= intra_cost * _f32(1.02)
        mv = torch.where(inter_map[..., None], mv, 0).to(torch.int32)
        ref_sel = torch.where(inter_map, sel, 0).to(torch.int32)

        def stacked(k):
            return None if refs[0][k] is None else torch.stack(
                [r[k] for r in refs])

        mcs = mc_planes(stacked(0), stacked(1), stacked(2), mv, plan,
                        self.bitdepth, ref_grid=ref_sel)
        return modes, inter_map, ref_sel, mv, mcs

    def _p_predict_smp(self, yp, ref):
        """Search and decision of one SMP/AMP P frame against one
        reference's (y, cb, cr) planes: the partition search, the
        intra/inter decision with its 1.02 inter bias, and MC through the
        8x8-cell motion field of the PUs.  Returns (modes, inter map,
        part int32 (By, Bx), mv_pu int32 (By, Bx, 2, 2), mv_cells int32
        (h8, w8, 2), MC planes (y, cb, cr) int32), part and motion zero
        outside inter blocks."""
        modes, intra_cost = search_frame_modes(
            yp, self.plan, self.lambda_satd, self.bitdepth,
            self.cfg.rd >= 1)
        part, mv_pu, inter_cost = search_inter_frame_smp(
            yp, ref[0], self.plan, self.lambda_me, self.cfg.me_range,
            self.bitdepth, subpel=self.cfg.me_subpel, amp=self.cfg.amp)
        inter_map = inter_cost <= intra_cost * _f32(1.02)
        part = torch.where(inter_map, part, 0).to(torch.int32)
        mv_pu = torch.where(inter_map[..., None, None], mv_pu,
                            0).to(torch.int32)
        cells = self.cu // 8
        h8, w8 = self.coded_h // 8, self.coded_w // 8
        dev = yp.device
        pu1 = _pu1_cells(_up(part, cells),
                         (torch.arange(h8, device=dev) % cells)[:, None],
                         (torch.arange(w8, device=dev) % cells)[None, :],
                         cells)
        mv_cells = torch.where(pu1[..., None], _up(mv_pu[:, :, 1], cells),
                               _up(mv_pu[:, :, 0], cells))
        mcs = mc_planes_cells(*ref, mv_cells, self.bitdepth)
        return modes, inter_map, part, mv_pu, mv_cells, mcs

    def _p_from_planes(self, yp, cbp, crp, refs, qp_ctu=None):
        """Device program of one P frame: (H, W) int32 source planes and
        the references' (y, cb, cr) planes; qp_ctu: (Cy, Cx) int32
        per-CTU QP on the device (the search stays at the config's QP).
        Returns (modes uint8, inter map bool, ref_sel int32, mv int32
        (By, Bx, 2), levels (y, cb, cr), deblocked recon uint8/int16 (y, cb,
        cr), the one-frame batch's FrameSse, part int32 (By, Bx) and
        mv_pu int32 (By, Bx, 2, 2)), on the device; part and mv_pu are
        None off SMP, and under SMP mv is each block's first PU's motion
        and ref_sel zero (one reference)."""
        plan = self.plan
        part = mv_pu = None
        if self.cfg.smp:
            modes, inter_map, part, mv_pu, mv_cells, \
                (mc_y, mc_cb, mc_cr) = self._p_predict_smp(yp, refs[0])
            mv = mv_pu[:, :, 0]
            ref_sel = torch.zeros_like(part)
        else:
            modes, inter_map, ref_sel, mv, (mc_y, mc_cb, mc_cr) = \
                self._p_predict(yp, refs)

        def one(t):
            return None if t is None else t[None]

        qp_ctu = one(qp_ctu)
        rec_y, lv_y, rec_cb, lv_cb, rec_cr, lv_cr = reconstruct_frames(
            yp[None], one(cbp), one(crp), modes[None], plan, self.cfg.qp,
            self.qp_c, self.bitdepth, is_inter=inter_map[None],
            mc_y=mc_y[None], mc_cb=one(mc_cb), mc_cr=one(mc_cr),
            qp_map=None if qp_ctu is None else self._qp_blk_of(qp_ctu),
            **self._recon_tools())
        bs = None
        grid = None
        if self.cfg.deblock:
            cbf_blk = (lv_y[0] != 0).flatten(1).any(dim=1).reshape(
                plan.blocks_y, plan.blocks_x)
            if part is not None:
                # PU edges inside a CU lie on the 8 grid (SMP turns the
                # per-CTU QP off, so there is no QP map).
                cells = self.cu // 8
                bs = compute_bs_maps_smp(
                    _up(inter_map, cells), _up(cbf_blk, cells), mv_cells,
                    self.cu, _up(part, cells))
                grid = 8
            else:
                bs = compute_bs_maps(inter_map, cbf_blk, mv, ref=ref_sel)
        recs, sses = self._deblock_sse(
            (yp[None], one(cbp), one(crp)), (rec_y, rec_cb, rec_cr), bs,
            self._deblock_qp_map(qp_ctu, (lv_y, lv_cb, lv_cr)), grid=grid)

        def first(t):
            return None if t is None else t[0]

        return (modes.to(torch.uint8), inter_map, ref_sel, mv,
                (lv_y[0], first(lv_cb), first(lv_cr)),
                tuple(first(r) for r in recs), sses, part, mv_pu)

    def submit_p(self, y, cb, cr, refs, qp_ctu=None):
        """Upload one frame and queue its P program (asynchronous on a
        card).  refs: [(ref_poc, (y, cb, cr) device planes), ...] in L0
        order; qp_ctu: (Cy, Cx) int per-CTU QP (LCU rate control, ROI,
        AQ) or None.  The handle's entry 5 is the deblocked recon on the
        device (the next frame's reference)."""
        ys, cbs, crs = (None if a is None else a[0] for a in
                        self._upload(self.host_pack_sources([(y, cb, cr)])))
        return self._p_from_planes(ys, cbs, crs, [pl for _rp, pl in refs],
                                   self._upload_qp(qp_ctu))

    def _upload_qp(self, qp_ctu):
        """(Cy, Cx) host QP map -> int32 on the device (None stays)."""
        if qp_ctu is None:
            return None
        return torch.from_numpy(np.asarray(qp_ctu, np.int32)).to(self.device)

    def download_p(self, handle, need_recon: bool = True):
        """The device->host copies of a submitted P frame; safe to call
        from a worker thread.  The device recon stays in the result as
        the next frame's reference."""
        modes, inter_map, ref_sel, mv, levels, recs, sses, part, mv_pu = \
            handle

        def host(t):
            return None if t is None else t.cpu().numpy()

        want_pixels = need_recon or self.cfg.hash != "none"
        return ((tuple(host(lv) for lv in levels), host(modes),
                 host(inter_map), host(ref_sel), host(mv), sses.host()[0],
                 host(part), host(mv_pu)),
                tuple(host_pixels(r) for r in recs) if want_pixels
                else (None, None, None), recs)

    def finalize_p_downloaded(self, downloaded, poc: int, ref_pocs,
                              retained=(), tctx=None,
                              need_recon: bool = True,
                              multi: bool = True, qp_ctu=None):
        """Host stage: merge/AMVP signalling decisions + CABAC.

        multi: emit the explicit multi-reference RPS and the
        reference-aware candidate derivation (the encode_p_frame_multi
        contract) even with one active reference; False = the plain
        IPPP single-reference stream shape.  qp_ctu: the frame's
        intended per-CTU QP map, coded with cu_qp_delta (FrameData.qp_ctu
        becomes the effective map).  tctx: the collocated picture's motion
        (``bitstream.decoder._motion_of``) for TMVP's temporal
        candidates, or None.  Returns (FrameResult, the device recon
        planes)."""
        ((lv_y, lv_cb, lv_cr), modes, inter_map, ref_sel, mv, sses, part,
         mv_pu), rec_np, recs = downloaded
        if self.cfg.smp:
            mv8, merge8, mvp8, mvd8 = self._merge_amvp_smp(
                inter_map, part, mv_pu)
            fd = self._assemble_p_frame_data_smp(
                modes, inter_map, part, mv8, merge8, mvp8, mvd8, lv_y,
                lv_cb, lv_cr)
        else:
            if multi:
                merge_idx, mvp_idx, mvd = self._merge_amvp_multi(
                    inter_map, ref_sel, mv, len(ref_pocs), poc, ref_pocs,
                    tctx)
            else:
                merge_idx, mvp_idx, mvd = self._merge_amvp_fast(inter_map,
                                                                mv)
            fd = self._assemble_p_frame_data(
                modes, inter_map, mv, merge_idx, mvp_idx, mvd, lv_y, lv_cb,
                lv_cr, ref_sel=ref_sel if multi else None)
        if qp_ctu is not None:
            fd.qp_ctu = np.asarray(qp_ctu, np.int32).copy()
        deltas = [poc - rp for rp in ref_pocs]
        nal = self._serialize_p(fd, poc, deltas[0],
                                ref_list_l0=deltas if multi else None,
                                retained_l0=retained, tmvp=self.cfg.tmvp)
        if not (need_recon or self.cfg.hash != "none"):
            rec_np = (None, None, None)
        nal = self._with_hash(nal, rec_np)
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

    def _merge_amvp_multi(self, inter_map, ref_sel, mv, nref, poc,
                          ref_pocs, tctx=None):
        """Scalar loop in decode order over the inter blocks for the
        multi-reference candidate lists, with TMVP's temporal candidate
        where tctx holds the collocated motion (the oracle decoder
        derives them the same way)."""
        s = self.cu
        if tctx is not None:
            tctx = dict(tctx, cur_poc=poc, w=self.coded_w, h=self.coded_h)
        by, bx = self.plan.blocks_y, self.plan.blocks_x
        merge_idx = np.full((by, bx), -1, np.int32)
        mvp_idx = np.zeros((by, bx), np.uint8)
        mvd = np.zeros((by, bx, 2), np.int32)
        order = np.argsort(self.plan.step_of_block.ravel() * (by * bx)
                           + np.arange(by * bx), kind="stable")
        for bid in order:
            yy, xx = divmod(int(bid), bx)
            if not inter_map[yy, xx]:
                continue
            mine = (int(ref_sel[yy, xx]),
                    (int(mv[yy, xx, 0]), int(mv[yy, xx, 1])))
            mlist = merge_list_p_multiref_at(
                inter_map, ref_sel, mv, self.plan.avail, yy, xx, nref,
                tctx=tctx, ref_pocs=ref_pocs, cu=s)
            if mine in mlist:
                merge_idx[yy, xx] = mlist.index(mine)
                continue
            pair = amvp_pair_p_multiref_at(
                inter_map, ref_sel, mv, self.plan.avail, yy, xx,
                int(ref_sel[yy, xx]), poc, ref_pocs, tctx=tctx, cu=s)
            d0 = sum(abs(int(mv[yy, xx, k]) - pair[0][k])
                     for k in range(2))
            d1 = sum(abs(int(mv[yy, xx, k]) - pair[1][k])
                     for k in range(2))
            idx = 1 if d1 < d0 else 0
            mvp_idx[yy, xx] = idx
            mvd[yy, xx] = (mv[yy, xx, 0] - pair[idx][0],
                           mv[yy, xx, 1] - pair[idx][1])
        return merge_idx, mvp_idx, mvd

    def _cu_decode_order(self):
        """The fixed grid's CUs in decode order: CTUs in raster order,
        CUs in z-order inside each 64x64 CTU (6.5.1)."""
        by, bx = self.plan.blocks_y, self.plan.blocks_x
        per_ctu = max(64 // self.cu, 1)
        zs = sorted((z_order_index(zx, zy), zy, zx)
                    for zy in range(per_ctu) for zx in range(per_ctu))
        order = []
        for ty in range(-(-by // per_ctu)):
            for tx in range(-(-bx // per_ctu)):
                for _z, zy, zx in zs:
                    cy, cx = ty * per_ctu + zy, tx * per_ctu + zx
                    if cy < by and cx < bx:
                        order.append((cy, cx))
        return order

    def _merge_amvp_smp(self, inter_map, part, mv_pu):
        """Merge/AMVP signalling of each PU of an SMP frame: a scalar CU
        loop in decode order over the 8-cell motion field, with the PU
        candidate rules (inter_cands.merge_list_pu_at, 6.4.2).  Returns
        (mv8 cell field, merge8, mvp8, mvd8), the last three at the PUs'
        marker cells."""
        cells = self.cu // 8
        by, bx = inter_map.shape
        h8, w8 = by * cells, bx * cells
        inter8 = np.kron(inter_map, np.ones((cells, cells), bool))
        # The final motion field (candidates read only cells before the
        # PU in decode order, which _pu_nbr enforces).
        pu1 = _pu1_cells(np.kron(part, np.ones((cells, cells), np.int32)),
                         np.arange(h8)[:, None] % cells,
                         np.arange(w8)[None, :] % cells, cells)
        ones = np.ones((cells, cells, 1), np.int32)
        up0 = np.kron(mv_pu[:, :, 0], ones).reshape(h8, w8, 2)
        up1 = np.kron(mv_pu[:, :, 1], ones).reshape(h8, w8, 2)
        mv8 = np.where(pu1[..., None], up1, up0)
        mv8 = np.where(inter8[..., None], mv8, 0)
        merge8 = np.full((h8, w8), -1, np.int32)
        mvp8 = np.zeros((h8, w8), np.uint8)
        mvd8 = np.zeros((h8, w8, 2), np.int32)
        for (cy, cx) in self._cu_decode_order():
            if not inter_map[cy, cx]:
                continue
            p = int(part[cy, cx])
            by8, bx8 = cy * cells, cx * cells
            for pu_idx, (ry, rx, rh, rw) in enumerate(
                    pu_cell_rects(by8, bx8, cells, p)):
                mine = (int(mv8[ry, rx, 0]), int(mv8[ry, rx, 1]))
                mlist = merge_list_pu_at(inter8, mv8, ry, rx, rh, rw, p,
                                         pu_idx, cells, cu_yx=(by8, bx8))
                if mine in mlist:
                    merge8[ry, rx] = mlist.index(mine)
                    continue
                pair = amvp_pair_pu_at(inter8, mv8, ry, rx, rh, rw, p,
                                       pu_idx, cells, cu_yx=(by8, bx8))
                d0 = abs(mine[0] - pair[0][0]) + abs(mine[1] - pair[0][1])
                d1 = abs(mine[0] - pair[1][0]) + abs(mine[1] - pair[1][1])
                i = 1 if d1 < d0 else 0
                mvp8[ry, rx] = i
                mvd8[ry, rx] = (mine[0] - pair[i][0], mine[1] - pair[i][1])
        return mv8, merge8, mvp8, mvd8

    def _assemble_p_frame_data_smp(self, modes, inter_map, part, mv8,
                                   merge8, mvp8, mvd8, lv_y, lv_cb, lv_cr):
        """FrameData of an SMP P frame: the part mode at each CU's marker
        cell and the PUs' motion on the 8-cell grid; skip only for 2Nx2N
        merge CUs without coefficients."""
        s = self.cu
        cells = s // 8
        fd = self._p_frame_data_base(modes, inter_map, lv_y, lv_cb, lv_cr)
        fd.mv8[:] = mv8
        fd.part8[::cells, ::cells] = np.where(inter_map, part,
                                              0).astype(np.uint8)
        fd.merge8[:] = np.clip(merge8, -1, 4).astype(np.int8)
        fd.mvp8[:] = mvp8
        fd.mvd8[:] = mvd8
        skip = (inter_map & (part == 0) & (merge8[::cells, ::cells] >= 0)
                & self._coeff_free(fd, inter_map.shape))
        fd.skip8[:] = np.kron(skip.astype(np.uint8),
                              np.ones((cells, cells), np.uint8))
        return fd

    def _p_frame_data_base(self, modes, inter_map, lv_y, lv_cb, lv_cr):
        """FrameData of a fixed-grid P frame with its depth, modes,
        coefficients and inter map filled in."""
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
        fd.inter8[:] = np.kron(inter_map.astype(np.uint8),
                               np.ones((c8, c8), np.uint8))
        return fd

    def _coeff_free(self, fd, shape):
        """(By, Bx) bool: the CU codes no coefficient in any plane."""
        s = self.cu
        by, bx = shape
        czero = ~np.any(fd.coeff_y.reshape(by, s, bx, s), axis=(1, 3))
        if self.chroma:
            s2 = s // 2
            for c in (fd.coeff_cb, fd.coeff_cr):
                czero &= ~np.any(c.reshape(by, s2, bx, s2), axis=(1, 3))
        return czero

    def _assemble_p_frame_data(self, modes, inter_map, mv, merge_idx,
                               mvp_idx, mvd, lv_y, lv_cb, lv_cr,
                               ref_sel=None):
        c8 = self.cu // 8
        fd = self._p_frame_data_base(modes, inter_map, lv_y, lv_cb, lv_cr)
        ones = np.ones((c8, c8), np.uint8)
        fd.mv8[:] = np.kron(mv, np.ones((c8, c8, 1), np.int32)) \
            .reshape(fd.mv8.shape)
        # Skip: merge CUs without coefficients.
        skip = (inter_map & (merge_idx >= 0)
                & self._coeff_free(fd, inter_map.shape))
        fd.skip8[:] = np.kron(skip.astype(np.uint8), ones)
        # merge8/mvp8/mvd8 live at CU marker cells.
        fd.merge8[::c8, ::c8] = np.where(inter_map, merge_idx,
                                         -1).astype(np.int8)
        use_amvp = inter_map & (merge_idx < 0)
        fd.mvp8[::c8, ::c8] = np.where(use_amvp, mvp_idx, 0)
        fd.mvd8[::c8, ::c8] = np.where(use_amvp[..., None], mvd, 0)
        if ref_sel is not None:
            fd.ref8[:] = np.kron(
                np.where(inter_map, ref_sel, 0),
                np.ones((c8, c8), np.int32)).astype(np.uint8)
        return fd

    def _native_cabac(self) -> bool:
        """The native CABAC codes the slice data where its library
        builds, and where the JAX package's guards send the slice to it:
        not for lossless streams (its bypass mode is not bound), tiles or
        --slices (it has no tile mode), --tr-depth-intra streams (their
        I, P and B slices code split_transform_flag, which it does not)
        or the intra-NxN point's I slices (part_mode NxN, four modes per
        CU and transform_skip_flag); those go to the Python serializer."""
        return (native.available() and not self.params.transquant_bypass
                and self.params.slices == "none"
                and not self.params.tiles_enabled
                and self.params.max_tr_depth_intra == 0 and self.cu != 4)

    def _python_slice_data(self, fd, slice_type: int, qp: int,
                           nref: int = 1):
        """Slice data from the Python serializer: a substream per tile
        (per CTU row of each tile under WPP), per CTU row under WPP, or
        one.  Returns (bytes, substream sizes)."""
        p = self.params
        dw = BitWriter()
        enc = SliceDataEncoder(p, fd, Contexts(slice_type, qp),
                               CabacEncoder(dw), nref_l0=nref)
        sizes = []
        if p.tiles_enabled and p.wpp:
            sizes = enc.encode_slice_data_tiles_wpp()
        elif p.tiles_enabled:
            sizes = enc.encode_slice_data_tiles()
        elif p.wpp:
            sizes = enc.encode_slice_data_wpp()
        else:
            enc.encode_slice_data()
            dw.align_zero()
        return dw.get_bytes(), sizes

    def _slice_data(self, fd, slice_type: int, qp: int, nref: int = 1):
        """P or B slice data: native CABAC (WPP substreams) where
        ``_native_cabac``, else the Python serializer.  Returns (bytes,
        substream sizes)."""
        if self._native_cabac():
            return native.encode_slice_data_native_p(
                self.params, fd, qp, self.params.wpp, slice_type=slice_type,
                nthreads=self.cfg.threads or 4, nref_l0=nref)
        return self._python_slice_data(fd, slice_type, qp, nref)

    def _slice_nals(self, fd, slice_type: int, nal_type: int, hdr_kwargs,
                    nref_l0: int = 1, qp=None) -> bytes:
        """--slices: one NAL per slice segment.  wpp: the CTU rows as
        dependent segments of one slice; tiles: an independent slice per
        tile, whose slice_segment_address counts CTBs in tile scan
        (7.4.7.1: the CTBs of the tiles before it)."""
        qp = self.cfg.qp if qp is None else qp
        enc = SliceDataEncoder(self.params, fd, Contexts(slice_type, qp),
                               CabacEncoder(BitWriter()), nref_l0=nref_l0)
        if self.params.slices == "wpp":
            segs = enc.encode_row_slices()
            addrs = [r * self.params.width_in_ctus for r in range(len(segs))]
            dep = True
        else:
            segs = enc.encode_tile_slices()
            addrs = np.cumsum([0] + [len(c) for c in enc._tile_ctus[:-1]])
            dep = False
        out = b""
        for i, (seg, a) in enumerate(zip(segs, addrs)):
            w = BitWriter()
            write_slice_header(w, self.params, slice_type, nal_type, qp,
                               first_seg=i == 0, dependent=dep and i > 0,
                               seg_address=int(a), **hdr_kwargs)
            out += nal_unit(w.get_bytes() + seg, nal_type)
        return out

    def _serialize_p(self, fd, poc, ref_poc_diff, ref_list_l0=None,
                     retained_l0=(), tmvp: bool = False, qp=None):
        """P slice NAL at slice QP qp (default the config's): the slice
        data, then the slice header with the plain one-reference RPS or,
        given ref_list_l0 (the POC deltas of the active references), the
        explicit multi-reference RPS with the retained pictures'
        deltas."""
        qp = self.cfg.qp if qp is None else qp
        nref = 1 if ref_list_l0 is None else len(ref_list_l0)
        if self.params.slices != "none":
            return self._slice_nals(
                fd, SLICE_P, NAL_TRAIL_R,
                dict(poc=poc, ref_poc_diff=ref_poc_diff,
                     ref_list_l0=ref_list_l0, retained_l0=retained_l0,
                     tmvp=tmvp), nref_l0=nref, qp=qp)
        data, sizes = self._slice_data(fd, SLICE_P, qp, nref)
        w = BitWriter()
        write_slice_header(w, self.params, SLICE_P, NAL_TRAIL_R, qp,
                           poc=poc, ref_poc_diff=ref_poc_diff,
                           ref_list_l0=ref_list_l0, retained_l0=retained_l0,
                           tmvp=tmvp,
                           num_entry_points=max(len(sizes) - 1, 0),
                           entry_point_offsets=sizes[:-1])
        return nal_unit(w.get_bytes() + data, NAL_TRAIL_R)

    def _serialize_b(self, fd, poc, rpd0, rpd1, qp=None,
                     nal_type=NAL_TRAIL_R):
        """B slice NAL (one reference per list, rpd0 pictures back and
        rpd1 ahead) at slice QP qp; nal_type RASL_R for the leading
        pictures of an open-GOP CRA."""
        qp = self.cfg.qp if qp is None else qp
        if self.params.slices != "none":
            return self._slice_nals(
                fd, SLICE_B, nal_type,
                dict(poc=poc, ref_poc_diff=rpd0, ref_poc_diff_l1=rpd1),
                qp=qp)
        data, sizes = self._slice_data(fd, SLICE_B, qp)
        w = BitWriter()
        write_slice_header(w, self.params, SLICE_B, nal_type, qp, poc=poc,
                           ref_poc_diff=rpd0, ref_poc_diff_l1=rpd1,
                           num_entry_points=max(len(sizes) - 1, 0),
                           entry_point_offsets=sizes[:-1])
        return nal_unit(w.get_bytes() + data, nal_type)

    def _with_hash(self, nal: bytes, rec_np) -> bytes:
        """nal followed by the picture hash SEI of rec_np, where the
        config asks for one."""
        if self.cfg.hash in ("md5", "checksum"):
            from kvazaar_tpu_torch.bitstream.headers import \
                write_picture_hash_sei
            nal += write_picture_hash_sei(rec_np, self.bitdepth,
                                          kind=self.cfg.hash)
        return nal

    def encode_p_frame_multi(self, y, cb=None, cr=None, poc: int = 1,
                             refs=None, retained=(), tctx=None):
        """P frame against one or more L0 references in the stream shape
        of low-delay GOP structures, --ref N and TMVP.  refs: [(ref_poc,
        (y, cb, cr) device planes), ...] in L0 order (increasing POC
        delta); retained: further POC deltas the DPB keeps for later
        pictures (signalled in the RPS, unused here); tctx: the
        collocated picture's motion under TMVP, or None.  Returns
        (FrameResult, the deblocked recon planes on the device)."""
        handle = self.submit_p(y, cb, cr, refs)
        return self.finalize_p_downloaded(
            self.download_p(handle), poc, [rp for rp, _pl in refs],
            retained=retained, tctx=tctx)

    def encode_p_frame(self, y, cb=None, cr=None, poc: int = 1,
                       ref_poc: int = 0, qp_ctu=None, qp=None,
                       qp_factor=None) -> FrameResult:
        """Plain IPPP P frame against the DPB (the previous frame's
        deblocked reconstruction, on the device).  qp_ctu: (Cy, Cx)
        per-CTU QP (LCU rate control, ROI, AQ; fixed grid); qp /
        qp_factor: a GOP layer's QP and lambda factor, taken by variable
        trees (a fixed grid takes its QP from the frame encoder's config,
        as in the JAX package)."""
        if self._dpb is None:
            raise RuntimeError("encode_p_frame needs a reference: encode "
                               "an intra frame first")
        if var_inter(self.cfg) and qp_ctu is None:
            return self.encode_frame_var_p(y, cb, cr, poc=poc,
                                           ref_poc=ref_poc, qp=qp,
                                           qp_factor=qp_factor)
        handle = self.submit_p(y, cb, cr, [(ref_poc, self._dpb)], qp_ctu)
        res, recs = self.finalize_p_downloaded(
            self.download_p(handle), poc, [ref_poc], multi=False,
            qp_ctu=qp_ctu)
        self._dpb = recs
        return res

    # ---- Fixed-grid B frames (one reference per list) ----

    def _b_predict(self, yp, r0_y, r1_y):
        """Search and decision of a fixed-grid B frame: the mode search,
        a full motion search against each list, the bi-pred check
        (``satd + lambda_me * (both lists' mv rate)``, one multiply-add;
        +inf without bipred), the first-index argmin over (L0, L1, BI)
        and the intra/inter decision with its 1.02 inter bias in
        float32.  Returns (modes, inter map bool, dirs int32, mv0, mv1
        (By, Bx, 2) int32), MVs and dirs zero outside inter blocks."""
        plan = self.plan
        bd = self.bitdepth
        modes, intra_cost = search_frame_modes(
            yp, plan, self.lambda_satd, bd, self.cfg.rd >= 1)
        r0_y, r1_y = r0_y.to(torch.int32), r1_y.to(torch.int32)
        mv0, c0 = search_inter_frame(yp, r0_y, plan, self.lambda_me,
                                     self.cfg.me_range, bd,
                                     subpel=self.cfg.me_subpel)
        mv1, c1 = search_inter_frame(yp, r1_y, plan, self.lambda_me,
                                     self.cfg.me_range, bd,
                                     subpel=self.cfg.me_subpel)
        if self.cfg.bipred:
            cbi = bi_check(yp.to(torch.int32), r0_y, r1_y, mv0, mv1, plan,
                           self.lambda_me, bd)[0]
        else:
            cbi = torch.full_like(c0, float("inf"))
        costs = torch.stack([c0, c1, cbi])
        dirs = torch.argmin(costs, dim=0).to(torch.int32)
        inter_map = costs.min(dim=0).values <= intra_cost * _f32(1.02)
        keep = inter_map[..., None]
        return (modes, inter_map, torch.where(inter_map, dirs, 0),
                torch.where(keep, mv0, 0).to(torch.int32),
                torch.where(keep, mv1, 0).to(torch.int32))

    def _b_from_planes(self, yp, cbp, crp, ref0, ref1):
        """Device program of a fixed-grid B frame: (H, W) int32 source
        planes and each list's reference (y, cb, cr) planes.  The CUs'
        L0 / L1 / bi-averaged MC planes go into the wavefront kernel's
        inter variant.  Returns (modes uint8, inter map, dirs, mv0, mv1,
        levels (y, cb, cr), deblocked recon uint8/int16 (y, cb, cr), the
        one-frame batch's FrameSse), on the device."""
        plan = self.plan
        modes, inter_map, dirs, mv0, mv1 = self._b_predict(yp, ref0[0],
                                                           ref1[0])
        mc_y, mc_cb, mc_cr = bi_mc_planes(ref0, ref1, mv0, mv1, dirs, plan,
                                          self.bitdepth)

        def one(t):
            return None if t is None else t[None]

        rec_y, lv_y, rec_cb, lv_cb, rec_cr, lv_cr = reconstruct_frames(
            yp[None], one(cbp), one(crp), modes[None], plan, self.cfg.qp,
            self.qp_c, self.bitdepth, is_inter=inter_map[None],
            mc_y=mc_y[None], mc_cb=one(mc_cb), mc_cr=one(mc_cr),
            **self._recon_tools())
        bs = None
        if self.cfg.deblock:
            cbf_blk = (lv_y[0] != 0).flatten(1).any(dim=1).reshape(
                plan.blocks_y, plan.blocks_x)
            bs = compute_bs_maps_b(inter_map, cbf_blk, dirs, mv0, mv1)
        recs, sses = self._deblock_sse(
            (yp[None], one(cbp), one(crp)), (rec_y, rec_cb, rec_cr), bs)

        def first(t):
            return None if t is None else t[0]

        return (modes.to(torch.uint8), inter_map, dirs, mv0, mv1,
                (lv_y[0], first(lv_cb), first(lv_cr)),
                tuple(first(r) for r in recs), sses)

    def _merge_amvp_b(self, inter_map, dirs, mv0, mv1, poc, ref_pocs):
        """Scalar loop in decode order over a fixed-grid B frame's inter
        blocks: the merge list of (dir, mv0, mv1) on the effective motion
        fields (an unused list's MV is 0), else AMVP per used list (L1
        candidates scaled by POC distance).  Returns (merge_idx, mvp0,
        mvp1, mvd0, mvd1, emv0, emv1)."""
        by, bx = self.plan.blocks_y, self.plan.blocks_x
        mvd0 = np.zeros((by, bx, 2), np.int32)
        mvd1 = np.zeros((by, bx, 2), np.int32)
        mvp0 = np.zeros((by, bx), np.uint8)
        mvp1 = np.zeros((by, bx), np.uint8)
        merge_idx = np.full((by, bx), -1, np.int32)
        order = np.argsort(self.plan.step_of_block.ravel() * (by * bx)
                           + np.arange(by * bx), kind="stable")
        emv0 = np.where((dirs != 1)[..., None] & inter_map[..., None],
                        mv0, 0)
        emv1 = np.where((dirs != 0)[..., None] & inter_map[..., None],
                        mv1, 0)
        avail = self.plan.avail
        for bid in order:
            yy, xx = divmod(int(bid), bx)
            if not inter_map[yy, xx]:
                continue
            d = int(dirs[yy, xx])
            mine = (d, (int(emv0[yy, xx, 0]), int(emv0[yy, xx, 1])),
                    (int(emv1[yy, xx, 0]), int(emv1[yy, xx, 1])))
            mlist = merge_list_b_at(inter_map, dirs, emv0, emv1, avail, yy,
                                    xx, ref_pocs)
            if mine in mlist:
                merge_idx[yy, xx] = mlist.index(mine)
                continue
            for lst, mv, mvp, mvd in ((0, mv0, mvp0, mvd0),
                                      (1, mv1, mvp1, mvd1)):
                if d == 1 - lst:
                    continue
                pair = amvp_pair_b_at(inter_map, dirs, emv0, emv1, avail,
                                      yy, xx, lst, poc, ref_pocs)
                d0 = sum(abs(int(mv[yy, xx, k]) - pair[0][k])
                         for k in range(2))
                d1 = sum(abs(int(mv[yy, xx, k]) - pair[1][k])
                         for k in range(2))
                idx = 1 if d1 < d0 else 0
                mvp[yy, xx] = idx
                mvd[yy, xx] = (mv[yy, xx, 0] - pair[idx][0],
                               mv[yy, xx, 1] - pair[idx][1])
        return merge_idx, mvp0, mvp1, mvd0, mvd1, emv0, emv1

    def _assemble_b_frame_data(self, modes, inter_map, dirs, mv0, mv1,
                               mvd0, mvd1, mvp0, mvp1, merge_idx, lv_y,
                               lv_cb, lv_cr):
        """FrameData of a fixed-grid B frame: the P frame's fields (mv0
        as L0), then the directions, the L1 motion field and each list's
        AMVP signalling at the CU marker cells."""
        c8 = self.cu // 8
        fd = self._assemble_p_frame_data(modes, inter_map, mv0, merge_idx,
                                         mvp0, mvd0, lv_y, lv_cb, lv_cr)
        fd.dir8[:] = np.kron(dirs.astype(np.uint8),
                             np.ones((c8, c8), np.uint8))
        fd.mv8_l1[:] = np.kron(mv1, np.ones((c8, c8, 1), np.int32)) \
            .reshape(fd.mv8_l1.shape)
        use_amvp = inter_map & (merge_idx < 0)
        fd.mvp8_l1[::c8, ::c8] = np.where(use_amvp, mvp1, 0)
        fd.mvd8_l1[::c8, ::c8] = np.where(use_amvp[..., None], mvd1, 0)
        return fd

    def encode_b_frame(self, y, cb, cr, poc: int, ref0, ref1, qp=None,
                       qp_factor=None, nal_type=None):
        """B frame against one past and one future reference: ref0 /
        ref1 = (ref_poc, (y, cb, cr) device planes).  qp / qp_factor: the
        GOP layer's QP and lambda factor, taken by variable trees (a
        fixed grid takes its QP from the frame encoder's config);
        nal_type: RASL_R for the leading pictures of an open-GOP CRA
        (variable trees).  Returns (FrameResult, the recon planes on the
        device: the reference picture this frame leaves)."""
        if var_inter(self.cfg):
            return self.encode_frame_var_b(y, cb, cr, poc, ref0, ref1,
                                           qp=qp, qp_factor=qp_factor,
                                           nal_type=nal_type)
        (poc0, r0), (poc1, r1) = ref0, ref1
        ys, cbs, crs = (None if a is None else a[0] for a in
                        self._upload(self.host_pack_sources([(y, cb, cr)])))
        modes, inter_map, dirs, mv0, mv1, levels, recs, sses = \
            self._b_from_planes(ys, cbs, crs, r0, r1)

        def host(t):
            return None if t is None else t.cpu().numpy()

        inter_map, dirs, mv0, mv1 = (host(t) for t in (inter_map, dirs,
                                                       mv0, mv1))
        merge_idx, mvp0, mvp1, mvd0, mvd1, emv0, emv1 = self._merge_amvp_b(
            inter_map, dirs, mv0, mv1, poc, (poc0, poc1))
        fd = self._assemble_b_frame_data(
            host(modes), inter_map, dirs, emv0, emv1, mvd0, mvd1, mvp0,
            mvp1, merge_idx, *(host(lv) for lv in levels))
        rec_np = tuple(host_pixels(r) for r in recs)
        nal = self._with_hash(self._serialize_b(fd, poc, poc - poc0,
                                                poc1 - poc), rec_np)
        return FrameResult(nals=nal, recon_y=rec_np[0], recon_cb=rec_np[1],
                           recon_cr=rec_np[2], frame_data=fd,
                           bits=len(nal) * 8,
                           sse=tuple(float(v) for v in sses.host()[0])), recs


class IntraFrameEncoder(PFrameMixin):
    """Encodes I frames (batched on the fixed grid, one at a time with
    variable CU trees) and fixed-grid P frames of one geometry / config
    on ``device`` (the name follows the JAX package's class)."""

    def __init__(self, cfg: Config, device):
        cfg.validate()
        missing = unsupported(cfg)
        if missing:
            raise NotImplementedError(
                "kvazaar_tpu_torch does not cover: " + ", ".join(missing))
        self.cfg = cfg
        self.device = torch.device(device)
        self.chroma = cfg.chroma_format == 420
        self.var = var_tree(cfg)
        # The working grid: a variable tree schedules its own per-size
        # plans and reconstructs 64x64 CUs as 32x32 TBs, so it pads to
        # 32 at most; the fixed grid's plan is the CU grid, which also
        # carries the P frames of a variable-tree config.  cu 4 is the
        # intra-NxN point: 8x8 CUs coded PART_NxN, four 4x4 luma PUs /
        # TBs (DST-VII) on a plan of 4x4 blocks, and one 4x4 TB per
        # chroma plane on the cu 8 plan (plan_c); the frame pads to 8.
        self.cu = min(cfg.intra_max_cu, 32)
        self.bitdepth = cfg.input_bitdepth
        self.pix = pix_dtype(self.bitdepth)
        pad = max(self.cu, 8)
        self.coded_w = -(-cfg.width // pad) * pad
        self.coded_h = -(-cfg.height // pad) * pad
        # Tiles (uniform spacing) make the plan's decode order
        # tile-major and cut availability at tile boundaries.
        self.tiles = (cfg.tiles_x, cfg.tiles_y)
        self.plan_c = None
        if self.cu == 4:
            self.plan = make_intra_plan(self.coded_w, self.coded_h, 4,
                                        chroma=False)
            if self.chroma:
                self.plan_c = make_intra_plan(self.coded_w, self.coded_h,
                                              8, True)
        else:
            self.plan = make_intra_plan(self.coded_w, self.coded_h,
                                        self.cu, self.chroma,
                                        tiles=self.tiles)
        if cfg.lossless:
            # Deblocking would change the bypassed samples; as in the JAX
            # package (and the reference's --lossless), the encoder turns
            # it off in the config it was given.
            cfg.deblock = False
        # Scaling lists: the spec's defaults (the SPS signals them) or a
        # cqmfile's (coded in the SPS's scaling_list_data()).
        self.scaling = None
        sl_mode, sl_custom = 0, None
        if cfg.scaling_list == "custom":
            self.scaling = parse_cqmfile(cfg.cqmfile)
            sl_mode, sl_custom = 1, (self.scaling.custom, self.scaling.dc)
        elif cfg.scaling_list == "default":
            self.scaling = ScalingLists("default")
            sl_mode = 2
        self.params = StreamParams(
            width=self.coded_w, height=self.coded_h,
            bitdepth=self.bitdepth,
            chroma_format_idc=1 if self.chroma else 0,
            qp=cfg.qp,
            deblock_enabled=cfg.deblock,
            sao_enabled=cfg.sao,
            transquant_bypass=cfg.lossless,
            implicit_rdpcm=cfg.implicit_rdpcm,
            transform_skip=cfg.transform_skip,
            max_tr_depth_intra=cfg.tr_depth_intra,
            source_scan_type=cfg.source_scan_type,
            sign_hiding=cfg.signhide and not cfg.lossless,
            wpp=cfg.wpp,
            conf_win=(0, self.coded_w - cfg.width, 0,
                      self.coded_h - cfg.height),
            scaling_list_mode=sl_mode,
            scaling_custom=sl_custom,
            tmvp_enabled=cfg.tmvp,
            amp=cfg.amp,
            tiles=self.tiles,
            framerate=(cfg.framerate_num, cfg.framerate_denom),
            sar=(cfg.sar_width, cfg.sar_height),
            overscan=cfg.overscan, videoformat=cfg.videoformat,
            fullrange=cfg.fullrange, colorprim=cfg.colorprim,
            transfer=cfg.transfer, colormatrix=cfg.colormatrix,
            chroma_loc=cfg.chromaloc,
            tier=1 if cfg.tier == "high" else 0,
            cu_qp_delta=cfg.cu_qp_delta_active,
            slices=cfg.slices,
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
        # (nal_type, poc) of the I picture being coded: an open-GOP CRA
        # overrides the IDR at POC 0 (encode_frame).
        self._islice = None

    def headers(self) -> bytes:
        return (write_vps(self.params) + write_sps(self.params)
                + write_pps(self.params))

    def set_base_qp(self, qp: int) -> None:
        """Re-point the encoder at base QP qp: the config, the PPS
        init_qp, the chroma QP and the search lambda (every device stage
        takes QP and lambdas per call, so no cached table depends on
        them).  As in the JAX package, the fixed grid's P-frame motion
        lambda keeps its value from construction: the call serves the
        variable-tree operating points of a BD-rate ladder.  With a
        scaling list it raises: the JAX package's scaling-list programs
        keep the QP they were compiled at, so its stream then decodes to
        another picture than its recon (ROADMAP §3, F5)."""
        if self.scaling is not None:
            raise NotImplementedError(
                "set_base_qp with scaling lists (the JAX package's streams "
                "do not decode to their recon there, ROADMAP F5)")
        self.cfg = dataclasses.replace(self.cfg, qp=qp)
        self.params.qp = qp
        self.qp_c = chroma_qp(qp)
        self.lambda_satd = math.sqrt(qp_to_lambda(qp))

    def _encode_from_planes(self, ys, cbs, crs, qp_ctu=None):
        """Device program for a (B, H, W) batch: returns (modes uint8
        (B, By, Bx), levels int16 (y, cb, cr), recon uint8/int16 (y, cb, cr),
        FrameSse), all on the encoder's device.  qp_ctu: a
        one-frame batch's (1, Cy, Cx) per-CTU QP on the device: the
        search stays at the config's QP, the reconstruction takes each
        block's QP and deblocking the effective map.  --rd 2 re-ranks
        the modes by a roundtrip at the config's QP; --rd 3 adds the
        chroma-mode search (cmodes (B, By, Bx) uint8, else None).  At
        the intra-NxN point (cu 4) luma and chroma reconstruct apart and,
        with transform skip, the last entry holds each 4x4 TB's decision
        ((B, By, Bx) uint8, else None)."""
        cfg = self.cfg
        lam = qp_to_lambda(cfg.qp)
        modes = torch.stack([
            search_frame_modes(y, self.plan, self.lambda_satd,
                               self.bitdepth, cfg.rd >= 1,
                               rdo=cfg.rd >= 2, qp=cfg.qp, lam_rd=lam)[0]
            for y in ys])
        if self.cu == 4:
            return self._encode_nxn(ys, cbs, crs, modes)
        cmodes = None
        if cfg.rd >= 3 and cbs is not None:
            cmodes = torch.stack([
                search_chroma_modes(cb, cr, m, self.plan, self.qp_c, lam,
                                    self.bitdepth)
                for cb, cr, m in zip(cbs, crs, modes)])
        (rec_y, lv_y, rec_cb, lv_cb, rec_cr,
         lv_cr) = reconstruct_frames(
             ys, cbs, crs, modes, self.plan, cfg.qp, self.qp_c,
             self.bitdepth,
             qp_map=None if qp_ctu is None else self._qp_blk_of(qp_ctu),
             rdpcm=cfg.implicit_rdpcm, cmodes=cmodes, **self._recon_tools())
        recs, sses = self._deblock_sse(
            (ys, cbs, crs), (rec_y, rec_cb, rec_cr),
            qp_map=self._deblock_qp_map(qp_ctu, (lv_y, lv_cb, lv_cr)))
        sao = None
        if self.cfg.sao:
            recs, sao = self._sao_stage((ys, cbs, crs), recs)
        return (modes.to(torch.uint8), (lv_y, lv_cb, lv_cr), recs, sses, sao,
                None if cmodes is None else cmodes.to(torch.uint8), None)

    def _encode_nxn(self, ys, cbs, crs, modes):
        """The rest of ``_encode_from_planes`` at the intra-NxN point:
        luma on the plan of 4x4 blocks (DST-VII, and the transform-skip
        decision per TB with --transform-skip), chroma on the cu 8 plan
        with each CU's first PU's mode (DM), deblocking on the 8x8 CU
        grid (the 4x4 TB edges are off the 8x8 edge grid, 8.7.2)."""
        tools = self._recon_tools()
        out = reconstruct_frames(ys, None, None, modes, self.plan,
                                 self.cfg.qp, self.qp_c, self.bitdepth,
                                 tskip=self.cfg.transform_skip, **tools)
        rec_y, lv_y = out[:2]
        ts = out[6].reshape(modes.shape).to(torch.uint8) \
            if self.cfg.transform_skip else None
        rec_cb = lv_cb = rec_cr = lv_cr = None
        if cbs is not None:
            rec_cb, lv_cb, rec_cr, lv_cr = reconstruct_chroma_frames(
                cbs, crs, modes[:, ::2, ::2].contiguous(), self.plan_c,
                self.qp_c, self.bitdepth, **tools)
        recs, sses = self._deblock_sse((ys, cbs, crs),
                                       (rec_y, rec_cb, rec_cr))
        sao = None
        if self.cfg.sao:
            recs, sao = self._sao_stage((ys, cbs, crs), recs)
        return (modes.to(torch.uint8), (lv_y, lv_cb, lv_cr), recs, sses, sao,
                None, ts)

    def _sao_stage(self, srcs, recs, lam=None):
        """SAO of a (B, H, W) batch on the device: per-CTU statistics of
        the deblocked reconstruction against the source, the decision
        (each CTU's own choice, then the merge wavefront) and the
        filter, at lambda lam (default the config QP's; a GOP layer
        passes its own).  Under tiles the statistics come to the host
        (one download each) for the JAX package's host decision, whose
        merges stop at tile boundaries (``_sao_decide_tiles``).  Returns
        (the filtered recon uint8 (y, cb, cr), the packed parameters
        int32 (B, Cy, Cx, 20): merge, type (luma, chroma), edge class
        (luma, chroma), band position (y, cb, cr), offsets (y, cb, cr)
        x 4)."""
        ys, cbs, crs = srcs
        ry, rcb, rcr = recs
        bd = self.bitdepth
        lam = qp_to_lambda(self.cfg.qp) if lam is None else lam
        stats_c = None
        if cbs is not None:
            stats_c = (sao_stats(cbs, rcb, 32, bd),
                       sao_stats(crs, rcr, 32, bd))
        stats_y = sao_stats(ys, ry, 64, bd)
        decide = (self._sao_decide_tiles if self.params.tiles_enabled
                  else sao_decide_frame_device)
        p = decide(stats_y, stats_c, lam)
        t, eo, bp, off = p["type"], p["eo"], p["bp"], p["off"]
        ry = apply_sao_plane(ry, t[..., 0], eo[..., 0], bp[..., 0],
                             off[..., 0, :], 64, bd)
        if cbs is not None:
            rcb = apply_sao_plane(rcb, t[..., 1], eo[..., 1], bp[..., 1],
                                  off[..., 1, :], 32, bd)
            rcr = apply_sao_plane(rcr, t[..., 1], eo[..., 1], bp[..., 2],
                                  off[..., 2, :], 32, bd)
        packed = torch.cat([p["merge"][..., None], t, eo, bp,
                            off.flatten(-2)], dim=-1)
        return (ry, rcb, rcr), packed

    def _sao_decide_tiles(self, stats_y, stats_c, lam):
        """The host SAO decision of a tiled batch (the JAX package's
        ``sao_decide_frame`` per frame, with each CTU's tile column and
        row from the plan's bounds), in ``sao_decide_frame_device``'s
        form: the device statistics come down once per tensor, the
        parameters go back up in one int32 tensor."""
        def host(stats):
            return [a.cpu().numpy() for a in stats]

        s_y = host(stats_y)
        s_c = None if stats_c is None else (host(stats_c[0]),
                                            host(stats_c[1]))
        tcol = np.searchsorted(self.plan.tile_col_bounds[1:],
                               np.arange(self.params.width_in_ctus), "right")
        trow = np.searchsorted(self.plan.tile_row_bounds[1:],
                               np.arange(self.params.height_in_ctus),
                               "right")
        out = []
        for i in range(s_y[0].shape[0]):
            st_c = None if s_c is None else tuple(
                [a[i] for a in c] for c in s_c)
            d = sao_decide_frame([a[i] for a in s_y], st_c, lam,
                                 tile_col=tcol, tile_row=trow)
            out.append(np.concatenate(
                [d["merge"][..., None], d["type"], d["eo"], d["bp"],
                 d["off"].reshape(*d["off"].shape[:2], 12)],
                axis=-1).astype(np.int32))
        packed = torch.from_numpy(np.stack(out)).to(stats_y[0].device)
        return dict(merge=packed[..., 0], type=packed[..., 1:3],
                    eo=packed[..., 3:5], bp=packed[..., 5:8],
                    off=packed[..., 8:20].unflatten(-1, (3, 4)))

    def _deblock_sse(self, srcs, recs, bs=None, qp_map=None, grid=None):
        """Deblock a (B, H, W) batch of reconstructions (bs: the (bs_v,
        bs_h) maps of a P frame on the edge grid ``grid``, by default the
        CU grid, None = all-intra; qp_map: a one-frame batch's (By, Bx)
        per-block QP, None = the config's QP) and take
        each frame's SSE against its source.  Returns (recon uint8/int16 (y,
        cb, cr), the SSEs as an ops.sse.FrameSse, whose ``host()`` gives
        them as (B, 3) float32 in the JAX package's summation order)."""
        ys, cbs, crs = srcs
        rec_y, rec_cb, rec_cr = recs
        if self.cfg.deblock:
            # In-loop filter as a batched post-pass: intra prediction
            # reads unfiltered samples, so deblocking never feeds the
            # wavefront.
            bs_v, bs_h = (None, None) if bs is None else bs
            dy, dcb, dcr = deblock_frame(rec_y, rec_cb, rec_cr,
                                         self.cfg.qp,
                                         grid or max(self.cu, 8),
                                         self.bitdepth, bs_v=bs_v,
                                         bs_h=bs_h, qp_map=qp_map)
            rec_y = dy.to(self.pix)
            if rec_cb is not None:
                rec_cb = dcb.to(self.pix)
                rec_cr = dcr.to(self.pix)

        # Distortion over the conformance window only: padded rows and
        # columns reconstruct near-perfectly and would inflate PSNR.
        tw, th = self.cfg.width, self.cfg.height

        def sse(a, b):
            if b is None:
                return None
            f = a.shape[1] * 2 // self.coded_h     # 2=luma, 1=chroma
            return PlaneSse(a, b, th * f // 2, tw * f // 2)

        return (rec_y, rec_cb, rec_cr), FrameSse(
            [sse(rec_y, ys), sse(rec_cb, cbs), sse(rec_cr, crs)])

    def host_pack_sources(self, frames):
        """(y, cb, cr) list -> padded (B, H, W) host planes: uint8 at
        8-bit, uint16 above."""
        s = max(self.cu, 8)
        sdt = np.uint8 if self.bitdepth <= 8 else np.uint16
        if self.bitdepth <= 8 and any(
                np.asarray(p).dtype == np.uint16 for f in frames
                for p in f if p is not None):
            raise ValueError("uint16 pictures need input_bitdepth=10 (the "
                             "encoder is 8-bit)")
        ys = np.stack([pad_to_multiple(np.asarray(f[0], sdt), s)
                       for f in frames])
        cbs = crs = None
        if self.chroma:
            cbs = np.stack([pad_to_multiple(np.asarray(f[1], sdt),
                                            s // 2) for f in frames])
            crs = np.stack([pad_to_multiple(np.asarray(f[2], sdt),
                                            s // 2) for f in frames])
        return ys, cbs, crs

    def _upload(self, planes):
        """Host (B, H, W) uint8 or uint16 planes -> int32 tensors on the
        device (uint16 crosses as int16: torch has no uint16 copies,
        and samples below 2^15 keep their value)."""
        return tuple(None if a is None else
                     torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16
                                      else a).to(self.device).to(torch.int32)
                     for a in planes)

    def submit_frames(self, frames):
        """Upload a batch of I frames and queue its device program
        (asynchronous on a card); pair with download_frames +
        finalize_downloaded.  The batch's last reconstruction becomes
        the DPB.  Fixed grid only: a variable tree is planned on the
        host between the search and the reconstruction."""
        if self.var:
            raise NotImplementedError("variable CU trees encode one frame "
                                      "at a time (encode_frame)")
        ys, cbs, crs = self._upload(self.host_pack_sources(frames))
        out = self._encode_from_planes(ys, cbs, crs)
        self._dpb = tuple(None if r is None else r[-1] for r in out[2])
        return len(frames), out

    def download_frames(self, handle, need_recon: bool = True):
        """The device->host copies of a submitted batch (one per
        tensor); safe to call from a worker thread."""
        nframes, (modes, levels, recs, sses, sao, cmodes, ts) = handle

        def host(t):
            return None if t is None else t.cpu().numpy()

        want_pixels = need_recon or self.cfg.hash != "none"
        return (nframes, host(modes), [host(lv) for lv in levels],
                [host_pixels(r) for r in recs] if want_pixels
                else [None, None, None], sses.host(), host(sao),
                host(cmodes), host(ts))

    def finalize_downloaded(self, downloaded) -> list[FrameResult]:
        """Host CABAC + NAL framing of a downloaded batch, one frame per
        pool task (the native CABAC releases the GIL)."""
        nframes, modes, (lv_y, lv_cb, lv_cr), (rec_y, rec_cb, rec_cr), \
            sses, sao, cmodes, ts = downloaded
        if self._host_pool is None:
            self._host_pool = cf.ThreadPoolExecutor(
                max_workers=self.cfg.threads or 8)

        def pick(a, i):
            return None if a is None else a[i]

        futs = [self._host_pool.submit(
            self._host_finalize, modes[i], lv_y[i], pick(lv_cb, i),
            pick(lv_cr, i), pick(rec_y, i), pick(rec_cb, i),
            pick(rec_cr, i), pick(sao, i), cmodes=pick(cmodes, i),
            ts_y=pick(ts, i))
            for i in range(nframes)]
        out = [f.result() for f in futs]
        for i, r in enumerate(out):
            r.sse = tuple(float(v) for v in sses[i])
        return out

    def _host_finalize(self, modes, lv_y, lv_cb, lv_cr, rec_y, rec_cb,
                       rec_cr, sao=None, qp_ctu=None,
                       cmodes=None, ts_y=None) -> FrameResult:
        s = self.cu
        fd = FrameData.empty(self.coded_w, self.coded_h, self.chroma)
        if qp_ctu is not None:
            fd.qp_ctu = np.asarray(qp_ctu, np.int32).copy()
        if cmodes is not None:
            # --rd 3 explicit chroma modes, CU grid -> 8x8 cell grid.
            fd.cmode4[:] = np.kron(cmodes.astype(np.uint8),
                                   np.ones((s // 8, s // 8), np.uint8))
        # The intra-NxN point: 8x8 CUs coded PART_NxN (a mode and a
        # transform-skip flag per 4x4 PU / TB), chroma from the cu 8 plan.
        plan_c, sc = (self.plan_c, 4) if s == 4 else (self.plan, s // 2)
        fd.depth8[:] = 3 if s == 4 else 6 - int(math.log2(s))
        if s == 4:
            fd.nxn8[:] = 1
            if ts_y is not None:
                fd.tskip4[:] = ts_y
        fd.mode4[:] = np.kron(modes, np.ones((max(s // 4, 1),) * 2, np.uint8))
        fd.coeff_y[:] = blocks_to_plane(lv_y, self.plan, s, self.coded_w,
                                        self.coded_h)
        if self.chroma:
            fd.coeff_cb[:] = blocks_to_plane(lv_cb, plan_c, sc,
                                             self.coded_w // 2,
                                             self.coded_h // 2)
            fd.coeff_cr[:] = blocks_to_plane(lv_cr, plan_c, sc,
                                             self.coded_w // 2,
                                             self.coded_h // 2)
        _set_sao(fd, sao)
        return self._serialize_i(fd, rec_y, rec_cb, rec_cr)

    def _serialize_i(self, fd, rec_y, rec_cb, rec_cr) -> FrameResult:
        """I slice NAL of one I frame's FrameData (an IDR at POC 0, or
        the open-GOP CRA that encode_frame names): native CABAC (WPP
        substreams) where ``_native_cabac``, else the Python serializer
        (one NAL per slice segment under --slices); then the slice
        header and the picture hash SEI."""
        nal_type, poc = self._islice or (NAL_IDR_W_RADL, 0)
        if self.params.slices != "none":
            nal = self._slice_nals(fd, SLICE_I, nal_type,
                                   dict(poc=poc, ref_list_l0=[]))
        else:
            # Slice data first (entry-point offsets go into the header).
            sizes = []
            if not self._native_cabac():
                data, sizes = self._python_slice_data(fd, SLICE_I,
                                                      self.cfg.qp)
            elif self.params.wpp:
                data, sizes = native.encode_slice_data_native_wpp(
                    self.params, fd, self.cfg.qp)
            else:
                data = native.encode_slice_data_native(self.params, fd,
                                                       self.cfg.qp)
            w = BitWriter()
            write_slice_header(w, self.params, SLICE_I, nal_type,
                               self.cfg.qp, poc=poc, ref_list_l0=[],
                               num_entry_points=max(len(sizes) - 1, 0),
                               entry_point_offsets=sizes[:-1])
            nal = nal_unit(w.get_bytes() + data, nal_type)
        if rec_y is not None:
            nal = self._with_hash(nal, (rec_y, rec_cb, rec_cr))
        return FrameResult(nals=nal, recon_y=rec_y, recon_cb=rec_cb,
                           recon_cr=rec_cr, frame_data=fd,
                           bits=len(nal) * 8)

    # ---- Variable-CU quadtree path (encoder/quadtree.py) ----

    def var_search(self, yp: torch.Tensor):
        """Device search at every candidate CU size of the (H, W) int32
        source luma: (costs, modes) dicts size -> grids, on the device,
        and with --tr-depth-intra the TU-split costs (tucosts) third."""
        cfg = self.cfg
        return search_quadtree(
            yp, self.coded_w, self.coded_h, self.lambda_satd, self.bitdepth,
            cfg.intra_min_cu, cfg.intra_max_cu, cfg.rd >= 1,
            rdo=cfg.rd >= 2, qp=cfg.qp, lam_rd=qp_to_lambda(cfg.qp),
            tu_split=cfg.tr_depth_intra > 0)

    def var_tree_plan(self, costs, modes, tucosts=None, chroma_planes=None):
        """Host stage: the tree argmin and its wavefront plan.  Returns
        (size8 (H/8, W/8) true CU sizes, sched_size8 (64 CUs as four
        32 entries), mode_maps size -> (H/s, W/s) numpy modes, VarPlan,
        cmode_maps).  chroma_planes: the (H/2, W/2) source Cb and Cr
        planes on the device, from which --rd 3 searches the chroma
        modes that schedule the chroma classes (cmode_maps, size -> grid,
        ``var_chroma_modes``; None below rd 3, without chroma or without
        chroma_planes).  tucosts (--tr-depth-intra, from ``var_search``):
        each 16 / 32 CU also competes as four half-size TBs; a split CU
        is scheduled as those TBs, carrying its luma (and chroma) mode
        into the half size's map, and sched_size8 holds the TB sizes
        (the deblocking's TU edges).  The sixth entry is then trsplit8
        (H/8, W/8) uint8, the split flags of the CUs."""
        costs = {k: v.cpu().numpy() for k, v in costs.items()}
        mode_maps = {k: v.cpu().numpy() for k, v in modes.items()}
        chosen = choose_tree(
            costs, self.coded_w, self.coded_h, qp_to_lambda(self.cfg.qp),
            percu_bits=0.0, split_bits=SPLIT_FLAG_BINS,
            tucosts=None if tucosts is None else {
                k: v.cpu().numpy() for k, v in tucosts.items()})
        size8, trsplit8 = chosen if tucosts is not None else (chosen, None)
        sched_size8, mode_maps = _sched_sizes(size8, mode_maps)
        splits = []
        if trsplit8 is not None and trsplit8.any():
            tmask = trsplit8.astype(bool)
            sched_size8 = np.where(tmask, sched_size8 // 2,
                                   sched_size8).astype(size8.dtype)
            splits = [(s, (size8 == s) & tmask) for s in (32, 16)
                      if ((size8 == s) & tmask).any()]
            for s, msk in splits:
                mode_maps = _patch_children(mode_maps, msk, s)
        cmode_maps = None
        if chroma_planes is not None and self.cfg.rd >= 3 and self.chroma:
            cmode_maps = self.var_chroma_modes(mode_maps, *chroma_planes)
            for s, msk in splits:
                if s in cmode_maps and s // 2 in cmode_maps:
                    cmode_maps = _patch_children(cmode_maps, msk, s)
        vp = build_var_plan(sched_size8, mode_maps, self.coded_w,
                            self.coded_h, self.chroma,
                            cmode_maps=cmode_maps)
        out = (size8, sched_size8, mode_maps, vp, cmode_maps)
        return out if tucosts is None else out + (trsplit8,)

    def var_chroma_modes(self, mode_maps, cbp, crp) -> dict:
        """--rd 3 on a variable tree: ``search_chroma_modes`` on each
        size's fixed grid (the device (H/2, W/2) planes cbp / crp, each
        size's luma modes of mode_maps).  Trees reach 32x32 CUs here:
        ``unsupported`` refuses rd 3 with 64x64 ones (ROADMAP §3, F3).
        Returns size -> (H/s, W/s) numpy chroma modes."""
        return {s: search_chroma_modes(
            cbp, crp, torch.from_numpy(np.ascontiguousarray(
                mode_maps[s], np.int32)).to(self.device),
            make_intra_plan(self.coded_w, self.coded_h, s, chroma=True),
            self.qp_c, qp_to_lambda(self.cfg.qp), self.bitdepth).cpu().numpy()
            for s in sorted(mode_maps)}

    def var_sched_arrays(self, vp, planes, sched_size8) -> dict:
        """The schedule reconstruct_frame_var reads, on the device: per
        class its compact slot tensors over the plan's real steps (the
        slot counts stay on the host), the source planes, the deblocking
        bS maps of an I tree and, for a P tree's plan, the direct pass's
        inter CUs per size."""
        n = max(vp.n_steps_real, 1)
        dev = self.device

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        sched = {"luma": {}, "chroma": {}, "counts": {}, "n_real": n}
        kinds = [("luma", vp.luma)] + ([("chroma", vp.chroma)]
                                       if self.chroma else [])
        for kind, classes in kinds:
            for s, cs in classes.items():
                counts = cs.valid[:n].sum(axis=1)
                # reconstruct_frame_var runs a step's first counts[t]
                # slots: the plan fills each step's slots from 0.
                if not np.array_equal(cs.valid[:n], np.arange(
                        cs.valid.shape[1])[None] < counts[:, None]):
                    raise RuntimeError("var plan: slots not packed")
                sched["counts"][(kind, s)] = counts
                sched[kind][s] = {
                    "x0": up(cs.x0[:n]), "y0": up(cs.y0[:n]),
                    "avail": up(cs.avail[:n]),
                    "corner_h": up(cs.corner_h[:n]),
                    "modes": up(cs.modes[:n])}
        sched["plane_y"], sched["plane_cb"], sched["plane_cr"] = planes
        # P trees: each size's inter CUs as one exact batch (x0, y0) for
        # the direct pass, luma and chroma.
        for kind, batches in (("iluma", vp.iluma), ("ichroma", vp.ichroma)):
            if batches is not None:
                sched[kind] = {s: (up(d["x0"][d["valid"]]),
                                   up(d["y0"][d["valid"]]))
                               for s, d in batches.items()}
        # Deblocking bS on the 8x8 cell grid: intra edges (bS 2) exactly
        # at CU/TU boundaries (a 64 CU's forced 32x32 TUs are TU
        # boundaries, 8.7.2; sched_size8 caps at 32).
        c = np.minimum((sched_size8 // 8).astype(np.int32), 4)
        x8 = np.arange(sched_size8.shape[1])[None, :]
        y8 = np.arange(sched_size8.shape[0])[:, None]
        sched["bs_v"] = up(np.where(x8 % c == 0, 2, 0).astype(np.int32))
        sched["bs_h"] = up(np.where(y8 % c == 0, 2, 0).astype(np.int32))
        return sched

    def var_recon(self, sched):
        """Device reconstruction + deblocking of a planned tree: returns
        (recon uint8/int16 (y, cb, cr), levels int16 (y, cb, cr)) planes."""
        cfg = self.cfg
        recs, levels = reconstruct_frame_var(
            sched, cfg.qp, self.qp_c, self.coded_w, self.coded_h,
            self.chroma, self.bitdepth, signhide=cfg.signhide,
            rdoq=cfg.rdoq, lam=qp_to_lambda(cfg.qp), lossless=cfg.lossless,
            scaling=self.scaling)
        return self.var_deblock(sched, recs), levels

    def var_deblock(self, sched, recs):
        ry, rcb, rcr = recs
        if self.cfg.deblock:
            ry, rcb, rcr = deblock_frame(ry, rcb, rcr, self.cfg.qp, 8,
                                         self.bitdepth, bs_v=sched["bs_v"],
                                         bs_h=sched["bs_h"])
        return tuple(None if r is None else r.to(self.pix)
                     for r in (ry, rcb, rcr))

    def var_sao(self, planes, recs, lam=None):
        """SAO of one frame (see ``_sao_stage``, lambda lam): planes /
        recs are the (H, W) source and deblocked planes; returns
        (filtered recon, packed parameters (Cy, Cx, 20))."""
        def one(t):
            return None if t is None else t[None]

        recs, packed = self._sao_stage(tuple(one(p) for p in planes),
                                       tuple(one(r) for r in recs), lam)
        return tuple(None if r is None else r[0] for r in recs), packed[0]

    def var_frame_data(self, size8, sched_size8, mode_maps,
                       levels, cmode_maps=None) -> FrameData:
        """Host assembly: depth/mode grids, the --rd 3 chroma modes
        (cmode_maps, size -> grid) + the coefficient planes (levels:
        numpy (y, cb, cr) pixel-layout planes)."""
        fd = FrameData.empty(self.coded_w, self.coded_h, self.chroma)
        # depth = 6 - log2(size): 64->0, 32->1, 16->2, 8->3.
        fd.depth8[:] = (6 - np.round(np.log2(size8)).astype(np.int32)
                        ).astype(np.uint8)
        size4 = np.kron(sched_size8, np.ones((2, 2), np.uint8))
        mode4 = np.zeros_like(size4, np.uint8)
        for s, grid in mode_maps.items():
            if s > 32:
                continue        # 64 modes ride the patched 32 grid
            up = np.kron(grid.astype(np.uint8),
                         np.ones((s // 4, s // 4), np.uint8))
            mode4 = np.where(size4 == s, up[:size4.shape[0],
                                            :size4.shape[1]], mode4)
        fd.mode4[:] = mode4
        if cmode_maps is not None:
            cm8 = np.full(fd.cmode4.shape, 255, np.uint8)
            for s, grid in cmode_maps.items():
                up = np.kron(grid.astype(np.uint8),
                             np.ones((s // 8, s // 8), np.uint8))
                cm8 = np.where(sched_size8 == s,
                               up[:cm8.shape[0], :cm8.shape[1]], cm8)
            fd.cmode4[:] = cm8
        fd.coeff_y[:] = levels[0]
        if self.chroma:
            fd.coeff_cb[:] = levels[1]
            fd.coeff_cr[:] = levels[2]
        return fd

    def encode_frame_var(self, y, cb=None, cr=None) -> FrameResult:
        """Quadtree all-intra encode: device search at every size, host
        tree argmin and wavefront plan, device reconstruction and
        deblocking, host CABAC."""
        planes = tuple(None if a is None else a[0] for a in self._upload(
            self.host_pack_sources([(y, cb, cr)])))
        size8, sched_size8, mode_maps, vp, cmode_maps, *trsplit8 = \
            self.var_tree_plan(*self.var_search(planes[0]),
                               chroma_planes=planes[1:])
        recs, levels = self.var_recon(self.var_sched_arrays(vp, planes,
                                                            sched_size8))
        sao = None
        if self.cfg.sao:
            recs, sao = self.var_sao(planes, recs)
        self._dpb = recs

        def host(t):
            return None if t is None else t.cpu().numpy()

        rec_np = [host_pixels(r) for r in recs]
        fd = self.var_frame_data(size8, sched_size8, mode_maps,
                                 [host(lv) for lv in levels], cmode_maps)
        if trsplit8:
            fd.trsplit8[:] = trsplit8[0]
        _set_sao(fd, host(sao))
        return self._serialize_i(fd, *rec_np)

    # ---- Variable-CU P and B frames (one reference per list) ----

    def _var_frame_qp_lam(self, qp=None, qp_factor=None,
                          slice_type: int = SLICE_P):
        """(frame_qp, lam_rd, lam_satd) of a variable-tree P or B frame:
        with neither qp nor qp_factor the config's QP, its I-frame lambda
        and the search lambda; a GOP layer's QP and factor take the
        per-picture lambda of ``frame_lambda`` and its square root."""
        if qp is None and qp_factor is None:
            return self.cfg.qp, qp_to_lambda(self.cfg.qp), self.lambda_satd
        frame_qp = self.cfg.qp if qp is None else int(qp)
        if self.scaling is not None and frame_qp != self.cfg.qp:
            # As in the JAX package, whose scaling-list programs bake the
            # QP in: a layer QP takes a frame encoder of its own.
            raise ValueError("per-frame qp override requires scaling=None")
        lam = frame_lambda(frame_qp, slice_type, gop_len=self.cfg.gop_len,
                           intra_period=self.cfg.intra_period,
                           qp_factor=qp_factor, keyframe=False)
        return frame_qp, lam, math.sqrt(lam)

    def var_p_search(self, yp: torch.Tensor, ref_y: torch.Tensor, ql=None):
        """Device search of a P tree at every candidate CU size of the
        (H, W) int32 source luma against the reference luma, at ql =
        (frame_qp, lam_rd, lam_satd) (default: ``_var_frame_qp_lam()``):
        (costs, modes, mvs, inter maps) dicts size -> grids, on the
        device."""
        cfg = self.cfg
        qp, lam_rd, lam_satd = ql or self._var_frame_qp_lam()
        return search_quadtree_p(
            yp, ref_y, self.coded_w, self.coded_h, lam_satd, cfg.me_range,
            self.bitdepth, (cfg.intra_min_cu, cfg.intra_max_cu),
            (cfg.inter_min_cu, cfg.inter_max_cu), cfg.rd >= 1,
            subpel=cfg.me_subpel, qp=qp, lam_rd=lam_rd)

    def _inter_tree_plan(self, costs, modes, imaps, mv_grids, lam_rd,
                         extra_grids=()):
        """Host stage of an inter tree: the tree argmin over the searched
        RD costs (device dicts), the decisions expanded onto the 8x8
        cells (build_cell_fields, with extra_grids) and the wavefront
        plan of its intra CUs (inter CUs go to the direct pass).
        Returns (size8, sched_size8, mode_maps, cell fields, VarPlan)."""
        def host(d):
            return {s: v.cpu().numpy() for s, v in d.items()}

        size8 = choose_tree(host(costs), self.coded_w, self.coded_h,
                            lam_rd, percu_bits=0.0,
                            split_bits=SPLIT_FLAG_BINS)
        sched_size8, mode_maps = _sched_sizes(size8, host(modes))
        fields = build_cell_fields(size8, host(imaps), host(mv_grids),
                                   tuple(host(g) for g in extra_grids))
        vp = build_var_plan(sched_size8, mode_maps, self.coded_w,
                            self.coded_h, self.chroma, inter8_map=fields[0])
        return size8, sched_size8, mode_maps, fields, vp

    def var_p_plan(self, costs, modes, mvs, imaps, ql=None):
        """Host stage of a P tree (``_inter_tree_plan`` at ql's lam_rd).
        Returns (size8, sched_size8, mode_maps, inter8 (h8, w8) bool,
        mv_cells (h8, w8, 2) int32, VarPlan)."""
        lam_rd = (ql or self._var_frame_qp_lam())[1]
        size8, sched_size8, mode_maps, (inter8, mv_cells), vp = \
            self._inter_tree_plan(costs, modes, imaps, mvs, lam_rd)
        return size8, sched_size8, mode_maps, inter8, mv_cells, vp

    # Truncated-unary merge_idx bin counts (max_num_merge_cand 5).
    _MERGE_IDX_BITS = np.array([1.0, 2.0, 3.0, 4.0, 4.0])

    @staticmethod
    def _cu_sums(maps, cy, cx, cells):
        """Per-CU sums (K, n) of per-cell maps (K, h8, w8), from integral
        images."""
        out = np.empty((maps.shape[0], cy.size), np.int64)
        for k in range(maps.shape[0]):
            icum = _integral(maps[k])
            out[k] = (icum[cy + cells, cx + cells] - icum[cy, cx + cells]
                      - icum[cy + cells, cx] + icum[cy, cx])
        return out

    def _merge_rd_win(self, sums, lam, amvp_bits):
        """float64 merge RD of n CUs: sums (6, n) SATDs of the five merge
        candidates and of the searched motion; returns each CU's winner
        0..5 (5 = keep the searched motion)."""
        costs = np.empty((6, sums.shape[1]))
        for k in range(5):
            costs[k] = sums[k] + lam * self._MERGE_IDX_BITS[k]
        costs[5] = sums[5] + lam * amvp_bits
        return costs.argmin(axis=0)

    def merge_rd_p(self, yp, ref_y, size8, inter8, mv_cells, ql=None):
        """Merge-mode RD of a P tree: each inter CU's five merge
        candidates as MC hypotheses (one device pass of per-cell SATD
        maps) against its searched MV with its mvd rate, by SATD +
        lam_satd * bits in float64 on the host; a winning candidate's MV
        replaces the CU's (the signalling is derived again from the
        final field).  Returns the new mv_cells."""
        d = var_p_derive(size8, inter8, mv_cells)
        cy, cx, cells = d["cy"], d["cx"], d["cells"]
        if cy.size == 0:
            return mv_cells
        oy, ox = var_origin_maps(size8)
        h8, w8 = inter8.shape
        cand_cells = np.empty((5, h8, w8, 2), np.int32)
        for k in range(5):
            g = mv_cells.copy()
            g[cy, cx] = d["cands"][:, k]
            cand_cells[k] = g[oy, ox]
        maps = merge_satd_maps_p(
            yp, ref_y, torch.from_numpy(cand_cells).to(self.device),
            torch.from_numpy(mv_cells).to(self.device),
            self.bitdepth).cpu().numpy()
        mine, p0, p1 = d["mine"], d["p0"], d["p1"]
        amvp_bits = 1.0 + np.minimum(_mvd_bits_np(mine - p0).sum(axis=1),
                                     _mvd_bits_np(mine - p1).sum(axis=1))
        win = self._merge_rd_win(self._cu_sums(maps, cy, cx, cells),
                                 (ql or self._var_frame_qp_lam())[2],
                                 amvp_bits)
        upd = win < 5
        if not upd.any():
            return mv_cells
        g = mv_cells.copy()
        g[cy[upd], cx[upd]] = d["cands"][upd, win[upd]]
        return g[oy, ox]

    def var_p_sched(self, vp, planes, size8, inter8, mv_cells) -> dict:
        """var_sched_arrays of a P tree plus its motion field and the
        deblocking inputs (inter cells, TU-edge masks), on the device."""
        sched = self.var_sched_arrays(vp, planes, size8)
        del sched["bs_v"], sched["bs_h"]
        ev, eh = var_edge_masks(size8)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        sched.update(edge_v=up(ev), edge_h=up(eh), inter8=up(inter8),
                     mv_cells=up(mv_cells))
        return sched

    def var_recon_p(self, sched, refs, ql=None):
        """MC of the cell motion field from the reference planes, then
        ``_var_recon_inter``.  Returns (deblocked recon uint8/int16 (y, cb,
        cr), levels int16 (y, cb, cr))."""
        mcs = mc_planes_cells(*refs, sched["mv_cells"], self.bitdepth)
        return self._var_recon_inter(sched, mcs, ql)

    def _var_recon_inter(self, sched, mcs, ql):
        """An inter tree's reconstruction from its MC planes (direct
        inter pass, then the intra wavefront) at ql's frame QP (its
        chroma QP from Table 8-10) and RDOQ lambda lam_rd, and its
        deblocking at the frame QP with the tree's bS (the B form where
        the schedule carries mv1_cells and dirs8).  With a scaling list
        RDOQ takes the I-frame lambda of the frame encoder's QP, whatever
        the layer's lambda factor (the JAX package's scaling-list
        programs bake QP and lambda in; ROADMAP §3)."""
        cfg = self.cfg
        qp, lam_rd, _ = ql or self._var_frame_qp_lam()
        if self.scaling is not None:
            lam_rd = qp_to_lambda(cfg.qp)
        recs, levels, cbf8 = reconstruct_frame_var(
            sched, qp, chroma_qp(qp), self.coded_w, self.coded_h,
            self.chroma, self.bitdepth, signhide=cfg.signhide,
            rdoq=cfg.rdoq, lam=lam_rd, mc_planes=mcs, lossless=cfg.lossless,
            scaling=self.scaling)
        ry, rcb, rcr = recs
        if cfg.deblock:
            bs_v, bs_h = var_bs_maps(sched["inter8"], cbf8,
                                     sched["mv_cells"], sched["edge_v"],
                                     sched["edge_h"],
                                     mv1_cells=sched.get("mv1_cells"),
                                     dirs8=sched.get("dirs8"))
            ry, rcb, rcr = deblock_frame(ry, rcb, rcr, qp, 8, self.bitdepth,
                                         bs_v=bs_v, bs_h=bs_h)
        return tuple(None if r is None else r.to(self.pix)
                     for r in (ry, rcb, rcr)), levels

    def var_p_frame_data(self, size8, sched_size8, mode_maps, inter8,
                         mv_cells, levels) -> FrameData:
        """Host assembly of a P tree's FrameData: the var_frame_data
        fields, the motion field, merge/AMVP signalling and skip flags
        (levels: numpy (y, cb, cr) planes)."""
        fd = self.var_frame_data(size8, sched_size8, mode_maps, levels)
        fd.inter8[:] = inter8.astype(np.uint8)
        fd.mv8[:] = mv_cells
        merge8, mvp8, mvd8 = merge_amvp_var_vec(size8, inter8, mv_cells)
        fd.merge8[:] = np.clip(merge8, -1, 4).astype(np.int8)
        fd.mvp8[:] = mvp8
        fd.mvd8[:] = mvd8
        self._set_skip8(fd, size8, inter8, merge8)
        return fd

    def _set_skip8(self, fd, size8, inter8, merge8) -> None:
        """cu_skip_flag per CU: merge CUs with no coded coefficient."""
        fd.skip8[:] = var_skip8_vec(size8, inter8, merge8, fd.coeff_y,
                                    fd.coeff_cb if self.chroma else None,
                                    fd.coeff_cr if self.chroma else None)

    def _var_inter_finish(self, planes, recs, lam_rd):
        """SAO of an inter tree at lam_rd where the config sets it; the
        result becomes a reference picture.  Returns (device recon, host
        recon, host packed SAO parameters or None)."""
        sao = None
        if self.cfg.sao:
            recs, sao = self.var_sao(planes, recs, lam=lam_rd)

        def host(t):
            return None if t is None else t.cpu().numpy()

        return recs, [host_pixels(r) for r in recs], host(sao)

    def encode_frame_var_p(self, y, cb=None, cr=None, poc: int = 1,
                           ref_poc: int = 0, qp=None,
                           qp_factor=None) -> FrameResult:
        """Variable-CU P frame against the DPB: device search at every
        size, host tree argmin and plan, merge RD, device MC,
        reconstruction, deblocking and SAO, host signalling and CABAC,
        at the QP and lambdas of ``_var_frame_qp_lam(qp, qp_factor)``
        (a GOP layer's; by default the config QP's).  The SAO-filtered
        recon becomes the DPB."""
        ql = self._var_frame_qp_lam(qp, qp_factor, SLICE_P)
        planes = tuple(None if a is None else a[0] for a in self._upload(
            self.host_pack_sources([(y, cb, cr)])))
        refs = self._dpb
        size8, sched_size8, mode_maps, inter8, mv_cells, vp = \
            self.var_p_plan(*self.var_p_search(planes[0], refs[0], ql), ql)
        mv_cells = self.merge_rd_p(planes[0], refs[0], size8, inter8,
                                   mv_cells, ql)
        recs, levels = self.var_recon_p(
            self.var_p_sched(vp, planes, size8, inter8, mv_cells), refs, ql)
        self._dpb, rec_np, sao = self._var_inter_finish(planes, recs, ql[1])
        fd = self.var_p_frame_data(size8, sched_size8, mode_maps, inter8,
                                   mv_cells, [lv.cpu().numpy()
                                              for lv in levels])
        _set_sao(fd, sao)
        nal = self._with_hash(self._serialize_p(fd, poc, poc - ref_poc,
                                                qp=ql[0]), rec_np)
        return FrameResult(nals=nal, recon_y=rec_np[0], recon_cb=rec_np[1],
                           recon_cr=rec_np[2], frame_data=fd,
                           bits=len(nal) * 8)

    def var_b_search(self, yp, r0_y, r1_y, ql):
        """Device search of a B tree (``search_quadtree_b``) at ql:
        (costs, modes, mv0s, mv1s, dirs, inter maps) dicts size ->
        grids."""
        cfg = self.cfg
        qp, lam_rd, lam_satd = ql
        return search_quadtree_b(
            yp, r0_y, r1_y, self.coded_w, self.coded_h, lam_satd,
            cfg.me_range, self.bitdepth, (cfg.intra_min_cu, cfg.intra_max_cu),
            (cfg.inter_min_cu, cfg.inter_max_cu), cfg.rd >= 1,
            subpel=cfg.me_subpel, bipred=cfg.bipred, qp=qp, lam_rd=lam_rd)

    def var_b_plan(self, costs, modes, mv0s, mv1s, dirs, imaps, ql):
        """Host stage of a B tree (``_inter_tree_plan``); the cells'
        motion as the effective per-list fields (an unused list's MV is
        0).  Returns (size8, sched_size8, mode_maps, inter8, dirs8, emv0,
        emv1, VarPlan)."""
        size8, sched_size8, mode_maps, fields, vp = self._inter_tree_plan(
            costs, modes, imaps, mv0s, ql[1], (mv1s, dirs))
        inter8, mv0_cells, mv1_cells, dirs8 = fields
        emv0 = np.where((dirs8 != 1)[..., None] & inter8[..., None],
                        mv0_cells, 0)
        emv1 = np.where((dirs8 != 0)[..., None] & inter8[..., None],
                        mv1_cells, 0)
        return size8, sched_size8, mode_maps, inter8, dirs8, emv0, emv1, vp

    def merge_rd_b(self, yp, r0_y, r1_y, size8, inter8, dirs8, emv0, emv1,
                   poc, ref_pocs, ql):
        """Merge-mode RD of a B tree: candidates carry full motion (dir,
        mv0, mv1), combined bi-pred entries included, against the
        searched motion with inter_pred_idc (2 bins) and each used
        list's AMVP rate; a winning candidate's motion replaces the
        CU's, unused lists zeroed again.  Returns (dirs8, emv0, emv1)."""
        d = var_b_derive(size8, inter8, dirs8, emv0, emv1, poc, ref_pocs)
        cy, cx, cells = d["cy"], d["cx"], d["cells"]
        n = cy.size
        if n == 0:
            return dirs8, emv0, emv1
        oy, ox = var_origin_maps(size8)
        h8, w8 = inter8.shape
        cd = np.empty((5, h8, w8), np.int32)
        cm0 = np.empty((5, h8, w8, 2), np.int32)
        cm1 = np.empty((5, h8, w8, 2), np.int32)
        for k in range(5):
            for dst, src, key in ((cd, dirs8.astype(np.int32), "cd"),
                                  (cm0, emv0, "c0"), (cm1, emv1, "c1")):
                g = src.copy()
                g[cy, cx] = d[key][:, k]
                dst[k] = g[oy, ox]

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        maps = merge_satd_maps_b(
            yp, r0_y, r1_y, up(cd), up(cm0), up(cm1),
            up(dirs8.astype(np.int32)), up(emv0), up(emv1),
            self.bitdepth).cpu().numpy()
        md, mm = d["md"], (d["mm0"], d["mm1"])
        amvp_bits = np.full(n, 2.0)            # inter_pred_idc
        for lst in (0, 1):
            p0, p1 = d["amvp"][lst]
            used = (md != 1) if lst == 0 else (md != 0)
            b = 1.0 + np.minimum(_mvd_bits_np(mm[lst] - p0).sum(axis=1),
                                 _mvd_bits_np(mm[lst] - p1).sum(axis=1))
            amvp_bits += np.where(used, b, 0.0)
        win = self._merge_rd_win(self._cu_sums(maps, cy, cx, cells), ql[2],
                                 amvp_bits)
        upd = win < 5
        if not upd.any():
            return dirs8, emv0, emv1
        gd = dirs8.astype(np.int32).copy()
        g0, g1 = emv0.copy(), emv1.copy()
        for g, key in ((gd, "cd"), (g0, "c0"), (g1, "c1")):
            g[cy[upd], cx[upd]] = d[key][upd, win[upd]]
        gd, g0, g1 = gd[oy, ox], g0[oy, ox], g1[oy, ox]
        g0 = np.where((gd != 1)[..., None] & inter8[..., None], g0, 0)
        g1 = np.where((gd != 0)[..., None] & inter8[..., None], g1, 0)
        return (gd.astype(dirs8.dtype), g0.astype(np.int32),
                g1.astype(np.int32))

    def var_b_sched(self, vp, planes, size8, inter8, dirs8, emv0,
                    emv1) -> dict:
        """var_p_sched of a B tree (emv0 as the L0 field) plus its L1
        field and directions (0 on intra cells)."""
        sched = self.var_p_sched(vp, planes, size8, inter8, emv0)
        sched["mv1_cells"] = torch.from_numpy(emv1).to(self.device)
        sched["dirs8"] = torch.from_numpy(
            np.where(inter8, dirs8, 0).astype(np.int32)).to(self.device)
        return sched

    def var_recon_b(self, sched, ref0, ref1, ql):
        """Each cell's L0, L1 or bi-averaged MC from the two references'
        planes, then ``_var_recon_inter``."""
        mcs = bi_mc_planes_cells(ref0, ref1, sched["mv_cells"],
                                 sched["mv1_cells"], sched["dirs8"],
                                 self.bitdepth)
        return self._var_recon_inter(sched, mcs, ql)

    def var_b_frame_data(self, size8, sched_size8, mode_maps, inter8, dirs8,
                         emv0, emv1, levels, poc, ref_pocs) -> FrameData:
        """Host assembly of a B tree's FrameData: the var_frame_data
        fields, both motion fields and the directions, merge/AMVP
        signalling per list and skip flags."""
        fd = self.var_frame_data(size8, sched_size8, mode_maps, levels)
        fd.inter8[:] = inter8.astype(np.uint8)
        fd.mv8[:] = emv0
        fd.mv8_l1[:] = emv1
        fd.dir8[:] = np.where(inter8, dirs8, 0).astype(np.uint8)
        merge8, mvp8, mvd8, mvp8_l1, mvd8_l1 = merge_amvp_var_b_vec(
            size8, inter8, dirs8, emv0, emv1, poc, ref_pocs)
        fd.merge8[:] = np.clip(merge8, -1, 4).astype(np.int8)
        fd.mvp8[:] = mvp8
        fd.mvd8[:] = mvd8
        fd.mvp8_l1[:] = mvp8_l1
        fd.mvd8_l1[:] = mvd8_l1
        self._set_skip8(fd, size8, inter8, merge8)
        return fd

    def encode_frame_var_b(self, y, cb, cr, poc: int, ref0, ref1, qp=None,
                           qp_factor=None, nal_type=None):
        """Variable-CU B frame: ref0 / ref1 = (ref_poc, (y, cb, cr)
        device planes), one past and one future reference.  Device
        search (L0, L1 and bi-pred at every size), host tree argmin and
        plan, B merge RD, device bi MC, reconstruction, deblocking and
        SAO, host signalling and CABAC, at the GOP layer's QP and
        lambdas; nal_type RASL_R for the leading pictures of an open-GOP
        CRA.  Returns (FrameResult, the SAO-filtered recon planes on the
        device: the reference picture this frame leaves)."""
        ql = self._var_frame_qp_lam(qp, qp_factor, SLICE_B)
        planes = tuple(None if a is None else a[0] for a in self._upload(
            self.host_pack_sources([(y, cb, cr)])))
        (poc0, r0), (poc1, r1) = ref0, ref1
        size8, sched_size8, mode_maps, inter8, dirs8, emv0, emv1, vp = \
            self.var_b_plan(*self.var_b_search(planes[0], r0[0], r1[0], ql),
                            ql)
        dirs8, emv0, emv1 = self.merge_rd_b(
            planes[0], r0[0], r1[0], size8, inter8, dirs8, emv0, emv1, poc,
            (poc0, poc1), ql)
        recs, levels = self.var_recon_b(
            self.var_b_sched(vp, planes, size8, inter8, dirs8, emv0, emv1),
            r0, r1, ql)
        recs, rec_np, sao = self._var_inter_finish(planes, recs, ql[1])
        fd = self.var_b_frame_data(size8, sched_size8, mode_maps, inter8,
                                   dirs8, emv0, emv1,
                                   [lv.cpu().numpy() for lv in levels], poc,
                                   (poc0, poc1))
        _set_sao(fd, sao)
        nal = self._with_hash(self._serialize_b(
            fd, poc, poc - poc0, poc1 - poc, qp=ql[0],
            nal_type=nal_type or NAL_TRAIL_R), rec_np)
        return FrameResult(nals=nal, recon_y=rec_np[0], recon_cb=rec_np[1],
                           recon_cr=rec_np[2], frame_data=fd,
                           bits=len(nal) * 8), recs

    def encode_frames(self, frames) -> list[FrameResult]:
        """Encode a batch of frames through one batched device program
        (a variable tree: one frame at a time)."""
        if self.var:
            return [self.encode_frame_var(*f) for f in frames]
        return self.finalize_downloaded(
            self.download_frames(self.submit_frames(frames)))

    def encode_frame(self, y: np.ndarray, cb=None, cr=None, qp_ctu=None,
                     nal_type=None, poc: int = 0) -> FrameResult:
        """y: (H, W) uint8 (uint16 above 8-bit) source luma; cb/cr half
        size (4:2:0).  qp_ctu: (Cy, Cx) per-CTU QP map (LCU rate
        control, ROI, AQ; fixed grid), coded with cu_qp_delta.  nal_type / poc: the CRA of an open GOP
        (it codes its POC); by default an IDR at POC 0."""
        self._islice = None if nal_type is None else (nal_type, poc)
        try:
            if qp_ctu is not None:
                return self.encode_frame_qp(y, cb, cr, qp_ctu)
            return self.encode_frames([(y, cb, cr)])[0]
        finally:
            self._islice = None

    def encode_frame_qp(self, y, cb, cr, qp_ctu) -> FrameResult:
        """I frame of the fixed grid with a (Cy, Cx) per-CTU QP map: the
        mode search at the config's QP, the reconstruction at each
        block's QP, deblocking at the effective QPs and SAO at the
        config's lambda, then CABAC with cu_qp_delta."""
        ys, cbs, crs = self._upload(self.host_pack_sources([(y, cb, cr)]))
        modes, levels, recs, _sses, sao, cmodes, _ts = \
            self._encode_from_planes(ys, cbs, crs,
                                     self._upload_qp(qp_ctu)[None])
        self._dpb = tuple(None if r is None else r[0] for r in recs)

        def host(t):
            return None if t is None else t[0].cpu().numpy()

        return self._host_finalize(host(modes), *(host(t) for t in levels),
                                   *(host_pixels(None if r is None else r[0])
                                     for r in recs), sao=host(sao),
                                   qp_ctu=qp_ctu, cmodes=host(cmodes))

    def close(self) -> None:
        """Stop the host CABAC pool."""
        if self._host_pool is not None:
            self._host_pool.shutdown()
            self._host_pool = None


def _sched_sizes(size8: np.ndarray, mode_maps: dict):
    """(sched_size8, mode_maps) of a tree's wavefront: 64x64 CUs
    reconstruct as four 32x32 TBs (the forced TU split, 7.3.8.8), so
    they are scheduled as 32 blocks carrying the 64 CU's mode; depth8
    and the serialization keep the true tree."""
    sched_size8 = np.minimum(size8, 32).astype(size8.dtype)
    if 64 in mode_maps and (size8 == 64).any():
        m32 = mode_maps[32].copy()
        up = np.kron(mode_maps[64], np.ones((2, 2), m32.dtype))
        mask32 = size8[::4, ::4] == 64
        region = m32[:up.shape[0], :up.shape[1]]
        m32[:up.shape[0], :up.shape[1]] = np.where(
            mask32[:up.shape[0], :up.shape[1]], up, region)
        mode_maps = dict(mode_maps)
        mode_maps[32] = m32
    return sched_size8, mode_maps


def _patch_children(maps: dict, msk8: np.ndarray, s: int) -> dict:
    """The mode maps with each TU-split CU of size s (msk8: its 8x8
    cells) carrying its mode into the half size's map, where its four
    TBs are scheduled (the JAX package's ``_patch_children``)."""
    h = s // 2
    pm = maps[s]
    up = np.kron(pm, np.ones((2, 2), pm.dtype))
    mch = msk8[::h // 8, ::h // 8]
    child = maps[h].copy()
    region = child[:up.shape[0], :up.shape[1]]
    child[:up.shape[0], :up.shape[1]] = np.where(
        mch[:up.shape[0], :up.shape[1]], up, region)
    out = dict(maps)
    out[h] = child
    return out


def _mvd_bits_np(v: np.ndarray) -> np.ndarray:
    """Host form of the search's mvd bit estimate (float64)."""
    a = np.abs(v).astype(np.int64)
    nbits = np.zeros_like(a)
    nz = a > 0
    nbits[nz] = np.floor(np.log2(a[nz])).astype(np.int64) + 1
    return np.where(a == 0, 1, 2 * nbits + 1).astype(np.float64)


def _set_sao(fd: FrameData, packed) -> None:
    """Fill FrameData's SAO fields from one frame's packed (Cy, Cx, 20)
    parameters (see ``_sao_stage``); None leaves SAO off."""
    if packed is None:
        return
    fd.sao_merge[:] = packed[..., 0]
    fd.sao_type[:] = packed[..., 1:3]
    fd.sao_eo[:] = packed[..., 3:5]
    fd.sao_bp[:] = packed[..., 5:8]
    fd.sao_off[:] = packed[..., 8:20].reshape(fd.sao_off.shape)


def psnr(a: np.ndarray, b: np.ndarray, bitdepth: int = 8) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return 999.99
    peak = (1 << bitdepth) - 1
    return 10.0 * math.log10(peak * peak / mse)
