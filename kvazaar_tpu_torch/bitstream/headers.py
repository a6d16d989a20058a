"""VPS / SPS / PPS / slice-header writers (H.265 7.3.2, 7.3.6).

Reference behavior being matched: src/encoder_state-bitstream.c:57-1085
(kvazaar's parameter-set writers).  This is a clean-room writer driven by
our Config; field order follows the spec clause by clause.

Current operating point (widens as tools land): Main / Main10 profile,
one slice per picture, SAO/deblock flags from config, no tiles, WPP flag
plumbed for entry-point offsets.
"""

from __future__ import annotations

import dataclasses

from kvazaar_tpu_torch.bitstream.bits import (BitReader, BitWriter, nal_unit)
from kvazaar_tpu_torch.constants import (NAL_IDR_W_RADL, NAL_PPS, NAL_SPS, NAL_VPS,
                                   SLICE_I)


@dataclasses.dataclass
class StreamParams:
    """Everything the header writers (and the oracle decoder) need."""
    width: int              # coded width (multiple of min CU)
    height: int
    bitdepth: int = 8
    chroma_format_idc: int = 1   # 0=400, 1=420
    qp: int = 22
    log2_ctu: int = 6
    log2_min_cu: int = 3
    log2_min_tu: int = 2
    log2_max_tu: int = 5
    max_tr_depth_intra: int = 0
    max_tr_depth_inter: int = 0
    sao_enabled: bool = False
    deblock_enabled: bool = False
    deblock_beta_offset_div2: int = 0
    deblock_tc_offset_div2: int = 0
    sign_hiding: bool = False
    transform_skip: bool = False
    transquant_bypass: bool = False
    # Implicit residual DPCM for hor/ver intra TBs under transquant
    # bypass (HEVC RExt; reference --implicit-rdpcm, rdpcm() at
    # reference src/transform.c:99 + SPS extension at
    # src/encoder_state-bitstream.c:304).
    implicit_rdpcm: bool = False
    # cu_qp_delta_enabled_flag with diff_cu_qp_delta_depth = 0 (QG =
    # CTU): per-CTU QP for LCU rate control / ROI maps (reference
    # src/rate_control.c:278, src/encoder.c:127-170).
    cu_qp_delta: bool = False
    # --slices mode: "none" (one slice/picture), "wpp" (each CTU row a
    # dependent slice segment), "tiles" (each tile an independent
    # slice) — reference src/kvazaar.h:198-201.
    slices: str = "none"
    # Selective encryption key (reference --crypto behind
    # KVZ_SEL_ENCRYPTION, extras/crypto.cpp): AES-CTR keystream over
    # sign bypass bins.  None = off.
    crypto_key: bytes = None
    # Interlaced source: 0 progressive, 1 top-field-first, 2
    # bottom-field-first — field pictures with field_seq VUI +
    # pic_timing SEIs (reference kvazaar_field_encoding_adapter,
    # src/kvazaar.c:294; SEI src/encoder_state-bitstream.c:618-650).
    source_scan_type: int = 0
    strong_intra_smoothing: bool = True
    wpp: bool = False
    amp: bool = False
    conf_win: tuple = (0, 0, 0, 0)   # left, right, top, bottom (luma px)
    level_idc: int = 120             # level 4.0 * 30
    tier: int = 0                    # 0 = main, 1 = high (A.4)
    log2_max_poc_lsb: int = 8
    # Scaling lists: 0 = off (flat), 1 = custom (cqmfile, signalled in
    # scaling_list_data()), 2 = default lists (data_present = 0).
    scaling_list_mode: int = 0
    scaling_custom: tuple = None     # (base matrices dict, dc dict)
    tmvp_enabled: bool = False       # sps_temporal_mvp_enabled_flag
    # Uniform-spacing tile grid (1, 1) = no tiles (7.4.3.3.1;
    # reference tile geometry src/encoder.c:387-520).
    tiles: tuple = (1, 1)
    # VUI (E.2.1; reference writer src/encoder_state-bitstream.c:194-296
    # driven by the --sar/--overscan/--videoformat/--range/--colorprim/
    # --transfer/--colormatrix/--chromaloc options).  framerate drives
    # vui_timing_info; (0, 0) sar = not signalled.
    framerate: tuple = (25, 1)       # (num, denom)
    sar: tuple = (0, 0)
    overscan: int = 0                # 0 unspec, 1 shown, 2 cropped
    videoformat: int = 5             # 5 = unspecified
    fullrange: int = 0
    colorprim: int = 2               # 2 = unspecified
    transfer: int = 2
    colormatrix: int = 2
    chroma_loc: int = 0

    @property
    def tiles_enabled(self) -> bool:
        return self.tiles != (1, 1)

    @property
    def ctu_size(self) -> int:
        return 1 << self.log2_ctu

    @property
    def width_in_ctus(self) -> int:
        return -(-self.width // self.ctu_size)

    @property
    def height_in_ctus(self) -> int:
        return -(-self.height // self.ctu_size)


# Table A.8/A.9 main-tier limits: level_idc -> (MaxLumaPs, MaxLumaSr).
_LEVELS = [
    (30, 36864, 552960), (60, 122880, 3686400),
    (63, 245760, 7372800), (90, 552960, 16588800),
    (93, 983040, 33177600), (120, 2228224, 66846720),
    (123, 2228224, 133693440), (150, 8912896, 267386880),
    (153, 8912896, 534773760), (156, 8912896, 1069547520),
    (180, 35651584, 1069547520), (183, 35651584, 2139095040),
    (186, 35651584, 4278190080),
]


def compute_level_idc(width: int, height: int, fps: float) -> int:
    """Lowest level whose A.4.1 picture-size / sample-rate / dimension
    limits fit (the validation the reference runs in
    kvz_encoder_control_init / cfg level checks, src/cfg.c:1460-1540)."""
    ps = width * height
    sr = ps * max(fps, 1.0)
    for idc, max_ps, max_sr in _LEVELS:
        dim = int((8 * max_ps) ** 0.5)
        if ps <= max_ps and sr <= max_sr and width <= dim \
                and height <= dim:
            return idc
    return _LEVELS[-1][0]


def _profile_tier_level(w: BitWriter, p: StreamParams) -> None:
    """profile_tier_level(1, 0) — H.265 7.3.3."""
    w.u(0, 2)               # general_profile_space
    w.u(p.tier, 1)          # general_tier_flag (main/high, A.4)
    profile_idc = 1 if p.bitdepth == 8 else 2   # Main / Main 10
    w.u(profile_idc, 5)
    compat = (1 << (31 - 1)) | (1 << (31 - 2))  # Main + Main10 compatible
    if p.bitdepth > 8:
        compat = 1 << (31 - 2)
    w.u(compat, 32)
    fld = 1 if p.source_scan_type else 0
    w.u(0 if fld else 1, 1)  # general_progressive_source_flag
    w.u(fld, 1)              # general_interlaced_source_flag
    w.u(0, 1)                # general_non_packed_constraint_flag
    w.u(0 if fld else 1, 1)  # general_frame_only_constraint_flag
    w.u(0, 32)              # general_reserved_zero_44bits
    w.u(0, 12)
    w.u(p.level_idc, 8)     # general_level_idc


def write_vps(p: StreamParams) -> bytes:
    w = BitWriter()
    w.u(0, 4)               # vps_video_parameter_set_id
    w.u(1, 1)               # vps_base_layer_internal_flag
    w.u(1, 1)               # vps_base_layer_available_flag
    w.u(0, 6)               # vps_max_layers_minus1
    w.u(0, 3)               # vps_max_sub_layers_minus1
    w.u(1, 1)               # vps_temporal_id_nesting_flag
    w.u(0xFFFF, 16)         # vps_reserved_0xffff_16bits
    _profile_tier_level(w, p)
    w.u(0, 1)               # vps_sub_layer_ordering_info_present_flag
    w.ue(1)                 # vps_max_dec_pic_buffering_minus1[0]
    w.ue(0)                 # vps_max_num_reorder_pics[0]
    w.ue(0)                 # vps_max_latency_increase_plus1[0]
    w.u(0, 6)               # vps_max_layer_id
    w.ue(0)                 # vps_num_layer_sets_minus1
    w.u(0, 1)               # vps_timing_info_present_flag
    w.u(0, 1)               # vps_extension_flag
    w.rbsp_trailing_bits()
    return nal_unit(w.get_bytes(), NAL_VPS)


def write_sps(p: StreamParams) -> bytes:
    w = BitWriter()
    w.u(0, 4)               # sps_video_parameter_set_id
    w.u(0, 3)               # sps_max_sub_layers_minus1
    w.u(1, 1)               # sps_temporal_id_nesting_flag
    _profile_tier_level(w, p)
    w.ue(0)                 # sps_seq_parameter_set_id
    w.ue(p.chroma_format_idc)
    w.ue(p.width)
    w.ue(p.height)
    cl, cr, ct, cb = p.conf_win
    if any(p.conf_win):
        w.u(1, 1)
        # Offsets are in chroma units for 4:2:0.
        sub = 2 if p.chroma_format_idc == 1 else 1
        w.ue(cl // sub)
        w.ue(cr // sub)
        w.ue(ct // sub)
        w.ue(cb // sub)
    else:
        w.u(0, 1)
    w.ue(p.bitdepth - 8)    # bit_depth_luma_minus8
    w.ue(p.bitdepth - 8)    # bit_depth_chroma_minus8
    w.ue(p.log2_max_poc_lsb - 4)
    w.u(0, 1)               # sps_sub_layer_ordering_info_present_flag
    w.ue(1)                 # sps_max_dec_pic_buffering_minus1[0]
    w.ue(0)                 # sps_max_num_reorder_pics[0]
    w.ue(0)                 # sps_max_latency_increase_plus1[0]
    w.ue(p.log2_min_cu - 3)
    w.ue(p.log2_ctu - p.log2_min_cu)
    w.ue(p.log2_min_tu - 2)
    w.ue(p.log2_max_tu - p.log2_min_tu)
    w.ue(p.max_tr_depth_inter)
    w.ue(p.max_tr_depth_intra)
    if p.scaling_list_mode:
        w.u(1, 1)           # scaling_list_enabled_flag
        if p.scaling_list_mode == 1:
            w.u(1, 1)       # sps_scaling_list_data_present_flag
            raise NotImplementedError("custom scaling lists are not "
                                      "ported")
        else:
            w.u(0, 1)       # default lists
    else:
        w.u(0, 1)           # scaling_list_enabled_flag
    w.u(1 if p.amp else 0, 1)
    w.u(1 if p.sao_enabled else 0, 1)
    w.u(0, 1)               # pcm_enabled_flag
    w.ue(0)                 # num_short_term_ref_pic_sets
    w.u(0, 1)               # long_term_ref_pics_present_flag
    w.u(1 if p.tmvp_enabled else 0, 1)  # sps_temporal_mvp_enabled
    w.u(1 if p.strong_intra_smoothing else 0, 1)
    w.u(1, 1)               # vui_parameters_present_flag
    _write_vui(w, p)
    if p.implicit_rdpcm and p.transquant_bypass:
        # SPS range extension carrying implicit_rdpcm_enabled_flag
        # (7.3.2.2.2; reference src/encoder_state-bitstream.c:304).
        w.u(1, 1)           # sps_extension_present_flag
        w.u(1, 1)           # sps_range_extension_flag
        w.u(0, 1)           # sps_multilayer_extension_flag
        w.u(0, 1)           # sps_3d_extension_flag
        w.u(0, 5)           # sps_extension_5bits
        w.u(0, 1)           # transform_skip_rotation_enabled_flag
        w.u(0, 1)           # transform_skip_context_enabled_flag
        w.u(1, 1)           # implicit_rdpcm_enabled_flag
        w.u(0, 1)           # explicit_rdpcm_enabled_flag
        w.u(0, 1)           # extended_precision_processing_flag
        w.u(0, 1)           # intra_smoothing_disabled_flag
        w.u(0, 1)           # high_precision_offsets_enabled_flag
        w.u(0, 1)           # persistent_rice_adaptation_enabled_flag
        w.u(0, 1)           # cabac_bypass_alignment_enabled_flag
    else:
        w.u(0, 1)           # sps_extension_present_flag
    w.rbsp_trailing_bits()
    return nal_unit(w.get_bytes(), NAL_SPS)


# Table E.1 standard sample aspect ratios (aspect_ratio_idc 1..16).
_SAR_TABLE = [(1, 1), (12, 11), (10, 11), (16, 11), (40, 33), (24, 11),
              (20, 11), (32, 11), (80, 33), (18, 11), (15, 11),
              (64, 33), (160, 99), (4, 3), (3, 2), (2, 1)]


def _write_vui(w: BitWriter, p: StreamParams) -> None:
    """VUI parameters (E.2.1), mirroring the reference's writer field
    for field (src/encoder_state-bitstream.c:194-296)."""
    if p.sar[0] > 0 and p.sar[1] > 0:
        w.u(1, 1)           # aspect_ratio_info_present_flag
        try:
            idc = _SAR_TABLE.index((p.sar[0], p.sar[1])) + 1
        except ValueError:
            idc = 255       # EXTENDED_SAR
        w.u(idc, 8)
        if idc == 255:
            w.u(p.sar[0], 16)
            w.u(p.sar[1], 16)
    else:
        w.u(0, 1)
    if p.overscan > 0:
        w.u(1, 1)           # overscan_info_present_flag
        w.u(p.overscan - 1, 1)  # overscan_appropriate_flag
    else:
        w.u(0, 1)
    signal = (p.videoformat != 5 or p.fullrange != 0
              or p.colorprim != 2 or p.transfer != 2
              or p.colormatrix != 2)
    w.u(1 if signal else 0, 1)  # video_signal_type_present_flag
    if signal:
        w.u(p.videoformat, 3)
        w.u(p.fullrange, 1)
        desc = (p.colorprim != 2 or p.transfer != 2
                or p.colormatrix != 2)
        w.u(1 if desc else 0, 1)  # colour_description_present_flag
        if desc:
            w.u(p.colorprim, 8)
            w.u(p.transfer, 8)
            w.u(p.colormatrix, 8)
    if p.chroma_loc > 0:
        w.u(1, 1)           # chroma_loc_info_present_flag
        w.ue(p.chroma_loc)  # top field
        w.ue(p.chroma_loc)  # bottom field
    else:
        w.u(0, 1)
    w.u(0, 1)               # neutral_chroma_indication_flag
    fld = 1 if p.source_scan_type else 0
    w.u(fld, 1)             # field_seq_flag (1 = field pictures)
    w.u(fld, 1)             # frame_field_info_present_flag
    w.u(0, 1)               # default_display_window_flag
    w.u(1, 1)               # vui_timing_info_present_flag
    # Field sequences emit two pictures per source frame: the picture
    # clock doubles (field_seq_flag=1 above).
    ts_mult = 2 if p.source_scan_type else 1
    w.u(p.framerate[1], 32)  # vui_num_units_in_tick
    w.u(p.framerate[0] * ts_mult, 32)  # vui_time_scale
    w.u(0, 1)               # vui_poc_proportional_to_timing_flag
    w.u(0, 1)               # vui_hrd_parameters_present_flag
    w.u(0, 1)               # bitstream_restriction_flag


def write_aud(slice_type: int) -> bytes:
    """Access unit delimiter (7.3.2.5; reference
    encoder_state_write_bitstream_aud,
    src/encoder_state-bitstream.c:44): pic_type 0 = I only, 1 = P+I,
    2 = B+P+I."""
    from kvazaar_tpu_torch.constants import SLICE_B, SLICE_I
    w = BitWriter()
    pic_type = 0 if slice_type == SLICE_I else (
        2 if slice_type == SLICE_B else 1)
    w.u(pic_type, 3)
    w.rbsp_trailing_bits()
    return nal_unit(w.get_bytes(), 35)          # NAL_AUD


def write_pic_timing_sei(pic_struct: int) -> bytes:
    """pic_timing prefix SEI (D.2.3) for field pictures: pic_struct
    1 = top field, 2 = bottom field; source_scan_type 0 = interlaced.
    Reference: encoder_state_write_picture_timing_sei_message,
    src/encoder_state-bitstream.c:618-650."""
    w = BitWriter()
    w.u(1, 8)               # payload type: pic_timing
    w.u(1, 8)               # payload size
    w.u(pic_struct, 4)
    w.u(0, 2)               # source_scan_type: interlaced
    w.u(0, 1)               # duplicate_flag
    w.bit(1)                # payload_bit_equal_to_one (alignment)
    w.rbsp_trailing_bits()
    return nal_unit(w.get_bytes(), 39)          # PREFIX_SEI


def write_version_sei() -> bytes:
    """user_data_unregistered prefix SEI (D.2.7) carrying the encoder
    version string, like the reference's version SEI
    (src/encoder_state-bitstream.c:1003)."""
    uuid = bytes.fromhex("2CA2DE09B51747DBBB55A4FE7FC2FC4E")
    # The reference package's string, so that the port's streams stay
    # byte-identical to its streams.
    text = b"kvazaar_tpu 0.1.0 TPU HEVC encoder"
    payload = uuid + text
    w = BitWriter()
    w.u(5, 8)               # payload type: user_data_unregistered
    size = len(payload)
    while size >= 255:
        w.u(255, 8)
        size -= 255
    w.u(size, 8)
    for b in payload:
        w.u(b, 8)
    w.rbsp_trailing_bits()
    return nal_unit(w.get_bytes(), 39)          # PREFIX_SEI


def write_pps(p: StreamParams) -> bytes:
    w = BitWriter()
    w.ue(0)                 # pps_pic_parameter_set_id
    w.ue(0)                 # pps_seq_parameter_set_id
    w.u(1 if p.slices == "wpp" else 0,
        1)                  # dependent_slice_segments_enabled_flag
    w.u(0, 1)               # output_flag_present_flag
    w.u(0, 3)               # num_extra_slice_header_bits
    w.u(1 if p.sign_hiding else 0, 1)
    w.u(0, 1)               # cabac_init_present_flag
    w.ue(0)                 # num_ref_idx_l0_default_active_minus1
    w.ue(0)                 # num_ref_idx_l1_default_active_minus1
    w.se(p.qp - 26)         # init_qp_minus26
    w.u(0, 1)               # constrained_intra_pred_flag
    w.u(1 if p.transform_skip else 0, 1)
    w.u(1 if p.cu_qp_delta else 0, 1)   # cu_qp_delta_enabled_flag
    if p.cu_qp_delta:
        w.ue(0)             # diff_cu_qp_delta_depth (QG = CTU)
    w.se(0)                 # pps_cb_qp_offset
    w.se(0)                 # pps_cr_qp_offset
    w.u(0, 1)               # pps_slice_chroma_qp_offsets_present_flag
    w.u(0, 1)               # weighted_pred_flag
    w.u(0, 1)               # weighted_bipred_flag
    w.u(1 if p.transquant_bypass else 0, 1)
    w.u(1 if p.tiles_enabled else 0, 1)   # tiles_enabled_flag
    w.u(1 if p.wpp else 0, 1)   # entropy_coding_sync_enabled_flag
    if p.tiles_enabled:
        w.ue(p.tiles[0] - 1)    # num_tile_columns_minus1
        w.ue(p.tiles[1] - 1)    # num_tile_rows_minus1
        w.u(1, 1)               # uniform_spacing_flag
        w.u(1, 1)     # loop_filter_across_tiles_enabled_flag
    w.u(1, 1)               # pps_loop_filter_across_slices_enabled_flag
    w.u(1, 1)               # deblocking_filter_control_present_flag
    w.u(0, 1)               # deblocking_filter_override_enabled_flag
    w.u(0 if p.deblock_enabled else 1, 1)  # pps_deblocking_filter_disabled
    if p.deblock_enabled:
        w.se(p.deblock_beta_offset_div2)
        w.se(p.deblock_tc_offset_div2)
    w.u(0, 1)               # pps_scaling_list_data_present_flag
    w.u(0, 1)               # lists_modification_present_flag
    w.ue(0)                 # log2_parallel_merge_level_minus2
    w.u(0, 1)               # slice_segment_header_extension_present_flag
    w.u(0, 1)               # pps_extension_present_flag
    w.rbsp_trailing_bits()
    return nal_unit(w.get_bytes(), NAL_PPS)


def write_slice_header(w: BitWriter, p: StreamParams, slice_type: int,
                       nal_type: int, slice_qp: int, poc: int = 0,
                       ref_poc_diff: int = 1, ref_poc_diff_l1=None,
                       ref_list_l0=None, retained_l0=(),
                       tmvp: bool = False,
                       num_entry_points: int = 0,
                       entry_point_offsets=(),
                       first_seg: bool = True,
                       dependent: bool = False,
                       seg_address: int = 0) -> None:
    """Write the slice segment header into `w` (caller then byte-aligns
    into slice data).  H.265 7.3.6.1; one full-picture slice.

    P slices carry an inline short-term RPS of negative references:
    `ref_list_l0` (increasing POC deltas, all used by the current
    picture — the L0 order) plus `retained_l0` (deltas kept in the DPB
    for later pictures, used_by_curr = 0); a single `ref_poc_diff` is
    the legacy one-ref form.  B slices additionally carry one positive
    reference `ref_poc_diff_l1` pictures ahead (hierarchical GOP,
    single ref per list).  Mirrors kvz_encoder_state_write_bitstream
    slice-header RPS emission (src/encoder_state-bitstream.c:687)."""
    from kvazaar_tpu_torch.constants import SLICE_B
    if ref_list_l0 is None:
        ref_list_l0 = [ref_poc_diff]
    used = set(ref_list_l0)
    all_neg = sorted(used | set(retained_l0))
    w.u(1 if first_seg else 0, 1)   # first_slice_segment_in_pic_flag
    if 16 <= nal_type <= 23:
        w.u(0, 1)           # no_output_of_prior_pics_flag
    w.ue(0)                 # slice_pic_parameter_set_id
    if not first_seg:
        if p.slices == "wpp":       # dependent_slice_segments_enabled
            w.u(1 if dependent else 0, 1)
        pic_ctbs = p.width_in_ctus * p.height_in_ctus
        nbits = max((pic_ctbs - 1).bit_length(), 1)
        w.u(seg_address, nbits)     # slice_segment_address
        if dependent:
            # Dependent segments inherit every slice-level field
            # (7.3.6.1): only entry points + byte alignment follow.
            if p.wpp or p.tiles_enabled:
                w.ue(num_entry_points)
                if num_entry_points:
                    ol = max(max(o.bit_length()
                                 for o in entry_point_offsets), 1)
                    w.ue(ol - 1)
                    for off in entry_point_offsets:
                        w.u(off - 1, ol)
            w.bit(1)
            w.align_zero()
            return
    w.ue(slice_type)
    if nal_type not in (NAL_IDR_W_RADL, NAL_IDR_W_RADL + 1):
        w.u(poc & ((1 << p.log2_max_poc_lsb) - 1), p.log2_max_poc_lsb)
        w.u(0, 1)           # short_term_ref_pic_set_sps_flag
        # st_ref_pic_set(0): idx 0 → no inter-RPS prediction flag.
        w.ue(len(all_neg))  # num_negative_pics
        w.ue(1 if ref_poc_diff_l1 else 0)   # num_positive_pics
        prev = 0
        for d in all_neg:
            w.ue(d - prev - 1)       # delta_poc_s0_minus1[i]
            w.u(1 if d in used else 0, 1)   # used_by_curr_pic_s0_flag
            prev = d
        if ref_poc_diff_l1:
            w.ue(ref_poc_diff_l1 - 1)   # delta_poc_s1_minus1[0]
            w.u(1, 1)       # used_by_curr_pic_s1_flag[0]
        if p.tmvp_enabled:
            w.u(1 if tmvp else 0, 1)  # slice_temporal_mvp_enabled
    if p.sao_enabled:
        w.u(1, 1)           # slice_sao_luma_flag
        w.u(1 if p.chroma_format_idc else 0, 1)
    if slice_type != SLICE_I:
        nref = len(ref_list_l0)
        if nref != 1:
            w.u(1, 1)       # num_ref_idx_active_override_flag
            w.ue(nref - 1)  # num_ref_idx_l0_active_minus1
            if slice_type == SLICE_B:
                w.ue(0)     # num_ref_idx_l1_active_minus1
        else:
            w.u(0, 1)       # num_ref_idx_active_override_flag
        # (lists_modification absent: PPS flag 0)
        if slice_type == SLICE_B:
            w.u(0, 1)       # mvd_l1_zero_flag
        if tmvp:
            # P: collocated_from_l0 inferred 1; idx present when more
            # than one active L0 ref (7.3.6.1).
            if slice_type == SLICE_B:
                w.u(1, 1)   # collocated_from_l0_flag
            if len(ref_list_l0) > 1:
                w.ue(0)     # collocated_ref_idx
        w.ue(0)             # five_minus_max_num_merge_cand → 5
    w.se(slice_qp - p.qp)   # slice_qp_delta (relative to PPS init QP)
    if p.sao_enabled or p.deblock_enabled:
        w.u(1, 1)           # slice_loop_filter_across_slices_enabled_flag
    if p.wpp or p.tiles_enabled:
        w.ue(num_entry_points)
        if num_entry_points:
            offset_len = max(o.bit_length() for o in entry_point_offsets)
            offset_len = max(offset_len, 1)
            w.ue(offset_len - 1)
            for off in entry_point_offsets:
                w.u(off - 1, offset_len)
    # byte_alignment()
    w.bit(1)
    w.align_zero()


def picture_checksum(pl, bitdepth: int = 8) -> bytes:
    """Decoded-picture checksum, hash_type 2 (D.3.20): per-sample
    byte xor-mask accumulation — vectorized (the reference computes it
    in kvz_image_checksum, src/strategies/generic/nal-generic.c)."""
    import numpy as np
    h, w = pl.shape
    a = pl.astype(np.uint32)
    xx, yy = np.meshgrid(np.arange(w, dtype=np.uint32),
                         np.arange(h, dtype=np.uint32))
    mask = (xx & 0xFF) ^ (yy & 0xFF) ^ (xx >> 8) ^ (yy >> 8)
    total = int(((a & 0xFF) ^ mask).sum(dtype=np.uint64))
    if bitdepth > 8:
        total += int(((a >> 8) ^ mask).sum(dtype=np.uint64))
    return int(total & 0xFFFFFFFF).to_bytes(4, "big")


def write_picture_hash_sei(planes, bitdepth: int = 8,
                           kind: str = "md5") -> bytes:
    """Decoded-picture-hash SEI (payload type 132; hash_type 0 = MD5,
    2 = checksum) as a suffix-SEI NAL.  Reference behavior:
    add_checksum (src/encoder_state-bitstream.c:894) with --hash
    md5/checksum (kvz_image_md5/kvz_image_checksum); the decoder
    verifies it against its own output."""
    import hashlib

    import numpy as np

    from kvazaar_tpu_torch.constants import NAL_SUFFIX_SEI
    payload = bytearray([0 if kind == "md5" else 2])
    for pl in planes:
        if pl is None:
            continue
        arr = np.ascontiguousarray(
            pl, np.uint8 if bitdepth <= 8 else np.uint16)
        if kind == "md5":
            payload += hashlib.md5(arr.tobytes()).digest()
        else:
            payload += picture_checksum(arr, bitdepth)
    w = BitWriter()
    w.u(132, 8)                    # last_payload_type_byte
    w.u(len(payload), 8)           # last_payload_size_byte
    for b in payload:
        w.u(b, 8)
    w.rbsp_trailing_bits()
    return nal_unit(w.get_bytes(), NAL_SUFFIX_SEI)


def parse_picture_hash_sei(rbsp: bytes):
    """Returns (hash_type, [digests]) from a suffix SEI, or None
    (16-byte MD5 for type 0, 4-byte checksums for type 2)."""
    r = BitReader(rbsp)
    ptype = r.u(8)
    psize = r.u(8)
    if ptype != 132:
        return None
    htype = r.u(8)
    if htype not in (0, 2):
        return None
    dlen = 16 if htype == 0 else 4
    digests = []
    for _ in range((psize - 1) // dlen):
        digests.append(bytes(r.u(8) for _ in range(dlen)))
    return htype, digests
