"""HEVC constants shared across the encoder.

These are dictated by ITU-T H.265; the reference keeps them in
src/global.h:118-137 and src/tables.c.
"""

# Coding tree block geometry (H.265 main profile operating point, same as
# the reference's compile-time choice: LCU_WIDTH=64, MAX_DEPTH=3).
CTU_SIZE = 64
LOG2_CTU_SIZE = 6
MIN_CU_SIZE = 8
LOG2_MIN_CU_SIZE = 3
MIN_TU_SIZE = 4
LOG2_MIN_TU_SIZE = 2
MAX_TU_SIZE = 32
LOG2_MAX_TU_SIZE = 5

# Intra prediction modes.
INTRA_PLANAR = 0
INTRA_DC = 1
INTRA_ANGULAR_MIN = 2
INTRA_ANGULAR_MAX = 34
NUM_INTRA_MODES = 35

# Slice types (order matches H.265 slice_type ue(v) coding).
SLICE_B = 0
SLICE_P = 1
SLICE_I = 2

# NAL unit types (H.265 Table 7-1).
NAL_TRAIL_N = 0
NAL_RASL_N = 8
NAL_RASL_R = 9
NAL_TRAIL_R = 1
NAL_BLA_W_LP = 16
NAL_IDR_W_RADL = 19
NAL_IDR_N_LP = 20
NAL_CRA_NUT = 21
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34
NAL_AUD = 35
NAL_EOS = 36
NAL_EOB = 37
NAL_FD = 38
NAL_PREFIX_SEI = 39
NAL_SUFFIX_SEI = 40

# Quantizer.
MAX_QP = 51

# Dynamic range of transform coefficients (16-bit path, extended precision
# off — matches the reference's MAX_TR_DYNAMIC_RANGE=15).
MAX_TR_DYNAMIC_RANGE = 15


# H.265 Table 8-10: chroma QP from luma QP (4:2:0) — the ONE copy;
# ops/deblock.py, encoder/intra_recon.py, and frame_encoder.chroma_qp
# all derive from it.
import numpy as _np

CHROMA_QP_TAB = _np.array(
    [q if q < 30 else {30: 29, 31: 30, 32: 31, 33: 32, 34: 33, 35: 33,
                       36: 34, 37: 34, 38: 35, 39: 35, 40: 36, 41: 36,
                       42: 37, 43: 37}.get(q, q - 6)
     for q in range(52)], _np.int32)
