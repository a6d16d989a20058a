"""Flat-list HEVC quantization / dequantization (H.265 8.6.3), batched.

Counterpart of kvazaar_tpu/ops/quant.py for a frame-level QP without
scaling lists (RDOQ and sign hiding wait).  int32 arithmetic exactly as
the JAX package forms it; the scale tables are copies pinned by a test.
"""

from __future__ import annotations

import numpy as np
import torch

# g_quantScales / g_invQuantScales of the standard (per qp % 6).
QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564],
                        dtype=np.int32)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)

QUANT_SHIFT = 14


def quant_params(qp: int, log2_size: int, bitdepth: int):
    """(scale, qbits, inv_scale, inv_shift) for a transform size."""
    transform_shift = 15 - bitdepth - log2_size  # MAX_TR_DYNAMIC_RANGE=15
    qbits = QUANT_SHIFT + qp // 6 + transform_shift
    inv_shift = bitdepth + log2_size - 5
    return (int(QUANT_SCALES[qp % 6]), qbits,
            int(INV_QUANT_SCALES[qp % 6]), inv_shift)


def quantize(coeff: torch.Tensor, qp: int, size: int, bitdepth: int = 8,
             intra=True) -> torch.Tensor:
    """Scalar quantization with the 171/512 (intra) or 85/512 (inter)
    rounding offset.  ``intra`` is a bool, or a bool tensor over the
    leading (block) axes of coeff for mixed P-frame batches.  int32-safe:
    |coeff| fits int16."""
    scale, qbits, _, _ = quant_params(qp, size.bit_length() - 1, bitdepth)
    if isinstance(intra, bool):
        offset = (171 if intra else 85) << (qbits - 9)
    else:
        offset = torch.where(intra, 171, 85)[..., None, None] << (qbits - 9)
    c = coeff.to(torch.int32)
    level = torch.clamp((torch.abs(c) * scale + offset) >> qbits, 0, 32767)
    return torch.where(c < 0, -level, level)


def dequantize(level: torch.Tensor, qp: int, size: int,
               bitdepth: int = 8) -> torch.Tensor:
    """Spec scaling with the *16 folded into the shift (int32-safe:
    |level| * levScale << 8 < 2^31)."""
    _, _, inv_scale, shift = quant_params(qp, size.bit_length() - 1,
                                          bitdepth)
    d = (level.to(torch.int32) * (inv_scale << (qp // 6))
         + (1 << (shift - 5))) >> (shift - 4)
    return torch.clamp(d, -32768, 32767)
