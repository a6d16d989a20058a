"""The collocated motion of a coded P picture, for TMVP in later
pictures.

A copy of ``_motion_of`` from kvazaar_tpu/bitstream/decoder.py, verbatim
apart from its imports: the JAX package's oracle decoder imports jax, so
the port keeps only this host function of it.
"""

from __future__ import annotations

import numpy as np

from kvazaar_tpu_torch.bitstream.headers import StreamParams
from kvazaar_tpu_torch.bitstream.syntax import FrameData


def _motion_of(fd: FrameData, params: StreamParams, poc: int,
               ref_deltas):
    """Collocated-motion grids of a decoded P frame, for TMVP in later
    pictures (the decoder-side analogue of the cu_array the reference
    keeps per reference picture, src/inter.c:746)."""
    depth = int(fd.depth8[0, 0])
    s = params.ctu_size >> depth
    c8 = s // 8
    inter_map = fd.inter8[::c8, ::c8].astype(bool)
    mv = fd.mv8[::c8, ::c8].astype(np.int32)
    refg = fd.ref8[::c8, ::c8].astype(np.int32)
    ref_pocs = np.array([poc - d for d in ref_deltas], np.int32)
    refpoc = ref_pocs[np.clip(refg, 0, len(ref_deltas) - 1)]
    return dict(poc=poc, cu=s, inter=inter_map, mv=mv, refpoc=refpoc)
