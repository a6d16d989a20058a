"""CABAC context model sets and their initialization values.

Init values are the ITU-T H.265 tables 9-5..9-32 constants (identical in
every HEVC codec; the reference keeps them in src/context.c:25-200).
Row index = slice type using the reference's enumeration (0=B, 1=P, 2=I),
matching how cabac_init maps initType.

The context *layout* here is our own: a flat named registry, grouped per
syntax element, sized exactly to what HEVC v1 Main profile needs.
"""

from __future__ import annotations

from kvazaar_tpu_torch.bitstream.cabac import ContextModel
from kvazaar_tpu_torch.constants import SLICE_B, SLICE_I, SLICE_P  # noqa: F401

CNU = 154  # "context not used" placeholder init value

# [B, P, I] rows per element.
INIT_VALUES = {
    "sao_merge": [[153], [153], [153]],
    "sao_type": [[160], [185], [200]],
    "split_flag": [[107, 139, 126], [107, 139, 126], [139, 141, 157]],
    "transquant_bypass": [[154], [154], [154]],
    "skip": [[197, 185, 201], [197, 185, 201], [CNU, CNU, CNU]],
    "merge_flag": [[154], [110], [CNU]],
    "merge_idx": [[137], [122], [CNU]],
    "pred_mode": [[134], [149], [CNU]],
    "part_size": [[154, 139, CNU, CNU], [154, 139, CNU, CNU],
                  [184, CNU, CNU, CNU]],
    "intra_mode": [[183], [154], [184]],
    "chroma_pred_mode": [[152], [152], [63]],
    "inter_dir": [[95, 79, 63, 31, 31], [95, 79, 63, 31, 31],
                  [CNU] * 5],
    "ref_pic": [[153, 153], [153, 153], [CNU, CNU]],
    "mvd": [[169, 198], [140, 198], [CNU, CNU]],
    "mvp_idx": [[168], [168], [CNU]],
    "qt_root_cbf": [[79], [79], [CNU]],
    "trans_subdiv": [[224, 167, 122], [124, 138, 94], [153, 138, 138]],
    # cbf_luma: 2 ctx; cbf_chroma (cb and cr share): 4+1 by trafo depth.
    "cbf_luma": [[153, 111], [153, 111], [111, 141]],
    "cbf_chroma": [[149, 92, 167, 154], [149, 107, 167, 154],
                   [94, 138, 182, 154]],
    "cu_qp_delta": [[154, 154], [154, 154], [154, 154]],
    # coded_sub_block_flag: 2 luma + 2 chroma.
    "sig_cg": [[121, 140, 61, 154], [121, 140, 61, 154],
               [91, 171, 134, 141]],
    # sig_coeff_flag: 27 luma + 15 chroma.
    "sig": [
        [170, 154, 139, 153, 139, 123, 123, 63, 124, 166,
         183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 170, 153, 138,
         138, 122, 121, 122, 121, 167, 151, 183, 140, 151, 183, 140],
        [155, 154, 139, 153, 139, 123, 123, 63, 153, 166,
         183, 140, 136, 153, 154, 166, 183, 140, 136, 153,
         154, 166, 183, 140, 136, 153, 154, 170, 153, 123,
         123, 107, 121, 107, 121, 167, 151, 183, 140, 151, 183, 140],
        [111, 111, 125, 110, 110, 94, 124, 108, 124, 107,
         125, 141, 179, 153, 125, 107, 125, 141, 179, 153,
         125, 107, 125, 141, 179, 153, 125, 140, 139, 182,
         182, 152, 136, 152, 136, 153, 136, 139, 111, 136, 139, 111],
    ],
    # last_sig_coeff_{x,y}_prefix: 15 luma + 3 chroma each, same inits.
    "last_x": [
        [125, 110, 124, 110, 95, 94, 125, 111, 111, 79, 125, 126, 111,
         111, 79, 108, 123, 93],
        [125, 110, 94, 110, 95, 79, 125, 111, 110, 78, 110, 111, 111,
         95, 94, 108, 123, 108],
        [110, 110, 124, 125, 140, 153, 125, 127, 140, 109, 111, 143,
         127, 111, 79, 108, 123, 63],
    ],
    # coeff_abs_level_greater1_flag: 16 luma + 8 chroma.
    "gt1": [
        [154, 196, 167, 167, 154, 152, 167, 182, 182, 134, 149, 136,
         153, 121, 136, 122, 169, 208, 166, 167, 154, 152, 167, 182],
        [154, 196, 196, 167, 154, 152, 167, 182, 182, 134, 149, 136,
         153, 121, 136, 137, 169, 194, 166, 167, 154, 167, 137, 182],
        [140, 92, 137, 138, 140, 152, 138, 139, 153, 74, 149, 92,
         139, 107, 122, 152, 140, 179, 166, 182, 140, 227, 122, 197],
    ],
    # coeff_abs_level_greater2_flag: 4 luma + 2 chroma.
    "gt2": [[107, 167, 91, 107, 107, 167], [107, 167, 91, 122, 107, 167],
            [138, 153, 136, 167, 152, 152]],
    "transform_skip": [[139, 139], [139, 139], [139, 139]],
}
INIT_VALUES["last_y"] = INIT_VALUES["last_x"]


class Contexts:
    """All context models for one CABAC substream."""

    def __init__(self, slice_type: int, qp: int):
        self.slice_type = slice_type
        self.qp = qp
        self._groups: dict[str, list[ContextModel]] = {}
        for name, rows in INIT_VALUES.items():
            self._groups[name] = [ContextModel(v, qp)
                                  for v in rows[slice_type]]

    def __call__(self, name: str, idx: int = 0) -> ContextModel:
        return self._groups[name][idx]

    def copy_from(self, other: "Contexts") -> None:
        """WPP row-to-row context inheritance (reference:
        kvz_context_copy, src/context.c:293)."""
        for name, models in self._groups.items():
            for dst, src in zip(models, other._groups[name]):
                dst.copy_from(src)

    def clone(self) -> "Contexts":
        c = Contexts(self.slice_type, self.qp)
        c.copy_from(self)
        return c
