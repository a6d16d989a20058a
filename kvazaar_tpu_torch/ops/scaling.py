"""Scaling lists (quantization matrices), H.265 7.3.4 / 8.6.3.

Counterpart of kvazaar_tpu/ops/scaling.py (numpy only, the same code):
the spec's default lists, HM/kvazaar cqmfile parsing, SPS
scaling_list_data() and the per-position quant / dequant multiplier
tables, one per (size, intra/inter, component, qp%6), which the
quantizers of ops/quant.py and the wavefront kernel's scaling-list
instances take in place of the flat scale.

int32 safety: |coeff| <= 32767 and qc = (scale<<4)//m, so m >= 8 keeps
|coeff|*qc < 2^31.  validate() enforces m >= 8 for custom matrices
(defaults are >= 16).
"""

from __future__ import annotations

import numpy as np

from kvazaar_tpu_torch.ops.quant import INV_QUANT_SCALES, QUANT_SCALES

# Spec Table 7-5 (flat 4x4) and 7-6 (default 8x8), raster order —
# identical constants in src/scalinglist.c:34-64.
DEFAULT_4X4 = np.full((4, 4), 16, np.int32)

DEFAULT_INTRA_8X8 = np.array([
    [16, 16, 16, 16, 17, 18, 21, 24],
    [16, 16, 16, 16, 17, 19, 22, 25],
    [16, 16, 17, 18, 20, 22, 25, 29],
    [16, 16, 18, 21, 24, 27, 31, 36],
    [17, 17, 20, 24, 30, 35, 41, 47],
    [18, 19, 22, 27, 35, 44, 54, 65],
    [21, 22, 25, 31, 41, 54, 70, 88],
    [24, 25, 29, 36, 47, 65, 88, 115]], np.int32)

DEFAULT_INTER_8X8 = np.array([
    [16, 16, 16, 16, 17, 18, 20, 24],
    [16, 16, 16, 17, 18, 20, 24, 25],
    [16, 16, 17, 18, 20, 24, 25, 28],
    [16, 17, 18, 20, 24, 25, 28, 33],
    [17, 18, 20, 24, 25, 28, 33, 41],
    [18, 20, 24, 25, 28, 33, 41, 54],
    [20, 24, 25, 28, 33, 41, 54, 71],
    [24, 25, 28, 33, 41, 54, 71, 91]], np.int32)


def size_id(size: int) -> int:
    return {4: 0, 8: 1, 16: 2, 32: 3}[size]


def matrix_id(size: int, intra: bool, comp: int) -> int:
    """sizeId < 3: (intra ? 0 : 3) + comp (0=Y 1=Cb 2=Cr); 32x32 has
    luma only: 0 intra / 1 inter."""
    if size == 32:
        assert comp == 0
        return 0 if intra else 1
    return (0 if intra else 3) + comp


def default_base(size: int, intra: bool) -> np.ndarray:
    """The 8x8 (or 4x4) base matrix the defaults derive from."""
    if size == 4:
        return DEFAULT_4X4
    return DEFAULT_INTRA_8X8 if intra else DEFAULT_INTER_8X8


def upsample(base: np.ndarray, size: int, dc: int) -> np.ndarray:
    """m[y][x] = base[y/ratio][x/ratio]; DC position overridden for
    16/32 (7.4.5 semantics; kvz_scalinglist_process_enc ratio walk)."""
    ratio = size // base.shape[0]
    m = np.kron(base, np.ones((max(ratio, 1), max(ratio, 1)),
                              np.int32)) if ratio > 1 else base.copy()
    m = m[:size, :size].astype(np.int32)
    if ratio > 1:
        m[0, 0] = dc
    return m


def diag_scan_order(n: int) -> np.ndarray:
    """(n*n, 2) list of (y, x) in up-right diagonal scan (6.5.3)."""
    out = []
    x = y = 0
    while len(out) < n * n:
        out.append((y, x))
        if y == 0 or x == n - 1:
            # move to next diagonal
            d = x + y + 1
            y = min(d, n - 1)
            x = d - y
        else:
            y -= 1
            x += 1
    return np.array(out, np.int32)


class ScalingLists:
    """Resolved scaling-list state: per (size, matrixId) base matrices
    (8x8 for sizes >= 8) + DC values; builds device quant/dequant
    tensors.  mode: 'default' (SPS signals default lists) or 'custom'
    (lists from a cqmfile, signalled in scaling_list_data())."""

    def __init__(self, mode: str = "default", custom=None, dc=None):
        assert mode in ("default", "custom")
        self.mode = mode
        # custom[(size_id, matrix_id)] -> base matrix (4x4 or 8x8
        # raster); dc[(size_id, matrix_id)] -> int.
        self.custom = custom or {}
        self.dc = dc or {}

    def base(self, size: int, intra: bool, comp: int):
        sid = size_id(size)
        mid = matrix_id(size, intra, comp)
        if self.mode == "custom" and (sid, mid) in self.custom:
            b = self.custom[(sid, mid)]
            d = self.dc.get((sid, mid), 16)
            return b, d
        return default_base(size, intra), 16

    def m(self, size: int, intra: bool, comp: int) -> np.ndarray:
        b, d = self.base(size, intra, comp)
        return upsample(b, size, d)

    def qc(self, size: int, intra: bool, comp: int) -> np.ndarray:
        """Per-position quant multiplier table for one qp%6 axis:
        (6, N, N) int32, qc = (scale<<4) // m (DC already folded)."""
        m = self.m(size, intra, comp)
        return ((QUANT_SCALES.astype(np.int64)[:, None, None] << 4)
                // m[None]).astype(np.int32)

    def dqc(self, size: int, intra: bool, comp: int) -> np.ndarray:
        """Per-position dequant multiplier: (6, N, N) int32,
        dqc = inv_scale * m."""
        m = self.m(size, intra, comp)
        return (INV_QUANT_SCALES[:, None, None] * m[None]) \
            .astype(np.int32)

    def validate(self):
        for (sid, mid), b in self.custom.items():
            if b.min() < 8:
                raise ValueError(
                    "custom scaling-list entries below 8 exceed the "
                    "int32-exact device quantizer range")
        for d in self.dc.values():
            if d < 8:
                raise ValueError("custom scaling-list DC below 8")
        return self


# kvazaar cqmfile section names (src/scalinglist.c:135-178), raster
# coefficient order as actually consumed by the reference.
_CQM_NAMES = {
    (0, 0): "INTRA4X4_LUMA", (0, 1): "INTRA4X4_CHROMAU",
    (0, 2): "INTRA4X4_CHROMAV", (0, 3): "INTER4X4_LUMA",
    (0, 4): "INTER4X4_CHROMAU", (0, 5): "INTER4X4_CHROMAV",
    (1, 0): "INTRA8X8_LUMA", (1, 1): "INTRA8X8_CHROMAU",
    (1, 2): "INTRA8X8_CHROMAV", (1, 3): "INTER8X8_LUMA",
    (1, 4): "INTER8X8_CHROMAU", (1, 5): "INTER8X8_CHROMAV",
    (2, 0): "INTRA16X16_LUMA", (2, 1): "INTRA16X16_CHROMAU",
    (2, 2): "INTRA16X16_CHROMAV", (2, 3): "INTER16X16_LUMA",
    (2, 4): "INTER16X16_CHROMAU", (2, 5): "INTER16X16_CHROMAV",
    (3, 0): "INTRA32X32_LUMA", (3, 1): "INTER32X32_LUMA",
}


def parse_cqmfile(path: str) -> ScalingLists:
    """Parse the HM/kvazaar custom-quant-matrix file format
    (kvz_scalinglist_parse, src/scalinglist.c:130-255): per-matrix
    sections of comma/newline-separated integers (1..255), plus _DC
    entries for 16x16/32x32."""
    text = open(path).read()

    def read_ints(after: str, count: int):
        i = text.find(after)
        if i < 0:
            raise ValueError(f"cqmfile: missing section {after}")
        vals = []
        import re
        for tok in re.findall(r"-?\d+", text[i + len(after):]):
            vals.append(int(tok))
            if len(vals) == count:
                break
        if len(vals) < count:
            raise ValueError(f"cqmfile: short section {after}")
        if any(not 1 <= v <= 255 for v in vals):
            raise ValueError(f"cqmfile: values out of [1,255] in "
                             f"{after}")
        return vals

    custom, dc = {}, {}
    for (sid, mid), name in _CQM_NAMES.items():
        n = 4 if sid == 0 else 8
        vals = read_ints(name + "\n", n * n)
        custom[(sid, mid)] = np.array(vals, np.int32).reshape(n, n)
        if sid >= 2:
            dc[(sid, mid)] = read_ints(name + "_DC", 1)[0]
    return ScalingLists("custom", custom, dc).validate()


def write_scaling_list_data(w, sl: ScalingLists) -> None:
    """scaling_list_data() (7.3.4) for the SPS: delta coding in
    up-right diagonal scan, DC signalled for 16/32."""
    sizes = {0: 4, 1: 8, 2: 16, 3: 32}
    for sid in range(4):
        mids = (0, 1) if sid == 3 else range(6)
        for mid in mids:
            if sl.mode == "default" or (sid, mid) not in sl.custom:
                w.u(0, 1)        # scaling_list_pred_mode_flag = 0
                w.ue(0)          # pred_matrix_id_delta = 0 -> default
                continue
            w.u(1, 1)            # explicit coefficients
            n = 4 if sid == 0 else 8
            base = sl.custom[(sid, mid)]
            if sid >= 2:
                d = sl.dc.get((sid, mid), 16)
                w.se(d - 8)      # scaling_list_dc_coef_minus8
            order = diag_scan_order(n)
            next_coef = 8
            for (y, x) in order:
                v = int(base[y, x])
                delta = (v - next_coef) % 256
                if delta > 127:
                    delta -= 256
                w.se(delta)
                next_coef = v
