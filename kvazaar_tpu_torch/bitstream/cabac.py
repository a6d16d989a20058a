"""CABAC arithmetic coding engine (H.265 9.3.4), encoder and decoder.

We implement the *specification's* flush/renorm formulation (ivlLow /
ivlCurrRange / bitsOutstanding / PutBit, clauses 9.3.4.3.2-9.3.4.3.5)
rather than the low/bits_left/buffered_byte carry machinery the reference
uses (src/cabac.c:91-160) — both produce identical bits; the spec form is
simpler to reason about and to keep symmetric with the decoder, which we
need as a conformance oracle (SURVEY.md §4).

State tables are the spec's Table 9-46 (rangeTabLps) and Table 9-47
(transIdxLps); transIdxMps is min(s+1, 62).  These constants are mandated
bit-exactly by ITU-T H.265 and appear identically in every implementation.
"""

from __future__ import annotations

import numpy as np

# H.265 Table 9-46: rangeTabLps[pStateIdx][qRangeIdx].
RANGE_TAB_LPS = np.array([
    [128, 176, 208, 240], [128, 167, 197, 227], [128, 158, 187, 216],
    [123, 150, 178, 205], [116, 142, 169, 195], [111, 135, 160, 185],
    [105, 128, 152, 175], [100, 122, 144, 166], [95, 116, 137, 158],
    [90, 110, 130, 150], [85, 104, 123, 142], [81, 99, 117, 135],
    [77, 94, 111, 128], [73, 89, 105, 122], [69, 85, 100, 116],
    [66, 80, 95, 110], [62, 76, 90, 104], [59, 72, 86, 99],
    [56, 69, 81, 94], [53, 65, 77, 89], [51, 62, 73, 85],
    [48, 59, 69, 80], [46, 56, 66, 76], [43, 53, 63, 72],
    [41, 50, 59, 69], [39, 48, 56, 65], [37, 45, 54, 62],
    [35, 43, 51, 59], [33, 41, 48, 56], [32, 39, 46, 53],
    [30, 37, 43, 50], [29, 35, 41, 48], [27, 33, 39, 45],
    [26, 31, 37, 43], [24, 30, 35, 41], [23, 28, 33, 39],
    [22, 27, 32, 37], [21, 26, 30, 35], [20, 24, 29, 33],
    [19, 23, 27, 31], [18, 22, 26, 30], [17, 21, 25, 28],
    [16, 20, 23, 27], [15, 19, 22, 25], [14, 18, 21, 24],
    [14, 17, 20, 23], [13, 16, 19, 22], [12, 15, 18, 21],
    [12, 14, 17, 20], [11, 14, 16, 19], [11, 13, 15, 18],
    [10, 12, 15, 17], [10, 12, 14, 16], [9, 11, 13, 15],
    [9, 11, 12, 14], [8, 10, 12, 14], [8, 9, 11, 13],
    [7, 9, 11, 12], [7, 9, 10, 12], [7, 8, 10, 11],
    [6, 8, 9, 11], [6, 7, 9, 10], [6, 7, 8, 9], [2, 2, 2, 2],
], dtype=np.int32)

# H.265 Table 9-47: transIdxLps[pStateIdx].
TRANS_IDX_LPS = np.array([
    0, 0, 1, 2, 2, 4, 4, 5, 6, 7, 8, 9, 9, 11, 11, 12,
    13, 13, 15, 15, 16, 16, 18, 18, 19, 19, 21, 21, 22, 23, 23, 24,
    24, 25, 26, 26, 27, 27, 28, 29, 29, 30, 30, 30, 31, 32, 32, 33,
    33, 33, 34, 34, 35, 35, 35, 36, 36, 36, 37, 37, 37, 38, 38, 63,
], dtype=np.int32)

TRANS_IDX_MPS = np.minimum(np.arange(64) + 1, 62).astype(np.int32)


def context_init_state(init_value: int, qp: int) -> tuple[int, int]:
    """(pStateIdx, valMps) from an 8-bit init value (H.265 9.3.2.2)."""
    slope = (init_value >> 4) * 5 - 45
    offset = ((init_value & 15) << 3) - 16
    qp = min(max(qp, 0), 51)
    pre = min(max(1, ((slope * qp) >> 4) + offset), 126)
    if pre <= 63:
        return 63 - pre, 0
    return pre - 64, 1


class ContextModel:
    __slots__ = ("state", "mps")

    def __init__(self, init_value: int, qp: int):
        self.state, self.mps = context_init_state(init_value, qp)

    def copy_from(self, other: "ContextModel") -> None:
        self.state = other.state
        self.mps = other.mps


# Fractional-bit cost of coding a bin in a given context state, 1/32768 bit
# units (the reference's kvz_entropy_bits idea, src/rdo.h:69-77, derived
# from the CABAC state probabilities p_lps(s) = 0.5 * alpha**s).
_ALPHA = (0.01875 / 0.5) ** (1.0 / 63)
_P_LPS = 0.5 * _ALPHA ** np.arange(64)
ENTROPY_BITS_LPS = np.round(-np.log2(_P_LPS) * 32768).astype(np.int64)
ENTROPY_BITS_MPS = np.round(-np.log2(1.0 - _P_LPS) * 32768).astype(np.int64)


class CabacEncoder:
    """Arithmetic encoder writing into a BitWriter."""

    def __init__(self, writer):
        self.writer = writer
        self.low = 0
        self.range = 510
        self.bits_outstanding = 0
        self.first_bit = True

    def _put_bit(self, b: int) -> None:
        if self.first_bit:
            self.first_bit = False
        else:
            self.writer.bit(b)
        while self.bits_outstanding > 0:
            self.writer.bit(1 - b)
            self.bits_outstanding -= 1

    def _renorm(self) -> None:
        # RenormE flowchart: low is a 10-bit register; emit bit 1 when the
        # interval base clears the half-point 0x200, bit 0 when the whole
        # interval (range < 0x100 here) sits below 0x100; otherwise the
        # straddle case defers the bit via bitsOutstanding.
        while self.range < 256:
            if self.low >= 512:
                self._put_bit(1)
                self.low -= 512
            elif self.low < 256:
                self._put_bit(0)
            else:
                self.low -= 256
                self.bits_outstanding += 1
            self.range <<= 1
            self.low <<= 1

    def encode_bin(self, ctx: ContextModel, bin_val: int) -> None:
        lps = int(RANGE_TAB_LPS[ctx.state, (self.range >> 6) & 3])
        self.range -= lps
        if bin_val != ctx.mps:
            self.low += self.range
            self.range = lps
            if ctx.state == 0:
                ctx.mps = 1 - ctx.mps
            ctx.state = int(TRANS_IDX_LPS[ctx.state])
        else:
            ctx.state = int(TRANS_IDX_MPS[ctx.state])
        self._renorm()

    def encode_bypass(self, bin_val: int) -> None:
        self.low <<= 1
        if bin_val:
            self.low += self.range
        if self.low >= 1024:
            self._put_bit(1)
            self.low -= 1024
        elif self.low < 512:
            self._put_bit(0)
        else:
            self.low -= 512
            self.bits_outstanding += 1

    def encode_bypass_bins(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.encode_bypass((value >> i) & 1)

    def encode_terminate(self, bin_val: int) -> None:
        self.range -= 2
        if bin_val:
            self.low += self.range
            self.range = 2
            self._renorm()
            self.flush()
        else:
            self._renorm()

    def flush(self) -> None:
        """EncodeFlush (9.3.4.3.5).  The final written bit equals 1 and
        serves as the rbsp_stop_one_bit; caller only needs to zero-align."""
        self._put_bit((self.low >> 9) & 1)
        self.writer.u(((self.low >> 7) & 3) | 1, 2)


class CabacDecoder:
    """Arithmetic decoder reading from a BitReader, symmetric to
    CabacEncoder (H.265 9.3.4.3 decoding process)."""

    def __init__(self, reader):
        self.reader = reader
        self.range = 510
        self.offset = reader.u(9)

    def decode_bin(self, ctx: ContextModel) -> int:
        lps = int(RANGE_TAB_LPS[ctx.state, (self.range >> 6) & 3])
        self.range -= lps
        if self.offset >= self.range:
            bin_val = 1 - ctx.mps
            self.offset -= self.range
            self.range = lps
            if ctx.state == 0:
                ctx.mps = 1 - ctx.mps
            ctx.state = int(TRANS_IDX_LPS[ctx.state])
        else:
            bin_val = ctx.mps
            ctx.state = int(TRANS_IDX_MPS[ctx.state])
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.reader.bit()
        return bin_val

    def decode_bypass(self) -> int:
        self.offset = (self.offset << 1) | self.reader.bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_bypass_bins(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.decode_bypass()
        return v

    def decode_terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self.reader.bit()
        return 0
