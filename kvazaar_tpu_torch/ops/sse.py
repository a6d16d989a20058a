"""Per-frame SSE in the JAX package's float32 summation order.

The JAX package sums ``d * d`` in float32 over each plane's conformance
window (``jnp.sum`` in its jitted frame programs).  Above 2^24 the float
result depends on the order of the additions, which XLA's CPU backend
fixes as follows (probed on the jitted expression for every final shape
up to 32 x 32 and for frames up to 3840x2160, at 8 and 10 bits):

- a reduction over a dimension longer than 32 is first rewritten into
  windows of 32 along it, the dimension zero-padded to a multiple of 32
  with the padding split evenly (the extra sample after); a window sums
  its samples one after the other in row-major order, starting from 0;
  this repeats while a dimension of the window sums is longer than 32;
- the last (R, C) grid, R and C at most 32, is summed in row-major
  order, except where LLVM vectorizes the row loop (``_lanes``): with
  V lanes, lane l adds rows l, V + l, 2V + l, ... (each row left to
  right), the lanes are added pairwise (lane i with lane i + V/2, down
  to one) and the rows past the last multiple of V follow one by one.

The squares are integers, so the device computes each window's sum
exactly in int64; a window whose sum is at most 2^24 is then exact in
float32 whatever the order.  ``FrameSse.host`` takes these sums to the
host and finishes the float32 sum there, in the order above, with
``np.add.accumulate`` (strictly left to right): only the windows above
2^24 fetch their squares from the device to be summed one by one.  The
card and the CPU thus give the same float, and both the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

WINDOW = 32
_EXACT = 1 << 24
_F32 = np.float32


def _pads(n: int):
    """(low pad, high pad, window) of one dimension of n samples."""
    if n <= WINDOW:
        return 0, 0, n
    m = -(-n // WINDOW)
    lo = (m * WINDOW - n) // 2
    return lo, m * WINDOW - n - lo, WINDOW


class PlaneSse:
    """One plane kind's squared differences of a batch on the device:
    the window sums (B, Mh, Mw) int64 and the zero-padded squares
    (B, Mh * wh, Mw * ww) int32 they come from."""

    def __init__(self, rec: torch.Tensor, src: torch.Tensor, height: int,
                 width: int):
        d = (rec[:, :height, :width].to(torch.int32)
             - src[:, :height, :width].to(torch.int32))
        (ht, hb, self.wh), (wl, wr, self.ww) = _pads(height), _pads(width)
        sq = torch.nn.functional.pad(d * d, (wl, wr, ht, hb))
        b = sq.shape[0]
        self.grid = (b, sq.shape[1] // self.wh, sq.shape[2] // self.ww)
        self.squares = sq
        self.totals = sq.reshape(b, self.grid[1], self.wh, self.grid[2],
                                 self.ww).sum(dim=(2, 4), dtype=torch.int64)

    def host(self) -> np.ndarray:
        """(B,) float32 sums in the JAX package's order."""
        totals = self.totals.cpu().numpy()
        sums = totals.astype(_F32)
        big = np.argwhere(totals > _EXACT)
        if len(big):
            b, mh, mw = self.grid
            win = self.squares.reshape(b, mh, self.wh, mw, self.ww)
            idx = torch.from_numpy(big).to(win.device)
            sq = win[idx[:, 0], idx[:, 1], :, idx[:, 2], :].reshape(
                len(big), -1).cpu().numpy()
            sums[tuple(big.T)] = np.add.accumulate(
                sq.astype(_F32), axis=1)[:, -1]
        return reduce_grid(sums)


def _windows(x: np.ndarray) -> np.ndarray:
    """One rewrite level: (B, R, C) float32 -> the (B, R', C') window
    sums, each window added left to right in row-major order."""
    b, r, c = x.shape
    (ht, hb, wh), (wl, wr, ww) = _pads(r), _pads(c)
    xp = np.pad(x, ((0, 0), (ht, hb), (wl, wr)))
    mh, mw = xp.shape[1] // wh, xp.shape[2] // ww
    w = xp.reshape(b, mh, wh, mw, ww).transpose(0, 1, 3, 2, 4)
    return np.add.accumulate(w.reshape(b, mh, mw, wh * ww), axis=-1,
                             dtype=_F32)[..., -1]


def _lanes(r: int, c: int) -> int:
    """Vector lanes of XLA's CPU loop over the rows of a final (r, c)
    grid (1: one add after the other), as LLVM's cost model picks them
    on this backend (probed at every r, c <= 32)."""
    if c <= 1 or c > 8 or r in (1, 3, 5, 6, 7) or 9 <= r <= 15:
        return 1
    if r in (2, 4, 8):
        return r
    if 20 <= r <= 23:
        return 4
    if 28 <= r <= 31:
        return 8 if c == 2 else 4
    return 8 if c <= 6 else 4


def reduce_grid(x: np.ndarray) -> np.ndarray:
    """(B, R, C) float32 window sums -> (B,) float32 totals."""
    while max(x.shape[1:]) > WINDOW:
        x = _windows(x)
    b, r, c = x.shape
    v = _lanes(r, c)
    nv = r // v
    lanes = x[:, :nv * v].reshape(b, nv, v, c).transpose(0, 2, 1, 3)
    acc = np.add.accumulate(lanes.reshape(b, v, nv * c), axis=-1,
                            dtype=_F32)[..., -1]
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = (acc[:, :h] + acc[:, h:]).astype(_F32)
    rest = np.concatenate([acc, x[:, nv * v:].reshape(b, -1)], axis=1)
    return np.add.accumulate(rest, axis=1, dtype=_F32)[:, -1]


class FrameSse:
    """The SSEs of a batch of frames (luma, Cb, Cr; a plane kind may be
    None), device parts until ``host``."""

    def __init__(self, planes):
        self.planes = planes

    def host(self) -> np.ndarray:
        """(B, 3) float32 SSEs, 0 for a missing plane kind."""
        cols = [None if p is None else p.host() for p in self.planes]
        b = next(c.shape[0] for c in cols if c is not None)
        return np.stack([np.zeros(b, _F32) if c is None else c
                         for c in cols], axis=1)
