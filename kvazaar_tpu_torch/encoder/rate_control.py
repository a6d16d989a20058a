"""Rate control: the R-lambda model (reference: src/rate_control.c,
which cites Li et al., doi 10.1109/TIP.2014.2336550).

Host-side math (tiny), mirroring the reference's two levels for
low-delay coding:
- picture allocation: target bits spread over frames; lambda =
  alpha * (bits-per-pixel)^beta with post-frame alpha/beta adaptation
  (pic_allocate_bits src/rate_control.c:142, update_parameters :50);
- LCU allocation: the frame target split over CTUs proportionally to
  per-CTU complexity weights from the previous frame of the same type
  (lcu_allocate_bits :259), each CTU's lambda -> QP offset around the
  frame QP (kvz_set_lcu_lambda_and_qp :278), signalled with
  cu_qp_delta.  Our complexity proxy is the per-CTU absolute level sum
  (the reference uses coded bits from its lcu_stats, which live after
  CABAC — the level sum is available pre-CABAC on the device path and
  tracks it closely).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


#: Frames of look-back smoothing for GOP allocation (reference
#: SMOOTHING_WINDOW, src/rate_control.c:22).
SMOOTHING_WINDOW = 32


@dataclasses.dataclass
class RateControlState:
    target_bps: float
    fps: float
    alpha: float = 3.2003
    beta: float = -1.367
    buffer_bits: float = 0.0     # virtual buffer (+ = overspent)
    frames_coded: int = 0
    total_bits_coded: float = 0.0

    @property
    def bits_per_frame(self) -> float:
        return self.target_bps / self.fps


class RateController:
    """Frame-level R-lambda controller (reference:
    pic_allocate_bits src/rate_control.c:142, update_parameters :50)."""

    MIN_QP = 4
    MAX_QP = 47

    def __init__(self, target_bps: float, fps: float, width: int,
                 height: int):
        self.s = RateControlState(target_bps, fps)
        self.pixels = width * height

    def frame_lambda_qp(self, is_intra: bool = False):
        """(lambda, qp) for the next frame."""
        s = self.s
        # Smooth the buffer debt over a 16-frame window.
        target = s.bits_per_frame - s.buffer_bits / 16.0
        target = max(target, s.bits_per_frame * 0.1)
        bpp = target / self.pixels
        lam = s.alpha * (bpp ** s.beta)
        # I-frames get a lambda discount (they feed later frames).
        if is_intra:
            lam *= 0.57
        lam = min(max(lam, 0.1), 10000.0)
        qp = int(round(4.2005 * math.log(lam) + 13.7122))
        qp = min(max(qp, self.MIN_QP), self.MAX_QP)
        return lam, qp

    def allocate_gop(self, gop_table):
        """Per-picture bit targets for one GOP in coding order
        (reference gop_allocate_bits, src/rate_control.c:72: the GOP
        target is the deficit of the smoothed spending plan — average
        bits/picture over (frames_coded + SMOOTHING_WINDOW) minus what
        is already spent — scaled to the GOP length; pic_allocate_bits
        :142 then splits it over layers).  Layer weights follow the
        B-pyramid QP ladder: a picture qp_offset levels up the pyramid
        gets ~2^(-qp_offset/3) of the anchor's bits (the same ratio
        the reference's rate-dependent gop_layer_weights converge to).

        gop_table: coding-order (poc_off, l0, l1, qp_offset, qp_factor)
        entries.  Returns a list of per-picture bit targets."""
        s = self.s
        g = max(len(gop_table), 1)
        gop_target = (s.bits_per_frame
                      * (s.frames_coded + SMOOTHING_WINDOW)
                      - s.total_bits_coded) * g / SMOOTHING_WINDOW
        gop_target = max(200.0, gop_target)
        w = [2.0 ** (-qo / 3.0) for (_o, _l0, _l1, qo, _f) in gop_table]
        tot = sum(w)
        return [gop_target * wi / tot for wi in w]

    def pic_lambda_qp(self, target_bits: float):
        """(lambda, qp) hitting an explicit per-picture bit target (the
        R-lambda model applied to a GOP-allocated share rather than the
        flat per-frame budget)."""
        bpp = max(target_bits, 1.0) / self.pixels
        lam = self.s.alpha * (bpp ** self.s.beta)
        lam = min(max(lam, 0.1), 10000.0)
        qp = int(round(4.2005 * math.log(lam) + 13.7122))
        return lam, min(max(qp, self.MIN_QP), self.MAX_QP)

    def lcu_qp_map(self, frame_qp: int, shape, weights=None,
                   max_delta: int = 3):
        """Per-CTU QP map around the frame QP.

        weights: (Cy, Cx) non-negative complexity of each CTU from the
        previous frame of the same slice type (None/zero-sum -> flat
        map).  CTUs above the mean complexity get MORE bits (lower QP)
        in proportion to log2(w / mean), clipped to +-max_delta — the
        shape of the reference's lambda_lcu = alpha*(bpp_lcu)^beta
        allocation collapsed onto the QP ladder (4.2 * ln lambda)."""
        qmap = np.full(shape, frame_qp, np.int32)
        if weights is None:
            return qmap
        w = np.asarray(weights, np.float64).reshape(shape)
        mean = w.mean()
        if mean <= 0:
            return qmap
        # beta ~ -1.367: bits ratio r -> lambda ratio r^beta ->
        # dQP = 4.2005 * ln(r^beta) = 4.2005*beta*ln r; allocating
        # proportionally to weight w means r = w/mean.
        ln_r = np.log(np.maximum(w, mean * 0.05) / mean)
        dqp = np.rint(4.2005 * self.s.beta * ln_r * 0.5)
        qmap = frame_qp + np.clip(dqp, -max_delta, max_delta)
        return np.clip(qmap, self.MIN_QP, self.MAX_QP).astype(np.int32)

    @staticmethod
    def ctu_weights_from_levels(fd, width: int, height: int):
        """(Cy, Cx) complexity weights = per-CTU absolute level sums of
        a coded frame's FrameData (the lcu_stats feedback analogue,
        src/encoderstate.h:52-67)."""
        cy, cx = -(-height // 64), -(-width // 64)
        w = np.zeros((cy, cx), np.float64)
        pads = ((0, cy * 64 - fd.coeff_y.shape[0]),
                (0, cx * 64 - fd.coeff_y.shape[1]))
        yy = np.pad(np.abs(fd.coeff_y.astype(np.int64)), pads)
        w += yy.reshape(cy, 64, cx, 64).sum(axis=(1, 3))
        return w

    def update(self, used_bits: int, lam: float) -> None:
        """Post-frame alpha/beta adaptation (reference
        update_parameters, src/rate_control.c:50)."""
        s = self.s
        bpp = used_bits / self.pixels
        computed_lambda = s.alpha * (bpp ** s.beta)
        ln_ratio = math.log(lam) - math.log(computed_lambda)
        alpha_new = s.alpha + 0.1 * ln_ratio * s.alpha
        s.alpha = min(max(alpha_new, 0.05), 20.0)
        beta_new = s.beta + 0.05 * ln_ratio * math.log(max(bpp, 1e-6))
        s.beta = min(max(beta_new, -3.0), -0.1)
        s.buffer_bits += used_bits - s.bits_per_frame
        s.total_bits_coded += used_bits
        s.frames_coded += 1
