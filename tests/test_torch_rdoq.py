"""The port's RDOQ, sign-data hiding and RDOQ rate table == the JAX
package's, exactly (tolerance 0).

kvazaar_tpu_torch.ops.quant (CPU tensors) against kvazaar_tpu.ops.quant
on its CPU backend, jitted with a traced QP and lambda as the
variable-tree reconstruction calls it:

- the float32 log table at every integer 2..32766 against
  ``jax.jit(jnp.log)``, the log2 derived from it against
  ``jax.jit(jnp.log2)``, and the remainder bits per level against the
  JAX expression as ``quantize_rdoq`` writes it, jitted (XLA fuses it
  into one multiply-add of the log, so it is not ``2 * log2 + 1``
  rounded twice);
- ``quantize_rdoq`` at S = 4, 8, 16, 32, intra and inter, three QPs, on
  seeded coefficients, on coefficients whose candidate levels tie to
  within an ulp at the chosen lambda (the decision then rests on the
  fused multiply-add and the rate table's last bit), and on 4x4 groups
  whose zeroing decision flips within a few ulps of lambda (the
  decision then rests on the order of the group's float32 sums);
- ``sign_hide`` at S = 4..32 for each scan index and per-block mixes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kvazaar_tpu.ops import quant as jquant
from kvazaar_tpu_torch.ops import quant as tquant

pytestmark = [pytest.mark.smoke, pytest.mark.torch_port]

# Small CPU shapes: one intra-op thread each, so that the xdist
# workers sharing the cores do not oversubscribe them.
torch.set_num_threads(1)

QPS = (22, 27, 37)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ulps(x, ks):
    """float32 values k ulps from x."""
    b = np.float32(x).view(np.int32)
    return [np.int32(b + k).view(np.float32) for k in ks]


def test_rate_table_matches_jax():
    a = np.arange(2, 32767, dtype=np.float32)
    np.testing.assert_array_equal(tquant.log_table_np()[2:32767],
                                  np.asarray(jax.jit(jnp.log)(a)))
    # jnp.log2 alone: the float32 log times float32(1 / ln 2).
    np.testing.assert_array_equal(
        tquant.log_table_np()[2:32767] * tquant._INV_LN2,
        np.asarray(jax.jit(jnp.log2)(a)))

    def rem_bits(lf):           # quantize_rdoq's expression
        rem = jnp.maximum(lf - 3, 0.0)
        return jnp.where(lf > 2, 2.0 * jnp.log2(rem + 2.0) + 1.0, 0.0)

    levels = np.arange(32768, dtype=np.float32)
    np.testing.assert_array_equal(tquant.rem_bits_np(),
                                  np.asarray(jax.jit(rem_bits)(levels)))


@functools.lru_cache(maxsize=None)
def _jax_rdoq(size):
    """JAX quantize_rdoq with traced QP and lambda (one compile)."""
    return jax.jit(lambda c, qp, lam, intra: jquant.quantize_rdoq(
        c, qp, size, 8, intra, lam), static_argnums=3)


def _both(c, qp, size, lam, intra):
    want = np.asarray(_jax_rdoq(size)(jnp.asarray(c), jnp.int32(qp),
                                      jnp.float32(lam), intra))
    got = tquant.quantize_rdoq(_t(c), qp, size, 8, intra, float(lam))
    assert got.dtype == torch.int32
    return got.numpy(), want


def _level_ties(rng, qp, size, n):
    """(|coeff|, lambda) pairs at which the two nonzero candidate levels'
    costs cross: lambda = (D(l-1) - D(l)) / (R(l) - R(l-1)), rounded to
    float32, for levels spread over the rate table (some at its
    corrected log entries)."""
    log2n = size.bit_length() - 1
    scale, qbits, inv_scale, inv_shift = tquant.quant_params(qp, log2n, 8)
    inv_m = inv_scale << (qp // 6)
    gain = np.float32(1.0 / 4 ** (15 - 8 - log2n))
    rb = tquant.rem_bits_np()

    def dist(level, ac):
        d = min(max((level * inv_m + (1 << (inv_shift - 5)))
                    >> (inv_shift - 4), -32768), 32767)
        e = np.float32(d - ac)
        return float(np.float32(e * e * gain))

    def rate(level):
        if level == 0:
            return 0.15
        return float(np.float32(np.float32(3.0 + (level > 1)) + rb[level]))

    odd = np.array(tquant._LOG_UP[:40] + tquant._LOG_DOWN[:40]) + 1
    out = []
    for ac in np.concatenate([rng.integers(1, 32767, 4 * n),
                              (odd << qbits) // scale]):
        ac = int(min(ac, 32767))
        l1 = min((ac * scale + (1 << (qbits - 1))) >> qbits, 32767)
        if l1 < 1:
            continue
        dr = rate(l1) - rate(l1 - 1)
        lam = (dist(l1 - 1, ac) - dist(l1, ac)) / dr if dr else 0.0
        if 0.5 < lam < 4000:
            out.append((ac, np.float32(lam)))
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("size", [4, 8, 16, 32])
@pytest.mark.parametrize("intra", [True, False], ids=["intra", "inter"])
def test_quantize_rdoq_matches_jax(size, intra):
    rng = np.random.default_rng(size + 100 * intra)
    n = max(4096 // (size * size), 2)
    for qp in QPS:
        # Seeded coefficients: log-uniform magnitudes, sparse blocks.
        mag = np.exp(rng.uniform(0, np.log(32767), (n, size, size)))
        c = (mag * rng.choice([-1, 1], (n, size, size))).astype(np.int32)
        c[rng.random((n, size, size)) < 0.6] //= 64
        c[::3, size // 2:, :] = 0
        for lam in (4.5, 57.0, 913.25):
            got, want = _both(c, qp, size, lam, intra)
            np.testing.assert_array_equal(got, want, err_msg=f"qp {qp}")
        # Candidate-level near-ties, a few ulps either side.
        for ac, lam in _level_ties(rng, qp, size, 12):
            blk = np.zeros((2, size, size), np.int32)
            blk[0, 0, 0], blk[1, -1, -1] = ac, -ac
            for lam_k in _ulps(lam, range(-3, 4)):
                got, want = _both(blk, qp, size, lam_k, intra)
                np.testing.assert_array_equal(
                    got, want, err_msg=f"qp {qp} |c| {ac} lam {lam_k!r}")


def _group_flip(c, qp, size):
    """The lambda (float32) at which the port first zeroes the first
    4x4 group of c, by bisection (None if no flip in 0.001..20000)."""
    def killed(lam):
        out = tquant.quantize_rdoq(_t(c), qp, size, 8, True, float(lam))
        return not out[0, :4, :4].any()

    lo, hi = np.float32(0.001), np.float32(20000)
    if killed(lo) or not killed(hi):
        return None
    while True:
        mid = np.float32((float(lo) + float(hi)) / 2)
        if mid in (lo, hi):
            return hi
        lo, hi = (lo, mid) if killed(mid) else (mid, hi)


@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_rdoq_group_zeroing_near_ties_match_jax(size):
    """Groups whose zeroing flips within an ulp of lambda: the decision
    compares float32 sums of 16 costs, so it pins their order."""
    rng = np.random.default_rng(7 + size)
    found = 0
    for _ in range(200):
        c = np.zeros((1, size, size), np.int32)
        amp = int(rng.choice([5, 20, 60, 200]))
        c[0, :4, :4] = rng.integers(-amp, amp, (4, 4)) * (
            rng.random((4, 4)) < rng.uniform(0.2, 1))
        qp = int(rng.choice(QPS))
        lam = _group_flip(c, qp, size) if c.any() else None
        if lam is None:
            continue
        for lam_k in _ulps(lam, (-2, -1, 0, 1)):
            got, want = _both(c, qp, size, lam_k, True)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"qp {qp} lam {lam_k!r}")
        found += 1
        if found == 6:
            break
    assert found == 6


@pytest.mark.parametrize("size", [4, 8, 16, 32])
def test_sign_hide_matches_jax(size):
    rng = np.random.default_rng(size)
    n = max(2048 // (size * size), 3)
    dens = rng.uniform(0.05, 1, (n, 1, 1))
    mag = rng.geometric(0.35, (n, size, size)) * (
        rng.random((n, size, size)) < dens)
    lv = (mag * rng.choice([-1, 1], (n, size, size))).astype(np.int32)
    lv[::4] = 0
    sign_hide = jax.jit(jquant.sign_hide)
    sels = [np.full(n, s, np.int32) for s in range(3)]
    sels.append(rng.integers(0, 3, n).astype(np.int32))
    for sel in sels:
        want = np.asarray(sign_hide(jnp.asarray(lv), jnp.asarray(sel)))
        got = tquant.sign_hide(_t(lv), _t(sel))
        assert (want != lv).any()
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"scan_sel {sel[:4]}")
