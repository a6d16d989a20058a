"""Encoder layer of the port: mode search, wavefront reconstruction and
the frame encoder (counterparts of kvazaar_tpu/encoder/)."""

from __future__ import annotations

import functools


def plan_cached(fn):
    """Cache ``fn(plan, *args)`` per plan object.  IntraFramePlan holds
    numpy arrays and so is unhashable; plans come from geometry's
    lru-cached make_intra_plan, so identity is the natural key.  Each
    entry keeps its plan alive, which keeps the id from being reused."""
    cache = {}

    @functools.wraps(fn)
    def wrapper(plan, *args):
        key = (id(plan),) + args
        hit = cache.get(key)
        if hit is None:
            hit = cache.setdefault(key, (plan, fn(plan, *args)))
        return hit[1]

    return wrapper


def pix_dtype(bitdepth: int):
    """Device dtype of reconstructed sample planes: uint8 at 8-bit,
    int16 above (0..1023 at 10-bit; torch.uint16 has almost no
    kernels)."""
    import torch

    return torch.uint8 if bitdepth <= 8 else torch.int16


def host_pixels(t):
    """A device sample plane on the host as numpy: uint8 at 8-bit, the
    int16 planes of higher bit depths viewed as uint16 (their samples
    are never negative), the JAX package's recon dtypes; None stays."""
    if t is None:
        return None
    a = t.cpu().numpy()
    return a.view("<u2") if a.dtype == "int16" else a
