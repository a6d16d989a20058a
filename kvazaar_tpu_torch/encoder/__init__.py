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
