"""Device profile of the port's two paths on one NVIDIA GPU.

    python3 chip_profile.py

Encodes the chip_smoke clips through ``Encoder.encode_stream`` on the
card (all-intra: the 8-frame clip x 4 after one warm-up batch; IPPP:
the 46-frame clip's first 6 frames as warm-up, then its last 40 as P
frames continuing that stream), first untraced and then under
``torch.profiler``, and prints per path one JSON line: wall time
untraced and traced, the device's busy time and share of the traced
wall time (union of kernel and memcpy intervals), the kernels and
copies per frame, and the device time by kernel name.  The card's name and power limit come first.  Needs a
CUDA device; exits nonzero without one.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def busy_us(events) -> float:
    """Union length of the device intervals of a profiler trace."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type.name == "CUDA")
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile_path(torch, name, make_encoder, warm, timed):
    from torch.profiler import ProfilerActivity, profile

    def run(enc):
        list(enc.encode_stream(warm))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = list(enc.encode_stream(timed))
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    wall, _ = run(make_encoder())
    enc = make_encoder()
    list(enc.encode_stream(warm))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        list(enc.encode_stream(timed))
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    events = prof.events()
    busy = busy_us(events)
    n_device = sum(1 for e in events if e.device_type.name == "CUDA")
    avgs = prof.key_averages()
    by_kernel = [(e.key, e.self_device_time_total) for e in avgs
                 if e.device_type.name == "CUDA"]
    if not by_kernel:        # kernels folded into their launching ops
        by_kernel = [(e.key, e.self_device_time_total) for e in avgs
                     if e.self_device_time_total > 0]
    by_kernel.sort(key=lambda kv: -kv[1])
    total = sum(t for _, t in by_kernel) or 1.0
    print(json.dumps({
        "path": name, "frames": len(timed), "wall_s": wall,
        "traced_wall_s": traced, "device_busy_us": busy,
        "device_busy_share": busy / (1e6 * traced),
        "device_ops_per_frame": n_device / len(timed),
        "device_time_by_kernel": [
            {"name": k[:120], "us": t, "share": t / total}
            for k, t in by_kernel[:15]]}), flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_profile: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from kvazaar_tpu_torch.api import Encoder
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    frames = cs.synth_clip_natural(cs.FRAMES, cs.W, cs.H, seed=0)
    profile_path(torch, "all-intra",
                 lambda: Encoder(cs.headline_config(cs.W, cs.H), "cuda"),
                 frames, frames * cs.TIMED_BATCHES)
    clip = cs.synth_clip_natural(cs.IPPP_WARM + cs.IPPP_TIMED, cs.W, cs.H,
                                 seed=0)
    # The timed stream continues the warm-up stream on the same encoder
    # (POC and the device reference carry over), so it is all P frames.
    profile_path(torch, "ippp",
                 lambda: Encoder(cs.ippp_config(cs.W, cs.H), "cuda"),
                 clip[:cs.IPPP_WARM], clip[cs.IPPP_WARM:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
