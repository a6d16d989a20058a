"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives kvazaar_tpu_torch's main path (all-intra 832x480 4:2:0, QP 22,
fixed 16x16 CUs, rd 1, deblocking on, WPP on) through the public
``Encoder.encode_stream`` on the card, in phases; any failed phase
raises, so the script exits nonzero:

1. the card's name and power limit (nvidia-smi);
2. build the wavefront kernel from kvazaar_tpu_torch/csrc/ (nvcc);
3. kernel vs its plain PyTorch version on the card at the main path's
   shapes (luma S=16 over 8 frames, Cb+Cr S=8 over 16 planes) and the
   cu=8 shapes, with the searched modes and with random modes: levels
   and recon must be exactly equal;
4. encode a seeded video-like clip on the card, timed after one warm-up
   batch, with the kernel's launch count read around the run; then a
   per-stage split of one batch (search, recon kernel, deblock, D2H,
   CABAC);
5. encode the first 2 frames again on the CPU (plain path): the stream
   bytes must equal the card's.

The kernels' JSON record and the card's name and power limit come
just before the last line, ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside the repository, it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

W, H, QP, FRAMES, BATCH, TIMED_BATCHES = 832, 480, 22, 8, 8, 4


def synth_clip_natural(n, w, h, seed=0):
    """Video-like synthetic content: smooth gradients, moving edges and
    spatially-correlated texture (copy of bench.py's generator)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)

    def blur(a):
        k = np.array([1.0, 4, 6, 4, 1])
        k /= k.sum()
        a = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 1, a)
        return np.apply_along_axis(
            lambda c: np.convolve(c, k, mode="same"), 0, a)

    tex = blur(blur(rng.normal(0, 30, (h, w))))
    texc = blur(rng.normal(0, 20, (h // 2, w // 2)))
    frames = []
    for i in range(n):
        dx = 3.1 * i
        dy_ = 1.7 * i
        y = (120 + 55 * np.sin((xx + dx) / 37.0)
             * np.cos((yy + dy_) / 29.0)
             + 25 * ((((xx + 2 * dx) // 64) + ((yy + dy_) // 48)) % 2)
             + np.roll(tex, (int(dy_), int(dx)), (0, 1)))
        cb = (118 + 28 * np.sin((xx[::2, ::2] + dx) / 53.0)
              + np.roll(texc, int(dx) // 2, 1))
        cr = (132 + 24 * np.cos((yy[::2, ::2] + dy_) / 41.0)
              + np.roll(texc, int(dy_) // 2, 0))
        frames.append(tuple(np.clip(p, 0, 255).astype(np.uint8)
                            for p in (y, cb, cr)))
    return frames


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, reps):
    """Mean device time of fn() over reps runs (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def headline_config(width, height, cu=16):
    from kvazaar_tpu_torch import Config
    return Config(width=width, height=height, qp=QP, intra_max_cu=cu,
                  intra_min_cu=cu, intra_period=1, rd=1, deblock=True,
                  sao=False, rdoq=False, signhide=False,
                  transform_skip=False, wpp=True)


def compare_kernel(torch, frames, dev):
    """Phase 3: kernel == plain on the card; returns per-shape rows.

    Each shape runs with the searched modes (timed) and with uniform
    random modes, which reach every one of the 35 modes."""
    from kvazaar_tpu_torch.encoder.frame_encoder import IntraFrameEncoder
    from kvazaar_tpu_torch.encoder.intra_recon import wavefront_recon_plain
    from kvazaar_tpu_torch.encoder.intra_search import search_frame_modes
    from kvazaar_tpu_torch.ops.wavefront import wavefront_recon

    def max_err(args):
        rec, lv = wavefront_recon(*args)
        prec, plv = wavefront_recon_plain(*args)
        torch.cuda.synchronize()
        return max((rec.int() - prec.int()).abs().max().item(),
                   (lv.int() - plv.int()).abs().max().item())

    ys = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    cs = torch.from_numpy(np.stack([f[1] for f in frames]
                                   + [f[2] for f in frames])).to(dev)
    rng = np.random.default_rng(1)
    rows = []
    for cu in (16, 8):
        ife = IntraFrameEncoder(headline_config(W, H, cu), device=dev)
        plan = ife.plan
        modes = torch.stack([search_frame_modes(y, plan, ife.lambda_satd)[0]
                             for y in ys])
        random_modes = torch.from_numpy(rng.integers(
            0, 35, tuple(modes.shape), dtype=np.int32)).to(dev)
        for orig, s, luma, qp in ((ys, cu, True, QP),
                                  (cs, cu // 2, False, ife.qp_c)):
            args = (orig.to(torch.int32), modes, plan, s, luma, qp)
            err = max(max_err(args),
                      max_err((args[0], random_modes) + args[2:]))
            ms = cuda_ms(torch, lambda: wavefront_recon(*args), 20)
            plain_ms = cuda_ms(torch, lambda: wavefront_recon_plain(*args),
                               2)
            row = dict(cu=cu, s=s, luma=luma, items=orig.shape[0],
                       max_abs_err=err, ms=ms, plain_ms=plain_ms)
            log("kernel vs plain:", json.dumps(row))
            if err != 0:
                raise RuntimeError(f"kernel != plain at {row}")
            rows.append(row)
    return rows


def stage_split(torch, ife, frames):
    """Per-stage times of one batch (device stages by CUDA events, the
    host stages by wall clock)."""
    from kvazaar_tpu_torch.encoder.intra_recon import reconstruct_frames
    from kvazaar_tpu_torch.encoder.intra_search import search_frame_modes
    from kvazaar_tpu_torch.ops.deblock import deblock_frame

    def up(a):
        return torch.from_numpy(a).to(ife.device).to(torch.int32)

    ys, cbs, crs = (up(a) for a in ife.host_pack_sources(frames))
    torch.cuda.synchronize()
    out = {}
    box = {}

    def search():
        box["modes"] = torch.stack([
            search_frame_modes(y, ife.plan, ife.lambda_satd, 8, True)[0]
            for y in ys])

    def recon():
        box["rec"] = reconstruct_frames(ys, cbs, crs, box["modes"],
                                        ife.plan, QP, ife.qp_c)

    def deblock():
        r = box["rec"]
        box["dbk"] = deblock_frame(r[0], r[2], r[4], QP, ife.cu)

    for name, fn in (("search", search), ("recon_kernel", recon),
                     ("deblock", deblock)):
        fn()                                            # warm
        out[name + "_ms"] = cuda_ms(torch, fn, 3)
    handle = ife.submit_frames(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dl = ife.download_frames(handle, need_recon=True)
    out["d2h_ms"] = 1000 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ife.finalize_downloaded(dl)
    out["cabac_ms"] = 1000 * (time.perf_counter() - t0)
    return {k: v / len(frames) for k, v in out.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # Outside a checkout of the repository these imports fail before
    # anything is printed.
    import kvazaar_tpu_torch
    from kvazaar_tpu_torch.api import Encoder
    from kvazaar_tpu_torch.bitstream import native
    from kvazaar_tpu_torch.ops import wavefront
    dev = kvazaar_tpu_torch.require_cuda()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log("nvidia-smi:", smi)
    log("python", sys.version.split()[0], "torch", torch.__version__,
        "cuda", torch.version.cuda)

    t0 = time.perf_counter()
    wavefront.build(verbose=True)
    log(f"kernel build: {time.perf_counter() - t0:.3f} s")

    frames = synth_clip_natural(FRAMES, W, H, seed=0)
    rows = compare_kernel(torch, frames, dev)

    cfg = headline_config(W, H)
    enc = Encoder(cfg, device="cuda")
    warm = [r[0] for r in enc.encode_stream(frames[:BATCH])]  # warm-up
    torch.cuda.synchronize()
    clip = frames * TIMED_BATCHES
    wavefront.LAUNCHES = 0
    t0 = time.perf_counter()
    results = list(enc.encode_stream(clip))
    dt = time.perf_counter() - t0
    launches = wavefront.LAUNCHES
    if launches == 0:
        raise RuntimeError("the main path never launched the kernel")
    if len(results) != len(clip):
        raise RuntimeError(f"{len(results)} results for {len(clip)} frames")
    bits = [r[1].bits for r in results]
    psnr_y = [r[1].psnr_y for r in results]
    if not all(b > 0 for b in bits) or not all(
            math.isfinite(p) and 30.0 < p < 99.0 for p in psnr_y):
        raise RuntimeError(f"implausible output: bits {bits} "
                           f"PSNR-Y {psnr_y}")
    summary = dict(frames=len(clip), batch=BATCH, fps=len(clip) / dt,
                   bits_per_frame=sum(bits) / len(bits),
                   psnr_y=sum(psnr_y) / len(psnr_y),
                   kernel_launches=launches,
                   native_cabac=native.available(),
                   stage_wall_s=enc.stats)
    log("encode_stream:", json.dumps(summary))
    split = stage_split(torch, enc._intra, frames[:BATCH])
    log("stage split (ms/frame, one batch of 8):", json.dumps(split))

    cpu = Encoder(headline_config(W, H), device="cpu")
    host = [r[0] for r in cpu.encode_stream(frames[:2])]
    if host != warm[:2]:
        raise RuntimeError("card and CPU streams differ")
    log("CPU plain path: first 2 frames byte-identical to the card")
    enc._intra.close()
    cpu._intra.close()

    main_rows = [r for r in rows if r["cu"] == 16]
    log(json.dumps({"kernels": [{
        "name": "wavefront_recon",
        "route": "cuda",
        "source": "kvazaar_tpu_torch/csrc/wavefront.cu",
        "replaces": "kvazaar_tpu/ops/wavefront_pallas.py:149",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows)}]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
