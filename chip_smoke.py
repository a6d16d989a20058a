"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives kvazaar_tpu_torch's two paths through the public
``Encoder.encode_stream`` on the card: all-intra 832x480 4:2:0, QP 22,
fixed 16x16 CUs, rd 1, deblocking on, WPP on; and low-delay IPPP of the
same configuration (one IDR, then P frames against the previous
deblocked frame, +-16 px full search with quarter-pel refinement).
Any failed phase raises, so the script exits nonzero:

1. the card's name and power limit (nvidia-smi);
2. build the wavefront kernel from kvazaar_tpu_torch/csrc/ (nvcc);
3. intra variant vs its plain PyTorch version on the card at the
   all-intra path's shapes (luma S=16 over 8 frames, Cb+Cr S=8 over 16
   planes) and the cu=8 shapes, with the searched modes and with random
   modes: levels and recon must be exactly equal;
4. inter variant vs its plain version at the P path's shapes (luma S=16
   over 1 frame, Cb+Cr S=8 over 2 planes; and cu 8), with the inter
   map, modes and MC planes of a real P frame and with random ones;
5. all-intra: encode a seeded video-like clip on the card, timed after
   one warm-up batch, with the kernel's launch counts read around the
   run; a per-stage split of one batch; the first 2 frames again on the
   CPU (plain path), whose bytes must equal the card's;
6. IPPP: encode a 46-frame clip with continuous motion on the card,
   timed over the last 40 frames after 6 warm-up frames, with the
   launch counts read around the run; a per-stage split of one P frame;
   the first 3 frames (IDR + 2 P) again on the CPU, byte-identical.

The kernels' JSON record and the card's name and power limit come just
before the last line, ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or outside the repository, it exits nonzero and prints no
result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

W, H, QP, FRAMES, BATCH, TIMED_BATCHES = 832, 480, 22, 8, 8, 4
IPPP_WARM, IPPP_TIMED = 6, 40
# Published H100 SXM peaks (NVIDIA's data sheet): HBM bandwidth, and the
# non-tensor-core float32 rate, the closest listed peak for the
# kernel's int32 multiply-adds.
PEAK_BYTES_S, PEAK_OPS_S = 3.35e12, 67e12


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


def ippp_config(width, height, cu=16):
    cfg = headline_config(width, height, cu)
    cfg.intra_period = 0
    return cfg


def bound_ms(args, outs, s):
    """Least time the card could take for one wavefront launch: each
    input read once (as the kernel reads it: int32 samples and modes,
    uint8 inter mask and MC planes) and each output written once over
    HBM bandwidth,
    against the transform's multiply-adds (4 stages of S, 2 operations
    each, per sample, plus about 20 for prediction and quantization)
    over the int32/float32 peak.  Returns (ms, "bytes"|"operations")."""
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs))
    ops = args[0].numel() * (8 * s + 20)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


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
            b_ms, b_by = bound_ms((args[0], modes),
                                  wavefront_recon(*args), s)
            row = dict(cu=cu, s=s, luma=luma, items=orig.shape[0],
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by)
            log("kernel vs plain:", json.dumps(row))
            if err != 0:
                raise RuntimeError(f"kernel != plain at {row}")
            rows.append(row)
    return rows


def compare_kernel_inter(torch, frames, dev):
    """Phase 4: the inter variant == plain on the card; returns rows.

    Each shape runs with the inter map, modes and MC planes of a real P
    frame (frame 1 searched against frame 0's deblocked recon; timed)
    and with random ones (inter with p = 0.5, uniform modes and MC
    samples)."""
    from kvazaar_tpu_torch.encoder.frame_encoder import IntraFrameEncoder
    from kvazaar_tpu_torch.encoder.intra_recon import wavefront_recon_plain
    from kvazaar_tpu_torch.ops.wavefront import wavefront_recon

    def max_err(args):
        rec, lv = wavefront_recon(*args)
        prec, plv = wavefront_recon_plain(*args)
        torch.cuda.synchronize()
        return max((rec.int() - prec.int()).abs().max().item(),
                   (lv.int() - plv.int()).abs().max().item())

    rng = np.random.default_rng(2)
    rows = []
    for cu in (16, 8):
        ife = IntraFrameEncoder(ippp_config(W, H, cu), device=dev)
        ife.submit_frames([frames[0]])       # DPB: frame 0, deblocked
        ys, cbs, crs = ife._upload(ife.host_pack_sources([frames[1]]))
        modes, inter_map, _mv, (mc_y, mc_cb, mc_cr) = ife._p_predict(
            ys[0], ife._dpb)
        plan = ife.plan

        def rand(shape, hi, dtype=np.int32):
            return torch.from_numpy(rng.integers(0, hi, shape,
                                                 dtype=dtype)).to(dev)

        rnd_inter = rand(tuple(inter_map.shape), 2) != 0
        rnd_modes = rand(tuple(modes.shape), 35)
        for orig, s, luma, qp, mc in (
                (ys, cu, True, QP, mc_y[None]),
                (torch.cat([cbs, crs]), cu // 2, False, ife.qp_c,
                 torch.stack([mc_cb, mc_cr]))):
            args = (orig, modes[None], plan, s, luma, qp, 8,
                    inter_map[None], mc.to(torch.uint8))
            rnd = (orig, rnd_modes[None], plan, s, luma, qp, 8,
                   rnd_inter[None], rand(tuple(mc.shape), 256, np.uint8))
            err = max(max_err(args), max_err(rnd))
            ms = cuda_ms(torch, lambda: wavefront_recon(*args), 20)
            plain_ms = cuda_ms(torch, lambda: wavefront_recon_plain(*args),
                               2)
            b_ms, b_by = bound_ms(
                (orig, modes, inter_map.to(torch.uint8), args[-1]),
                wavefront_recon(*args), s)
            row = dict(cu=cu, s=s, luma=luma, items=orig.shape[0],
                       inter_share=inter_map.float().mean().item(),
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by)
            log("inter kernel vs plain:", json.dumps(row))
            if err != 0:
                raise RuntimeError(f"inter kernel != plain at {row}")
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


def p_stage_split(torch, ife, frames):
    """Per-stage times of one P frame (frame 1 against frame 0's
    deblocked recon): device stages by CUDA events, host stages by wall
    clock, all in ms."""
    from kvazaar_tpu_torch.encoder.frame_encoder import compute_bs_maps
    from kvazaar_tpu_torch.encoder.inter_search import (
        _block_origins, mc_planes, search_inter_frame)
    from kvazaar_tpu_torch.encoder.intra_recon import reconstruct_frames
    from kvazaar_tpu_torch.encoder.intra_search import search_frame_modes
    from kvazaar_tpu_torch.ops.deblock import deblock_frame
    from kvazaar_tpu_torch.ops.inter import refine_qpel_dense, sad_surfaces

    ife.submit_frames([frames[0]])
    ref = ife._dpb
    ys, cbs, crs = ife._upload(ife.host_pack_sources([frames[1]]))
    yp, plan, s, r = ys[0], ife.plan, ife.cu, ife.cfg.me_range
    modes, inter_map, mv, mcs = ife._p_predict(yp, ref)
    mv_int, _ = search_inter_frame(yp, ref[0], plan, ife.lambda_me, r,
                                   subpel=False)
    x0s, y0s = _block_origins(plan, yp.device)
    n = plan.blocks_y * plan.blocks_x
    cur_blocks = yp.reshape(plan.blocks_y, s, plan.blocks_x, s).permute(
        0, 2, 1, 3).reshape(n, s, s)
    ref_y = ref[0].to(torch.int32)
    box = {}

    def recon():
        box["rec"] = reconstruct_frames(
            ys, cbs, crs, modes[None], plan, QP, ife.qp_c,
            is_inter=inter_map[None], mc_y=mcs[0][None],
            mc_cb=mcs[1][None], mc_cr=mcs[2][None])

    def deblock():
        rec = box["rec"]
        cbf = (rec[1][0] != 0).flatten(1).any(dim=1).reshape(
            plan.blocks_y, plan.blocks_x)
        bs_v, bs_h = compute_bs_maps(inter_map, cbf, mv)
        deblock_frame(rec[0], rec[2], rec[4], QP, s, bs_v=bs_v, bs_h=bs_h)

    stages = (
        ("intra_search", lambda: search_frame_modes(yp, plan,
                                                    ife.lambda_satd)),
        ("sad_surfaces", lambda: sad_surfaces(yp, ref_y, r, s)),
        ("qpel_refine", lambda: refine_qpel_dense(
            cur_blocks, ref_y, x0s, y0s, mv_int.reshape(n, 2), s)),
        ("mc", lambda: mc_planes(*ref, mv, plan)),
        ("recon_kernel", recon),
        ("deblock", deblock))
    out = {}
    for name, fn in stages:
        fn()                                            # warm
        out[name + "_ms"] = cuda_ms(torch, fn, 3)
    handle = ife.submit_p(*frames[1], [(0, ref)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dl = ife.download_p(handle, need_recon=True)
    out["d2h_ms"] = 1000 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ife.finalize_p_downloaded(dl, poc=1, ref_pocs=[0])
    out["cabac_ms"] = 1000 * (time.perf_counter() - t0)
    return out


def run_ippp(torch, wavefront, frames, dev):
    """Phase 6: IPPP through Encoder.encode_stream on the card, timed as
    bench.py's measure_ippp_fps times it (the last IPPP_TIMED frames
    after IPPP_WARM warm-up frames)."""
    from kvazaar_tpu_torch.api import Encoder
    enc = Encoder(ippp_config(W, H), device=dev)
    for k in wavefront.LAUNCHES:
        wavefront.LAUNCHES[k] = 0
    results = []
    t0 = t_all = time.perf_counter()
    for res in enc.encode_stream(frames):
        results.append(res)
        if len(results) == IPPP_WARM:
            t0 = time.perf_counter()
    dt = time.perf_counter() - t0
    launches = dict(wavefront.LAUNCHES)
    if min(launches.values()) == 0:
        raise RuntimeError(f"the IPPP path did not launch both kernel "
                           f"variants: {launches}")
    if len(results) != len(frames):
        raise RuntimeError(f"{len(results)} results for {len(frames)} "
                           "frames")
    bits = [r[1].bits for r in results]
    psnr_y = [r[1].psnr_y for r in results]
    kinds = [r[1].slice_type for r in results]
    if kinds[0] != 2 or any(k != 1 for k in kinds[1:]):
        raise RuntimeError(f"expected IDR + P frames, got {kinds}")
    if not all(b > 0 for b in bits) or not all(
            math.isfinite(p) and 30.0 < p < 99.0 for p in psnr_y):
        raise RuntimeError(f"implausible IPPP output: bits {bits} "
                           f"PSNR-Y {psnr_y}")
    summary = dict(frames=len(frames), timed=IPPP_TIMED,
                   fps=IPPP_TIMED / dt,
                   wall_s_all=time.perf_counter() - t_all,
                   idr_bits=bits[0],
                   p_bits_per_frame=sum(bits[1:]) / (len(bits) - 1),
                   psnr_y=sum(psnr_y) / len(psnr_y),
                   kernel_launches=launches, stage_wall_s=enc.stats)
    log("IPPP encode_stream:", json.dumps(summary))
    split = p_stage_split(torch, enc._intra, frames)
    log("IPPP stage split (ms, one P frame):", json.dumps(split))
    cpu = Encoder(ippp_config(W, H), device="cpu")
    host = [r[0] for r in cpu.encode_stream(frames[:3])]
    if host != [r[0] for r in results[:3]]:
        raise RuntimeError("IPPP: card and CPU streams differ")
    log("CPU plain path: first 3 IPPP frames byte-identical to the card")
    enc._intra.close()
    cpu._intra.close()
    return launches["inter"]


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
    clip46 = synth_clip_natural(IPPP_WARM + IPPP_TIMED, W, H, seed=0)
    inter_rows = compare_kernel_inter(torch, clip46, dev)

    cfg = headline_config(W, H)
    enc = Encoder(cfg, device="cuda")
    warm = [r[0] for r in enc.encode_stream(frames[:BATCH])]  # warm-up
    torch.cuda.synchronize()
    clip = frames * TIMED_BATCHES
    for k in wavefront.LAUNCHES:
        wavefront.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    results = list(enc.encode_stream(clip))
    dt = time.perf_counter() - t0
    launches = wavefront.LAUNCHES["intra"]
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

    inter_launches = run_ippp(torch, wavefront, clip46, dev)

    def record(name, replaces, n, rs):
        main_rows = [r for r in rs if r["cu"] == 16]
        # Luma and chroma launches of one main-path submission.
        return {"name": name, "route": "cuda",
                "source": "kvazaar_tpu_torch/csrc/wavefront.cu",
                "replaces": replaces, "launches": n,
                "max_abs_err": max(r["max_abs_err"] for r in rs),
                "ms": sum(r["ms"] for r in main_rows),
                "plain_ms": sum(r["plain_ms"] for r in main_rows),
                "bound_ms": sum(r["bound_ms"] for r in main_rows),
                "bound_by": main_rows[0]["bound_by"],
                "library_ms": None}

    log(json.dumps({"kernels": [
        record("wavefront_recon", "kvazaar_tpu/ops/wavefront_pallas.py:149",
               launches, rows),
        record("wavefront_recon_inter",
               "kvazaar_tpu/ops/wavefront_pallas.py:283", inter_launches,
               inter_rows)]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
