"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives kvazaar_tpu_torch's paths through the public
``Encoder.encode_stream`` on the card: all-intra 832x480 4:2:0, QP 22,
fixed 16x16 CUs, rd 1, deblocking on, WPP on; low-delay IPPP of the
same configuration (one IDR, then P frames against the previous
deblocked frame, +-16 px full search with quarter-pel refinement);
all-intra with variable CU trees (intra CUs 8..32); the ``superfast``,
``medium`` and ``slower`` presets at --period 1 (SAO; RDOQ; sign
hiding); and the low-delay default operating points (the ``ultrafast``
preset, the CLI's default, and ``Config()``, whose fixed cu 32 grid runs
the kernel at luma S=32), variable P trees with one reference (the
medium preset's IPPP point), B pyramids (GOP 8 on the fixed grid and
the medium preset's default, variable B trees), and rate control with a
per-CTU QP map (``--bitrate`` on ``Config()``), 10-bit (Main 10)
streams up to BASELINE config #5 (a 10-bit 3840x2160 GOP-8 stream with
``--bitrate``), lossless coding (transquant bypass, implicit RDPCM),
tiles and slices up to BASELINE config #4 (3x3 tiles with WPP at
1920x1080), RDOQ, sign hiding and --rd 2 / 3 on the fixed grid
(``--preset slower --gop lp-g4d4t1``, all-intra at rd 3), and the
intra-NxN point (fixed CU 4) with transform skip and ``--preset medium
--tr-depth-intra 1``, scaling lists (``--scaling-list default``,
``--cqmfile``), and SMP/AMP inter partitions and TMVP on fixed-grid P
frames.
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
5. the joint launch (luma and Cb, Cr of a batch in one launch, as the
   encoder calls it) vs the plain version at the all-intra and the P
   path's shapes, timed against the luma launch alone; and a
   compare-only check of 1920x1088 frames at cu 16 and cu 8 and
   3840x2160 frames at cu 16, both variants, random inputs, with the
   launch's shared memory;
6. all-intra: encode a seeded video-like clip on the card, timed after
   one warm-up batch, with the kernel's launch counts read around the
   run; a per-stage split of one batch; the first 2 frames again on the
   CPU (plain path), whose bytes must equal the card's;
7. IPPP: encode a 46-frame clip with continuous motion on the card,
   timed over the last 40 frames after 6 warm-up frames, with the
   launch counts read around the run; a per-stage split of one P frame;
   the first 3 frames (IDR + 2 P) again on the CPU, byte-identical;
8. all-intra variable CU trees (the ``medium`` preset's intra CUs
   8..32, rd 1, without its RDOQ and SAO): encode frames of the 8-frame
   clip on the card, timed after one warm-up frame, with the launch
   counts read around the run (this path runs no hand kernel: its
   var-tree wavefront is plain PyTorch); each timed frame's wavefront
   depth, their CU-size histogram and per-stage split (phase 9b counts
   the ATen ops of a var recon); the first 2
   frames again on the CPU, byte-identical; one frame at intra 8..64,
   rd 2, on the card and the CPU, byte-identical;
9. every preset's all-intra operating point: the ``superfast`` preset
   (fixed 16x16 grid, rd 0, SAO) timed as phase 6 (line ``superfast
   encode_stream:``, stage split with ``sao_ms``, 2 frames card == CPU
   bytes); the ``medium`` preset (intra 8..32, rd 1, RDOQ, SAO), 1
   warm-up and 1 timed frame (line ``medium encode_stream:``, var
   stage split with ``sao_ms``, 1 frame card == CPU bytes); one frame
   of ``slower`` (8..64, rd 2, RDOQ, sign hiding, SAO) card == CPU
   bytes; and RDOQ, sign hiding (S = 4..32, every scan index) and the
   SAO statistics, decision and filter (one 832x480 deblocked frame) on
   the card against the same functions on the CPU, max abs error 0;
10. the low-delay default operating points: the kernel at cu 32 (luma
   S=32 and Cb+Cr S=16 in the joint launch) == plain, intra over 8
   frames and inter over a real and a random P frame, timed, with the
   launch layout, and 1920x1088 compare-only; three timed cells through
   Encoder.encode_stream (lines ``ultrafast encode_stream:``,
   ``default-config encode_stream:``, ``veryfast encode_stream:``):
   the ultrafast preset (low-delay GOP lp-g4d4t1, a QP per position;
   one warm pass over an 8-frame clip, then 8 timed P frames), Config()
   (fixed cu 32 IPPP, pipelined; 6 warm and 40 timed frames of the
   46-frame clip; its launch counts are the cu 32 rows') and the
   veryfast preset (SAO on the I frame), each with a stage split of one
   P frame against 2 references; and card == CPU bytes and recon at
   256x128 for ultrafast, superfast, veryfast, faster and fast at their
   defaults, Config() and 3 references at cu 16 (IDR + 3 P frames; fast
   IDR + 2 P);
11. variable P trees with one reference (``run_var_p``): the medium
   preset's IPPP point (--gop 0, intra CUs 8..32, inter CUs 8..64,
   RDOQ, SAO) at 832x480 through Encoder.encode_stream, IDR + 1 P
   warm-up then 2 timed P frames of the 46-frame clip (line
   ``ippp-medium encode_stream:`` with fps, IDR and P bits, PSNR-Y,
   CU-size histogram, inter share), a stage split of one P frame
   (coarse motion search, each size's candidates, tree and plan, merge
   RD, direct pass, var recon with its ATen-op count, deblocking, SAO,
   downloads, merge/AMVP + skip, CABAC); card == CPU bytes and recon at
   128x64 for medium, slower and ultrafast at --gop 0 (IDR + 2 P); and
   a set_base_qp + reset_stream ladder (QP 22 -> 27 -> 22) on the card
   against fresh encoders;
12. B pyramids (``run_gop``): the inter variant on a real fixed-grid B
   frame's L0 / L1 / bi-averaged MC planes == plain (line ``inter kernel
   vs plain`` with ``b_frame``); GOP 8 on the fixed cu 16 grid at 832x480
   through Encoder.encode_stream, the IDR and one GOP warm, then two
   GOPs timed (line ``gop8-fixed16 encode_stream:`` with fps, bits per
   frame by slice type, PSNR-Y, the POC order and each B frame's inter
   launches; a B frame that launched no kernel fails the phase); the
   medium preset's default (GOP 8, variable B trees, bipred, RDOQ, SAO)
   the same way with one timed GOP (line ``gop8-medium encode_stream:``
   plus the CU-size histogram and inter share per frame) and a stage
   split of one B frame; card == CPU bytes and recon for the fixed-grid
   GOP 8 (9 frames) and medium's GOP 8 (9 frames and a 2-frame tail) at
   128x64, and an open GOP with CRA anchors and RASL B pictures (GOP 4,
   period 4, variable trees) at 128x64; and a set_base_qp +
   reset_stream ladder (QP 22 -> 27 -> 22) on a GOP-8 medium encoder
   against fresh encoders;
13. rate control and per-CTU QP (``run_rate_control``): the joint launch
   with a per-block QP map (a random per-CTU map in [QP - 6, QP + 6],
   chroma through Table 8-10) == plain, intra and inter at cu 16 and 32,
   at 832x480 and 1920x1088 (line ``qp-map kernel vs plain``, timed
   against the scalar launch, with the bound; a uniform map gives the
   scalar launch's output); the cell ``rc-ippp-832x480-2mbps``
   (Config() at QP 22 with --bitrate 2000000: LCU rate control through
   cu_qp_delta, fixed cu 32, one reference) through
   Encoder.encode_stream, IDR + 5 P frames warm and 40 P frames timed
   (fps, achieved kbit/s against 2000, slice, frame and CTU QP range;
   exactly one QP-map launch per frame) and a stage split of one of its
   P frames (``rc-ippp stage split``); and card == CPU bytes and
   recon for ROI + AQ all-intra (256x128), the medium preset with
   --bitrate 100000 (128x64; GOP 8, variable B trees, the GOP
   allocation and a 2-frame tail) and the ultrafast preset with
   --bitrate 330000 (256x128);
14. 10-bit (``run_tenbit``): the kernel's 10-bit instances == plain
   (line ``10-bit kernel vs plain``, timed against the 8-bit launch at
   the same shape): intra cu 16 over the intra cell's 8 frames, inter
   cu 32 on a real P and a real bi-averaged B frame, the per-block QP
   instance at cu 32 (a uniform map == the scalar launch), at 832x480,
   and intra cu 16 / cu 32, inter and QP map on one 3840x2160 frame;
   the cell ``intra-10bit-832x480-qp22`` (the headline configuration
   at input_bitdepth=10, timed as phase 6); the cell
   ``gop8-rc-10bit-3840x2160-15mbps`` (BASELINE config #5: 10-bit,
   GOP 8, --bitrate 15000000, fixed cu 32; the IDR and one GOP warm,
   one GOP timed: fps, kbit/s against 15000, the QP range, PSNR-Y at
   peak 1023 and the peak device memory); and card == CPU bytes and
   recon at 256x128 for 10-bit superfast --period 1, ultrafast and
   Config() with --bitrate (a per-CTU QP map), and medium (GOP 8,
   variable B trees) at 128x64;
15. lossless (``run_lossless``): the kernel's transquant-bypass
   instances == plain, max abs error 0, with the recon equal to the
   source (line ``bypass kernel vs plain``, each timed against the
   non-bypass launch at the same shape, with the bound): intra at cu 8,
   16 and 32 and inter at cu 16 and 32 (a real P frame of a lossless
   stream, and a random inter map with random MC planes) at 832x480,
   RDPCM off and on, the searched modes and random modes rich in 10 and
   26; 10-bit intra cu 16 and inter cu 32 at 832x480; 3840x2160 10-bit
   cu 32, intra and inter, timed; the cell ``lossless-832x480`` (the headline
   configuration with lossless=True, which turns deblocking off; a
   1-frame warm-up batch, then one timed batch of 2 through
   Encoder.encode_stream: fps, bits a frame, recon == source, the
   bypass launches, and a stage split with the Python CABAC's share);
   the pipelined FrameInfo of 128x128 noise at QP 51 (SSEs above 2^24)
   card == CPU, all-intra and IPPP; and card == CPU bytes and recon at
   256x128 for lossless streams: RDPCM all-intra cu 16, Config() cu 32
   all-intra, RDPCM IPPP cu 16, 10-bit RDPCM all-intra, the medium
   preset at --gop 0 and a fixed-grid GOP 4;
16. tiles and slices (``run_tiles``): the kernel's tiled instances (a
   thread block per tile, each with its own edge ring) == plain, max
   abs error 0, at 1920x1088 3x3, cu 16 and 32, 8- and 10-bit, intra and
   inter, and 3840x2176 3x3 cu 32 10-bit (line ``tiled kernel vs
   plain``, each timed against the untiled launch on the same frame,
   with the tile's steps, ring, threads and shared memory and the
   bound); the cells ``tiles3x3-ippp-1920x1080-qp22`` (BASELINE config
   #4 on the package defaults: Config() with tiles 3x3; IDR + 1 P warm,
   2 timed P frames) and ``tiles3x3-intra-1920x1080-qp22`` (the
   headline configuration on a 3x3 grid, pipelined; a 1-frame warm-up
   batch, one timed batch of 2), each with its tiled launches counted
   (``wavefront.TILE_LAUNCHES``) and a stage split with the Python
   CABAC's share (``cabac_python_ms``); and card == CPU bytes and recon
   at 416x240 for tiles 3x3 + WPP IPPP (Config()), --slices tiles
   all-intra and superfast at --period 1 with tiles 2x2 (the host SAO
   decision), and at 256x128 for --slices wpp on the medium preset at
   --gop 0 and a fixed-grid GOP 4 with tiles 2x2;
17. RDOQ, sign hiding, --rd 2 and --rd 3 on the fixed grid
   (``run_tools``): the kernel's RDOQ / sign-hiding instances and its
   explicit chroma modes == plain, max abs error 0 (line ``tools kernel
   vs plain``: RDOQ, sign hiding, both, RDOQ with a per-block QP map,
   both with random chroma modes; 832x480 cu 8 / 16 / 32 intra with
   random modes over every scanIdx and inter on a real cu 32 P frame
   and random cu 8 / 16 ones, 10-bit intra cu 16 and inter cu 32,
   1920x1088 3x3 tiled cu 16 intra and cu 32 inter, and 3840x2176 cu 32
   10-bit compare-only; each timed against the same launch without the
   tool, with the bound counting the tools' operations); the cells
   ``intra-rd3-rdoq-sh-832x480-qp22`` (the headline configuration at rd
   3 with RDOQ and sign hiding, timed as phase 6) and
   ``ld-slower-832x480-qp22`` (``--preset slower --gop lp-g4d4t1``: one
   warm pass over the 8-frame clip, then 8 timed P frames on the fixed
   cu 32 grid with RDOQ and sign hiding), each with its tool launches
   (``wavefront.TOOL_LAUNCHES``, ``CMODE_LAUNCHES``) and a stage split;
   and card == CPU bytes and recon at 256x128 for medium --gop
   lp-g4d4t1, medium --gop 0 --ref 2, Config(rdoq=True) with --bitrate,
   Config() with RDOQ, sign hiding and tiles 2x2, medium --period 1
   --rd 3, placebo --gop 0 --ref 3 and a 10-bit fixed-grid GOP 8 with
   RDOQ and sign hiding;
18. the intra-NxN point (fixed CU 4, DST-VII), transform skip and
   --tr-depth-intra (``run_nxn``): the kernel's cu 4 instances (luma on
   the plan of 4x4 blocks, transform skip a run-time flag) and the NxN
   chroma launch of the cu 8 instances on the cu 8 plan == plain, max
   abs error 0 (line ``cu4 kernel vs plain``: 832x480 over 8 frames with
   searched and random modes, transform skip off and on, sign hiding,
   RDOQ with sign hiding, lossless, 10-bit, and a 1920x1088
   compare-only frame; each timed against the cu 8 joint launch on the
   same frames, with its threads, shared memory, steps and bounds); the
   cells ``intra-nxn-tskip-832x480-qp22`` (the headline configuration at
   cu 4 with transform skip; a 1-frame warm-up batch, one timed batch of
   2; the cu 4 and transform-skip launches, ``wavefront.CU4_LAUNCHES``
   and ``TSKIP_LAUNCHES``; a stage split with the Python CABAC,
   ``cabac_python_ms``) and ``intra-medium-trdepth-832x480-qp22``
   (``--preset medium --period 1 --tr-depth-intra 1``: 1 warm-up and 1
   timed frame, the var-tree stage split and the share of 8x8 cells
   whose CU split its TBs); and card == CPU bytes and recon at 128x64
   for cu 4 with WPP and sign hiding, with transform skip, 10-bit 4:0:0,
   with RDOQ and lossless, --tr-depth-intra all-intra, IPPP and a medium
   GOP 4, and the 128x128 tiled I + P stream with RDOQ and sign hiding
   that holds F2 (ROADMAP §3);
19. scaling lists (``run_scaling``): the kernel's scaling-list (SL)
   instances == plain, max abs error 0 (line ``sl kernel vs plain``:
   a custom cqm written by the script and the default lists; 832x480
   intra cu 8 / 16 / 32 with random modes over all 35, inter on a real
   cu 32 P frame and a random cu 8 one, QP 22 and QP 37 (the
   dequantizer's clip-then-shift branch), RDOQ with sign hiding, 10-bit,
   1920x1088 3x3 tiles, cu 4 with its cu 8 chroma launch, and 3840x2176
   cu 32 10-bit compare-only with its shared memory; each timed against
   the same launch without the lists, ``ms_flat``); the cells
   ``intra-scaling-default-832x480-qp22`` (the headline configuration
   with the default lists, timed as phase 6) and
   ``ld-slower-cqm-832x480-qp22`` (``--preset slower --gop lp-g4d4t1
   --cqmfile``, timed as ``ld-slower-832x480-qp22``), each with its SL
   launches (``wavefront.SL_LAUNCHES``) and a stage split; and card ==
   CPU bytes and recon at 128x64 for default-list IPPP, custom-list cu
   4, a custom-list medium GOP 4, 10-bit custom cu 16, and tiles 2x2
   with RDOQ and sign hiding (128x128);
20. SMP/AMP inter partitions and TMVP (``run_smp``): the inter variant
   == plain, max abs error 0, on real SMP / AMP P frames at 832x480
   (the MC planes of the PUs' motion): SMP cu 16, AMP cu 32 and AMP
   cu 32 with RDOQ and sign hiding (line ``smp kernel vs plain``, timed
   against the plain version, with the bound); the cells
   ``ippp-amp-832x480-qp22`` (cu 32 IPPP with SMP and AMP, pipelined;
   IDR + 1 P warm, 8 timed P frames of the 46-frame clip) and
   ``ld-ultrafast-tmvp-832x480-qp22`` (the ultrafast preset with TMVP,
   timed as ``ultrafast``), each with its launches; and card == CPU
   bytes and recon at 128x64 for SMP cu 16, AMP cu 32 with RDOQ and
   sign hiding, SMP with --bitrate, TMVP IPPP, ultrafast with TMVP and
   TMVP with an IDR every 3 frames.

The kernels' JSON record and the card's name and power limit come just
before the last line, ``{"ok": true, "device": {...}}``.  Without a
CUDA device, or outside the repository, it exits nonzero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

W, H, QP, FRAMES, BATCH, TIMED_BATCHES = 832, 480, 22, 8, 8, 4
IPPP_WARM, IPPP_TIMED = 6, 40
VAR_TIMED = 1                         # phase 8: frames after 1 warm-up
MEDIUM_TIMED = 1                      # phase 9: frames after 1 warm-up
VAR_P_TIMED = 2                       # phase 11: P frames after IDR + P
GOP = 8                               # phase 12: GOP length
BIG = ((1920, 1088), (3840, 2160))    # the compare-only frames of phase 5
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


def var_config(width, height, **kw):
    """The medium preset's all-intra tree without RDOQ and SAO: intra
    CUs 8..32, rd 1, deblocking, WPP."""
    from kvazaar_tpu_torch.config import config_from_preset
    return config_from_preset("medium", width=width, height=height, qp=QP,
                              intra_period=1, rdoq=False, sao=False, **kw)


def bound_ms(tensors, work):
    """Least time the card could take for one wavefront launch: each
    input read once (as the kernel reads it) and each output written
    once over HBM bandwidth, against the transform's multiply-adds over
    the int32/float32 peak.  work: (samples, S) per plane kind, each
    sample costing 4 stages of S multiply-adds, 2 operations each, plus
    about 20 for prediction and quantization.  Returns (ms,
    "bytes"|"operations")."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    ops = sum(n * (8 * s + 20) for n, s in work)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(torch, got, want):
    """Largest |difference| over matching tensors of two tuples."""
    torch.cuda.synchronize()
    return max((g.int() - w.int()).abs().max().item()
               for g, w in zip(got, want) if g is not None)


def time_row(torch, row, args, kw, plan):
    """Adds the kernel's and the plain version's times at these inputs
    to row."""
    from kvazaar_tpu_torch.encoder.intra_recon import wavefront_recon_plain
    from kvazaar_tpu_torch.ops.wavefront import wavefront_recon
    row["ms"] = cuda_ms(torch, lambda: wavefront_recon(*args, **kw), 20)
    row["n_steps"] = plan.n_steps
    row["ms_per_step"] = row["ms"] / plan.n_steps
    row["plain_ms"] = cuda_ms(
        torch, lambda: wavefront_recon_plain(*args, **kw), 2)


def compare_kernel(torch, frames, dev, cus=(16, 8)):
    """Phase 3 (cu 16 and 8) and 10 (cu 32): kernel == plain on the
    card; returns per-shape rows.

    Each shape runs with the searched modes (timed) and with uniform
    random modes, which reach every one of the 35 modes."""
    from kvazaar_tpu_torch.encoder.frame_encoder import IntraFrameEncoder
    from kvazaar_tpu_torch.encoder.intra_recon import wavefront_recon_plain
    from kvazaar_tpu_torch.encoder.intra_search import search_frame_modes
    from kvazaar_tpu_torch.ops.wavefront import wavefront_recon

    def err_of(args):
        return max_err(torch, wavefront_recon(*args),
                       wavefront_recon_plain(*args))

    ys = torch.from_numpy(np.stack([f[0] for f in frames])).to(dev)
    cs = torch.from_numpy(np.stack([f[1] for f in frames]
                                   + [f[2] for f in frames])).to(dev)
    rng = np.random.default_rng(1)
    rows = []
    for cu in cus:
        ife = IntraFrameEncoder(headline_config(W, H, cu), device=dev)
        plan = ife.plan
        modes = torch.stack([search_frame_modes(y, plan, ife.lambda_satd)[0]
                             for y in ys])
        random_modes = torch.from_numpy(rng.integers(
            0, 35, tuple(modes.shape), dtype=np.int32)).to(dev)
        for orig, s, luma, qp in ((ys, cu, True, QP),
                                  (cs, cu // 2, False, ife.qp_c)):
            args = (orig.to(torch.int32), modes, plan, s, luma, qp)
            err = max(err_of(args),
                      err_of((args[0], random_modes) + args[2:]))
            row = dict(cu=cu, s=s, luma=luma, items=orig.shape[0],
                       max_abs_err=err)
            time_row(torch, row, args, {}, plan)
            row["bound_ms"], row["bound_by"] = bound_ms(
                (args[0], modes, *wavefront_recon(*args)),
                [(args[0].numel(), s)])
            log("kernel vs plain:", json.dumps(row))
            if err != 0:
                raise RuntimeError(f"kernel != plain at {row}")
            rows.append(row)
    return rows


def p_frame_inputs(torch, frames, cu, dev):
    """The encoder, source planes, modes, inter map and MC planes of a
    real P frame: frame 1 searched against frame 0's deblocked recon."""
    from kvazaar_tpu_torch.encoder.frame_encoder import IntraFrameEncoder
    ife = IntraFrameEncoder(ippp_config(W, H, cu), device=dev)
    ife.submit_frames([frames[0]])       # DPB: frame 0, deblocked
    ys, cbs, crs = ife._upload(ife.host_pack_sources([frames[1]]))
    modes, inter_map, _ref, _mv, mcs = ife._p_predict(ys[0], [ife._dpb])
    return ife, (ys, cbs, crs), modes, inter_map, mcs


def compare_kernel_inter(torch, frames, dev, cus=(16, 8)):
    """Phase 4 (cu 16 and 8) and 10 (cu 32): the inter variant == plain
    on the card; returns rows.

    Each shape runs with the inter map, modes and MC planes of a real P
    frame (frame 1 searched against frame 0's deblocked recon; timed)
    and with random ones (inter with p = 0.5, uniform modes and MC
    samples)."""
    from kvazaar_tpu_torch.encoder.intra_recon import wavefront_recon_plain
    from kvazaar_tpu_torch.ops.wavefront import wavefront_recon

    def err_of(args):
        return max_err(torch, wavefront_recon(*args),
                       wavefront_recon_plain(*args))

    rng = np.random.default_rng(2)
    rows = []
    for cu in cus:
        ife, (ys, cbs, crs), modes, inter_map, (mc_y, mc_cb, mc_cr) = \
            p_frame_inputs(torch, frames, cu, dev)
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
            err = max(err_of(args), err_of(rnd))
            row = dict(cu=cu, s=s, luma=luma, items=orig.shape[0],
                       inter_share=inter_map.float().mean().item(),
                       max_abs_err=err)
            time_row(torch, row, args, {}, plan)
            row["bound_ms"], row["bound_by"] = bound_ms(
                (orig, modes, inter_map.to(torch.uint8), args[-1],
                 *wavefront_recon(*args)), [(orig.numel(), s)])
            log("inter kernel vs plain:", json.dumps(row))
            if err != 0:
                raise RuntimeError(f"inter kernel != plain at {row}")
            rows.append(row)
    return rows


def joint_launch(torch, frames, clip46, dev, cu=16, big=BIG,
                 big_cus=(16, 8)):
    """Phase 5 (cu 16) and 10 (cu 32): luma + Cb + Cr in one launch
    (wavefront_recon_planes, as reconstruct_frames calls it) == the plain
    version per plane kind, and its time against the luma launch alone,
    with the launch's ring depth, threads and shared memory, at the
    all-intra path's shapes (8 frames) and the P path's (1 frame, real
    inputs); then compare-only frames of the sizes ``big`` at the CU
    sizes ``big_cus``, both variants, random inputs.  Returns the rows of
    the two main-path shapes."""
    from kvazaar_tpu_torch.encoder.frame_encoder import (IntraFrameEncoder,
                                                         chroma_qp)
    from kvazaar_tpu_torch.encoder.intra_recon import wavefront_recon_plain
    from kvazaar_tpu_torch.encoder.intra_search import search_frame_modes
    from kvazaar_tpu_torch.ops.wavefront import (launch_layout,
                                                 wavefront_recon,
                                                 wavefront_recon_planes)

    def check(planes, modes, plan, qp_c, inter=None):
        """max abs error of the joint launch against the plain per-step
        version, run per plane kind on the same card tensors."""
        kw = {} if inter is None else dict(
            zip(("is_inter", "mc_y", "mc_cb", "mc_cr"), inter))
        got = wavefront_recon_planes(*planes, modes, plan, QP, qp_c, **kw)
        want = []
        for orig, mc, s, luma, qp in (
                (planes[0], kw.get("mc_y"), plan.cu_size, True, QP),
                (planes[1], kw.get("mc_cb"), plan.cu_size // 2, False, qp_c),
                (planes[2], kw.get("mc_cr"), plan.cu_size // 2, False,
                 qp_c)):
            want += wavefront_recon_plain(orig, modes, plan, s, luma, qp, 8,
                                          kw.get("is_inter"), mc)
        return max_err(torch, got, want), kw

    def row_of(name, planes, modes, plan, qp_c, inter=None):
        err, kw = check(planes, modes, plan, qp_c, inter)
        def run():
            return wavefront_recon_planes(*planes, modes, plan, QP, qp_c,
                                          **kw)

        joint = cuda_ms(torch, run, 20)
        luma_kw = ({} if inter is None
                   else dict(is_inter=kw["is_inter"], mc=kw["mc_y"]))
        luma = cuda_ms(torch, lambda: wavefront_recon(
            planes[0], modes, plan, plan.cu_size, True, QP, **luma_kw), 20)
        tensors = (*planes, modes, *kw.values(), *run())
        ring, threads, smem = launch_layout(plan, plan.cu_size,
                                            planes[0].shape[2])
        row = dict(shape=name, cu=plan.cu_size, items=planes[0].shape[0],
                   max_abs_err=err, ms=joint, luma_alone_ms=luma,
                   ratio=joint / luma, n_steps=plan.n_steps,
                   ms_per_step=joint / plan.n_steps, ring=ring,
                   threads=threads, smem_bytes=smem)
        row["bound_ms"], row["bound_by"] = bound_ms(
            tensors, [(planes[0].numel(), plan.cu_size),
                      (2 * planes[1].numel(), plan.cu_size // 2)])
        log("joint launch vs plain:", json.dumps(row))
        if err != 0:
            raise RuntimeError(f"joint launch != plain at {row}")
        return row

    ife = IntraFrameEncoder(headline_config(W, H, cu), device=dev)
    planes = ife._upload(ife.host_pack_sources(frames))
    modes = torch.stack([search_frame_modes(y, ife.plan, ife.lambda_satd)[0]
                         for y in planes[0]])
    rows = [row_of("intra 8 frames", planes, modes, ife.plan, ife.qp_c)]
    ife, (ys, cbs, crs), modes, inter_map, mcs = p_frame_inputs(
        torch, clip46, cu, dev)
    rows.append(row_of("inter 1 P frame", (ys, cbs, crs), modes[None],
                       ife.plan, ife.qp_c,
                       (inter_map[None], *(m[None] for m in mcs))))

    from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
    rng = np.random.default_rng(3)
    # Not 3840x2160 at cu 8: its plain version's 2316 steps took a large
    # share of the whole run; 1920x1088 covers cu 8.
    for (big_w, big_h), cu in ((wh, c) for wh in big for c in big_cus
                               if c != 8 or wh[0] < 3840):
        plan = make_intra_plan(big_w, big_h, cu, chroma=True)

        def rand(shape, hi, dtype=np.uint8):
            return torch.from_numpy(rng.integers(0, hi, shape,
                                                 dtype=dtype)).to(dev)

        planes = (rand((1, big_h, big_w), 256),
                  rand((1, big_h // 2, big_w // 2), 256),
                  rand((1, big_h // 2, big_w // 2), 256))
        modes = rand((1, plan.blocks_y, plan.blocks_x), 35, np.int32)
        inter = (rand(tuple(modes.shape), 2) != 0,
                 *(rand(tuple(p.shape), 256) for p in planes))
        errs = [check(planes, modes, plan, chroma_qp(QP))[0],
                check(planes, modes, plan, chroma_qp(QP), inter)[0]]
        ring, threads, smem = launch_layout(plan, cu, big_w)
        log(f"{big_w}x{big_h} joint launch vs plain:", json.dumps(
            dict(cu=cu, blocks=plan.blocks_y * plan.blocks_x,
                 n_steps=plan.n_steps, n_slots=plan.n_slots, ring=ring,
                 threads=threads, smem_bytes=smem,
                 max_abs_err_intra=errs[0], max_abs_err_inter=errs[1])))
        if max(errs) != 0:
            raise RuntimeError(f"joint launch != plain at {big_w}x{big_h} "
                               f"cu {cu}")
    return rows


def stage_split(torch, ife, frames):
    """Per-stage times of one batch (device stages by CUDA events, the
    host stages by wall clock); the search and the reconstruction as the
    config runs them (rd 2's re-rank, rd 3's chroma-mode search, RDOQ and
    sign hiding)."""
    from kvazaar_tpu_torch.encoder.frame_encoder import qp_to_lambda
    from kvazaar_tpu_torch.encoder.intra_recon import reconstruct_frames
    from kvazaar_tpu_torch.encoder.intra_search import (search_chroma_modes,
                                                        search_frame_modes)
    from kvazaar_tpu_torch.ops.deblock import deblock_frame

    def up(a):
        return torch.from_numpy(a).to(ife.device).to(torch.int32)

    ys, cbs, crs = (up(a) for a in ife.host_pack_sources(frames))
    torch.cuda.synchronize()
    out = {}
    box = {}

    cfg = ife.cfg
    lam = qp_to_lambda(cfg.qp)

    def search():
        box["modes"] = torch.stack([
            search_frame_modes(y, ife.plan, ife.lambda_satd, 8,
                               cfg.rd >= 1, rdo=cfg.rd >= 2, qp=cfg.qp,
                               lam_rd=lam)[0]
            for y in ys])

    def chroma_search():
        box["cmodes"] = torch.stack([
            search_chroma_modes(cb, cr, m, ife.plan, ife.qp_c, lam)
            for cb, cr, m in zip(cbs, crs, box["modes"])])

    def recon():
        box["rec"] = reconstruct_frames(ys, cbs, crs, box["modes"],
                                        ife.plan, QP, ife.qp_c,
                                        cmodes=box.get("cmodes"),
                                        **ife._recon_tools())

    def deblock():
        r = box["rec"]
        box["dbk"] = tuple(t.to(torch.uint8) for t in deblock_frame(
            r[0], r[2], r[4], QP, ife.cu))

    def sao():
        ife._sao_stage((ys, cbs, crs), box["dbk"])

    stages = [("search", search)]
    if cfg.rd >= 3 and cbs is not None:
        stages.append(("chroma_search", chroma_search))
    stages += [("recon_kernel", recon), ("deblock", deblock)]
    if ife.cfg.sao:
        stages.append(("sao", sao))
    for name, fn in stages:
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
    modes, inter_map, _ref_sel, mv, mcs = ife._p_predict(yp, [ref])
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
            mc_cb=mcs[1][None], mc_cr=mcs[2][None], **ife._recon_tools())

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
    ife.finalize_p_downloaded(dl, poc=1, ref_pocs=[0], multi=False)
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


def count_aten_ops(torch, fn):
    """ATen ops dispatched by one call of fn (a torch.profiler window
    over a var recon, which would count its device kernels, takes a
    minute or more of the run's time limit)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    torch.cuda.synchronize()
    return Count.n


def var_stage_split(torch, ife, frames, count=True):
    """Per-stage times of var-tree frames, each stage timed once per
    frame by the host clock between synchronizes (the device stages are
    host-bound, so this is also their device span), averaged over the
    frames; each frame's wavefront depth, the CU-size histogram over
    the frames, and (count) the ATen ops of the first frame's
    reconstruction.  The stages are encode_frame_var's, with
    the config's RDOQ, sign hiding, SAO and TU splits (--tr-depth-intra:
    then also the share of 8x8 cells whose CU split its TBs)."""
    from kvazaar_tpu_torch.encoder.frame_encoder import _set_sao, qp_to_lambda
    from kvazaar_tpu_torch.encoder.quadtree import reconstruct_frame_var
    from kvazaar_tpu_torch.encoder.var_schedule import build_var_plan
    cfg = ife.cfg

    totals, depths, cus, splits = {}, [], {}, []

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        totals[name] = totals.get(name, 0.0) + 1000 * (time.perf_counter()
                                                       - t0)
        return r

    for i, frame in enumerate(frames):
        planes = timed("upload_ms", lambda: tuple(
            a[0] for a in ife._upload(ife.host_pack_sources([frame]))))
        found = timed("search_ms", lambda: ife.var_search(planes[0]))
        size8, sched_size8, mode_maps, vp, _cmodes, *trsplit = timed(
            "tree_and_plan_ms", lambda: ife.var_tree_plan(*found))
        timed("build_var_plan_ms", lambda: build_var_plan(
            sched_size8, mode_maps, ife.coded_w, ife.coded_h, True))
        sched = timed("sched_upload_ms", lambda: ife.var_sched_arrays(
            vp, planes, sched_size8))

        def recon():
            return reconstruct_frame_var(
                sched, QP, ife.qp_c, ife.coded_w, ife.coded_h, True,
                signhide=cfg.signhide, rdoq=cfg.rdoq,
                lam=qp_to_lambda(cfg.qp))

        recs, levels = timed("var_recon_ms", recon)
        recs = timed("deblock_ms", lambda: ife.var_deblock(sched, recs))
        sao = None
        if cfg.sao:
            recs, sao = timed("sao_ms", lambda: ife.var_sao(planes, recs))
        host = timed("d2h_ms", lambda: (
            [r.cpu().numpy() for r in recs],
            [lv.cpu().numpy() for lv in levels],
            None if sao is None else sao.cpu().numpy()))

        def cabac():
            fd = ife.var_frame_data(size8, sched_size8, mode_maps, host[1])
            if trsplit:
                fd.trsplit8[:] = trsplit[0]
            _set_sao(fd, host[2])
            return ife._serialize_i(fd, *host[0])

        timed("cabac_ms", cabac)
        depths.append(vp.n_steps_real)
        if trsplit:
            splits.append(float((trsplit[0] != 0).mean()))
        sizes, cells = np.unique(size8, return_counts=True)
        for sz, c in zip(sizes, cells):
            cus[int(sz)] = cus.get(int(sz), 0) + int(c) * 64 // int(sz) ** 2
        if i == 0 and count:
            aten = count_aten_ops(torch, recon)
    out = {k: v / len(frames) for k, v in totals.items()}
    out["frame_ms"] = sum(v for k, v in out.items()
                          if k != "build_var_plan_ms")
    if count:
        out["recon_aten_ops"] = aten
    if splits:
        out["trsplit_cell_share"] = sum(splits) / len(splits)
    return out, depths, cus


def run_var(torch, wavefront, frames, dev):
    """Phase 8: all-intra variable CU trees through Encoder.encode_stream
    on the card (frames[0] warms up, the next VAR_TIMED are timed); the
    CPU plain path's bytes; one intra 8..64 rd 2 frame."""
    from kvazaar_tpu_torch.api import Encoder
    enc = Encoder(var_config(W, H), device=dev)
    clip = frames[:1 + VAR_TIMED]
    for k in wavefront.LAUNCHES:
        wavefront.LAUNCHES[k] = 0
    results = []
    t0 = time.perf_counter()
    for res in enc.encode_stream(clip):
        results.append(res)
        if len(results) == 1:
            t0 = time.perf_counter()
    dt = time.perf_counter() - t0
    launches = dict(wavefront.LAUNCHES)
    if len(results) != len(clip):
        raise RuntimeError(f"{len(results)} results for {len(clip)} frames")
    bits = [r[1].bits for r in results[1:]]
    psnr_y = [r[1].psnr_y for r in results[1:]]
    if not all(b > 0 for b in bits) or not all(
            math.isfinite(p) and 30.0 < p < 99.0 for p in psnr_y):
        raise RuntimeError(f"implausible var-tree output: bits {bits} "
                           f"PSNR-Y {psnr_y}")
    # The ATen ops of a var recon are counted in phase 9b (medium).
    split, n_steps_real, cus = var_stage_split(torch, enc._intra,
                                               clip[1:], count=False)
    summary = dict(frames=len(clip), timed=VAR_TIMED, fps=VAR_TIMED / dt,
                   bits_per_frame=sum(bits) / len(bits),
                   psnr_y=sum(psnr_y) / len(psnr_y),
                   n_steps_real=n_steps_real, cus_by_size=cus,
                   kernel_launches=launches)
    log("var-tree encode_stream:", json.dumps(summary))
    log("var-tree stage split (ms per frame, the timed frames):",
        json.dumps(split))

    t0 = time.perf_counter()
    cpu = Encoder(var_config(W, H), device="cpu")
    host = [r[0] for r in cpu.encode_stream(clip[:2])]
    if host != [r[0] for r in results[:2]]:
        raise RuntimeError("var tree: card and CPU streams differ")
    log(f"CPU plain path: first 2 var-tree frames byte-identical to the "
        f"card ({time.perf_counter() - t0:.3f} s on the CPU)")
    rd2 = var_config(W, H, intra_max_cu=64, rd=2)
    t0 = time.perf_counter()
    card = Encoder(rd2, device=dev).encode(*frames[0])[0][0]
    t_card = time.perf_counter() - t0
    if Encoder(rd2, device="cpu").encode(*frames[0])[0][0] != card:
        raise RuntimeError("var tree 8..64 rd 2: card and CPU differ")
    log(f"intra 8..64 rd 2: card ({t_card:.3f} s, {len(card) * 8} bits) "
        "and CPU streams byte-identical")
    enc._intra.close()
    cpu._intra.close()


def preset_config(name, width, height):
    """A preset's all-intra operating point (--preset name --period 1)."""
    from kvazaar_tpu_torch.config import config_from_preset
    return config_from_preset(name, width=width, height=height, qp=QP,
                              intra_period=1)


def check_output(results, what):
    bits = [r[1].bits for r in results]
    psnr_y = [r[1].psnr_y for r in results]
    if not all(b > 0 for b in bits) or not all(
            math.isfinite(p) and 30.0 < p < 99.0 for p in psnr_y):
        raise RuntimeError(f"implausible {what} output: bits {bits} "
                           f"PSNR-Y {psnr_y}")
    return sum(bits) / len(bits), sum(psnr_y) / len(psnr_y)


def run_superfast(torch, wavefront, frames, dev):
    """Phase 9a: the superfast preset (fixed grid, SAO) through
    Encoder.encode_stream, timed as phase 6; the CPU plain path's
    bytes."""
    from kvazaar_tpu_torch.api import Encoder
    enc = Encoder(preset_config("superfast", W, H), device=dev)
    if not (enc._intra.params.sao_enabled and enc.can_pipeline()):
        raise RuntimeError("superfast: expected the pipelined SAO path")
    warm = [r[0] for r in enc.encode_stream(frames[:BATCH])]
    torch.cuda.synchronize()
    clip = frames * TIMED_BATCHES
    for k in wavefront.LAUNCHES:
        wavefront.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    results = list(enc.encode_stream(clip))
    dt = time.perf_counter() - t0
    launches = dict(wavefront.LAUNCHES)
    if launches["intra"] == 0:
        raise RuntimeError("superfast never launched the kernel")
    if len(results) != len(clip):
        raise RuntimeError(f"{len(results)} results for {len(clip)} frames")
    bits, psnr_y = check_output(results, "superfast")
    log("superfast encode_stream:", json.dumps(dict(
        frames=len(clip), batch=BATCH, fps=len(clip) / dt,
        bits_per_frame=bits, psnr_y=psnr_y, kernel_launches=launches,
        stage_wall_s=enc.stats)))
    split = stage_split(torch, enc._intra, frames[:BATCH])
    log("superfast stage split (ms/frame, one batch of 8):",
        json.dumps(split))
    cpu = Encoder(preset_config("superfast", W, H), device="cpu")
    if [r[0] for r in cpu.encode_stream(frames[:2])] != warm[:2]:
        raise RuntimeError("superfast: card and CPU streams differ")
    log("CPU plain path: first 2 superfast frames byte-identical to the "
        "card")
    enc._intra.close()
    cpu._intra.close()


def run_medium_slower(torch, wavefront, frames, dev):
    """Phase 9b/c: the medium preset (variable trees, RDOQ, SAO) through
    Encoder.encode_stream, 1 warm-up and MEDIUM_TIMED timed frames, its
    var stage split and 1 frame on the CPU; one slower frame on both."""
    from kvazaar_tpu_torch.api import Encoder
    cfg = preset_config("medium", W, H)
    if not (cfg.rdoq and cfg.sao):
        raise RuntimeError("medium: expected RDOQ and SAO")
    enc = Encoder(cfg, device=dev)
    clip = frames[:1 + MEDIUM_TIMED]
    for k in wavefront.LAUNCHES:
        wavefront.LAUNCHES[k] = 0
    results = []
    t0 = time.perf_counter()
    for res in enc.encode_stream(clip):
        results.append(res)
        if len(results) == 1:
            t0 = time.perf_counter()
    dt = time.perf_counter() - t0
    launches = dict(wavefront.LAUNCHES)
    if len(results) != len(clip):
        raise RuntimeError(f"{len(results)} results for {len(clip)} frames")
    bits, psnr_y = check_output(results[1:], "medium")
    split, n_steps_real, cus = var_stage_split(torch, enc._intra, clip[1:])
    log("medium encode_stream:", json.dumps(dict(
        frames=len(clip), timed=MEDIUM_TIMED, fps=MEDIUM_TIMED / dt,
        bits_per_frame=bits, psnr_y=psnr_y, n_steps_real=n_steps_real,
        cus_by_size=cus, kernel_launches=launches)))
    log("medium stage split (ms per frame, the timed frames):",
        json.dumps(split))
    t0 = time.perf_counter()
    if Encoder(cfg, device="cpu").encode(*clip[0])[0][0] != results[0][0]:
        raise RuntimeError("medium: card and CPU streams differ")
    log(f"CPU plain path: first medium frame byte-identical to the card "
        f"({time.perf_counter() - t0:.3f} s on the CPU)")
    slower = preset_config("slower", W, H)
    t0 = time.perf_counter()
    card = Encoder(slower, device=dev).encode(*frames[0])[0][0]
    t_card = time.perf_counter() - t0
    if Encoder(slower, device="cpu").encode(*frames[0])[0][0] != card:
        raise RuntimeError("slower: card and CPU streams differ")
    log(f"slower (8..64, rd 2, RDOQ, sign hiding, SAO): card ({t_card:.3f} "
        f"s, {len(card) * 8} bits) and CPU streams byte-identical")
    enc._intra.close()


def compare_ops(torch, frames, dev):
    """Phase 9d: RDOQ, sign hiding and the SAO stages on the card ==
    the same functions on the CPU (max abs error 0)."""
    from kvazaar_tpu_torch.encoder.frame_encoder import (IntraFrameEncoder,
                                                         qp_to_lambda)
    from kvazaar_tpu_torch.ops.quant import quantize_rdoq, sign_hide
    from kvazaar_tpu_torch.ops.sao import (apply_sao_plane,
                                           sao_decide_frame_device,
                                           sao_stats)

    def err(got, want):
        got = [got] if isinstance(got, torch.Tensor) else list(got)
        want = [want] if isinstance(want, torch.Tensor) else list(want)
        return max((g.cpu().long() - w.long()).abs().max().item()
                   for g, w in zip(got, want))

    lam = qp_to_lambda(QP)
    rng = np.random.default_rng(4)
    row = {}
    for s in (4, 8, 16, 32):
        n = 65536 // (s * s)
        mag = np.exp(rng.uniform(0, np.log(32767), (n, s, s)))
        c = torch.from_numpy((mag * rng.choice([-1, 1], (n, s, s))
                              ).astype(np.int32))
        c[torch.from_numpy(rng.random((n, s, s)) < 0.6)] //= 64
        lv = quantize_rdoq(c, QP, s, 8, True, lam)
        row[f"rdoq_{s}"] = err(quantize_rdoq(c.to(dev), QP, s, 8, True,
                                             lam), lv)
        for sel in range(3):
            ss = torch.full((n,), sel, dtype=torch.int32)
            row[f"sign_hide_{s}_scan{sel}"] = err(
                sign_hide(lv.to(dev), ss.to(dev)), sign_hide(lv, ss))

    ife = IntraFrameEncoder(headline_config(W, H), device=dev)
    srcs = ife._upload(ife.host_pack_sources([frames[0]]))
    recs = ife.submit_frames([frames[0]])[1][2]           # deblocked
    kinds = ((64, srcs[0], recs[0]), (32, srcs[1], recs[1]),
             (32, srcs[2], recs[2]))
    stats = [sao_stats(o, r, ctu) for ctu, o, r in kinds]
    stats_cpu = [sao_stats(o.cpu(), r.cpu(), ctu) for ctu, o, r in kinds]
    row["sao_stats"] = max(err(a, b) for a, b in zip(stats, stats_cpu))
    # The decision and the filter from the same (card) statistics, at
    # the frame QP's lambda and at a small one that buys more offsets.
    host = [tuple(t.cpu() for t in st) for st in stats]
    types = {}
    for name, lam_k in (("qp", lam), ("small", 0.25)):
        p = sao_decide_frame_device(stats[0], (stats[1], stats[2]), lam_k)
        p_cpu = sao_decide_frame_device(host[0], (host[1], host[2]), lam_k)
        row[f"sao_decide_{name}"] = err(p.values(), p_cpu.values())
        types[name] = np.unique(p_cpu["type"].numpy(),
                                return_counts=True)[1].tolist()
        filt = []
        for (ctu, _o, r), j, b in zip(kinds, (0, 1, 1), (0, 1, 2)):
            def filtered(q, rec):
                return apply_sao_plane(rec, q["type"][..., j],
                                       q["eo"][..., j], q["bp"][..., b],
                                       q["off"][..., b, :], ctu)
            filt.append(err(filtered(p, r), filtered(p_cpu, r.cpu())))
        row[f"apply_sao_plane_{name}"] = max(filt)
    log("RDOQ / sign hiding / SAO card vs CPU (max abs error):",
        json.dumps(dict(row, sao_type_counts=types)))
    if max(row.values()) != 0:
        raise RuntimeError(f"card != CPU: {row}")


def ld_p_split(torch, cfg, frames, dev, nref=2):
    """Per-stage times of one P frame of a low-delay config against nref
    references (frame nref against the deblocked recons of frames
    nref-1 .. 0, the fast preset's count at nref=2): device stages by
    CUDA events (the inter search once per reference), the host stages
    (the downloads, the decode-order merge/AMVP loop of the
    multi-reference stream shape, the whole finalize with CABAC) by
    wall clock, all in ms."""
    from kvazaar_tpu_torch.encoder.frame_encoder import (IntraFrameEncoder,
                                                         compute_bs_maps)
    from kvazaar_tpu_torch.encoder.inter_search import search_inter_frame
    from kvazaar_tpu_torch.encoder.intra_recon import reconstruct_frames
    from kvazaar_tpu_torch.encoder.intra_search import search_frame_modes
    from kvazaar_tpu_torch.ops.deblock import deblock_frame

    ife = IntraFrameEncoder(cfg, device=dev)
    if ife.var:
        ife.encode_frame(*frames[0])        # a variable-tree I frame
    else:
        ife.submit_frames([frames[0]])
    refs = [ife._dpb]
    for k in range(1, nref):
        refs.insert(0, ife.submit_p(*frames[k], [(k - 1, refs[0])])[5])
    ys, cbs, crs = ife._upload(ife.host_pack_sources([frames[nref]]))
    yp, plan = ys[0], ife.plan
    modes, inter_map, ref_sel, mv, mcs = ife._p_predict(yp, refs)
    box = {}

    def recon():
        box["rec"] = reconstruct_frames(
            ys, cbs, crs, modes[None], plan, ife.cfg.qp, ife.qp_c,
            is_inter=inter_map[None], mc_y=mcs[0][None],
            mc_cb=mcs[1][None], mc_cr=mcs[2][None], **ife._recon_tools())

    def deblock():
        rec = box["rec"]
        cbf = (rec[1][0] != 0).flatten(1).any(dim=1).reshape(
            plan.blocks_y, plan.blocks_x)
        bs_v, bs_h = compute_bs_maps(inter_map, cbf, mv, ref=ref_sel)
        deblock_frame(rec[0], rec[2], rec[4], ife.cfg.qp, ife.cu,
                      bs_v=bs_v, bs_h=bs_h)

    stages = [("intra_search", lambda: search_frame_modes(
        yp, plan, ife.lambda_satd, 8, ife.cfg.rd >= 1))]
    for i, ref in enumerate(refs):
        stages.append((f"inter_search_ref{i}", lambda ref=ref:
                       search_inter_frame(yp, ref[0], plan, ife.lambda_me,
                                          ife.cfg.me_range,
                                          subpel=ife.cfg.me_subpel)))
    stages += [("search_decide_mc", lambda: ife._p_predict(yp, refs)),
               ("recon_kernel", recon), ("deblock", deblock)]
    out = {"nref": nref, "cu": ife.cu,
           "inter_share": inter_map.float().mean().item(),
           "ref1_share": (ref_sel > 0).float().mean().item()}
    for name, fn in stages:
        fn()                                            # warm
        out[name + "_ms"] = cuda_ms(torch, fn, 3)
    ref_pocs = list(range(nref - 1, -1, -1))
    handle = ife.submit_p(*frames[nref], list(zip(ref_pocs, refs)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dl = ife.download_p(handle, need_recon=True)
    out["d2h_ms"] = 1000 * (time.perf_counter() - t0)
    (_lv, _modes, inter_h, ref_h, mv_h, *_rest), _rec, _recs = dl
    t0 = time.perf_counter()
    ife._merge_amvp_multi(inter_h, ref_h, mv_h, nref, nref, ref_pocs)
    out["merge_amvp_multi_ms"] = 1000 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ife.finalize_p_downloaded(dl, poc=nref, ref_pocs=ref_pocs)
    out["finalize_ms"] = 1000 * (time.perf_counter() - t0)
    ife.close()
    return out


def timed_stream(torch, wavefront, name, cfg, frames, warm, dev):
    """Encodes frames through Encoder.encode_stream on the card and
    times the results after the first ``warm`` (the clock starts when
    the warm-th result arrives); the launch counts are read around the
    whole run.  Returns (results, summary)."""
    from kvazaar_tpu_torch.api import Encoder
    enc = Encoder(cfg, device=dev)
    for k in wavefront.LAUNCHES:
        wavefront.LAUNCHES[k] = 0
    results = []
    t0 = time.perf_counter()
    for res in enc.encode_stream(frames):
        results.append(res)
        if len(results) == warm:
            t0 = time.perf_counter()
    dt = time.perf_counter() - t0
    launches = dict(wavefront.LAUNCHES)
    if len(results) != len(frames):
        raise RuntimeError(f"{name}: {len(results)} results for "
                           f"{len(frames)} frames")
    if min(launches.values()) == 0:
        raise RuntimeError(f"{name} did not launch both kernel variants: "
                           f"{launches}")
    kinds = [r[1].slice_type for r in results]
    if kinds[0] != 2 or any(k != 1 for k in kinds[1:]):
        raise RuntimeError(f"{name}: expected IDR + P frames, got {kinds}")
    bits, psnr_y = check_output(results[warm:], name)
    summary = dict(frames=len(frames), timed=len(frames) - warm,
                   fps=(len(frames) - warm) / dt, bits_per_frame=bits,
                   psnr_y=psnr_y, pipelined=enc.can_pipeline(),
                   qps=sorted({r[1].qp for r in results}),
                   kernel_launches=launches, stage_wall_s=enc.stats)
    log(f"{name} encode_stream:", json.dumps(summary))
    enc.close()
    return results, summary


def run_low_delay(torch, wavefront, clip46, dev):
    """Phase 10: the low-delay default operating points.  The wavefront
    kernel at cu 32 (luma S=32, Cb+Cr S=16) == plain, intra and inter,
    at 832x480 and 1920x1088; the ultrafast preset (the CLI's default),
    Config() (fixed cu 32 IPPP, pipelined) and the veryfast preset (SAO
    on the I frames) timed through Encoder.encode_stream, each with a
    stage split of one P frame against 2 references; and card == CPU
    bytes and recon for the seven low-delay configs at 256x128.
    Returns (cu 32 rows: intra, inter, joint; launches of the Config()
    run)."""
    from kvazaar_tpu_torch import Config
    from kvazaar_tpu_torch.api import Encoder
    from kvazaar_tpu_torch.config import config_from_preset

    frames = clip46[:FRAMES]
    rows = compare_kernel(torch, frames, dev, cus=(32,))
    inter_rows = compare_kernel_inter(torch, clip46, dev, cus=(32,))
    joint_rows = joint_launch(torch, frames, clip46, dev, cu=32,
                              big=BIG[:1], big_cus=(32,))

    clip8 = synth_clip_natural(8, W, H, seed=4)
    cells = (
        ("ultrafast", config_from_preset("ultrafast", width=W, height=H,
                                         qp=QP), clip8 * 2, len(clip8)),
        ("default-config", Config(width=W, height=H, qp=QP), clip46,
         IPPP_WARM),
        ("veryfast", config_from_preset("veryfast", width=W, height=H,
                                        qp=QP), clip8 * 2, len(clip8)))
    launches32 = None
    for name, cfg, clip, warm in cells:
        _results, summary = timed_stream(torch, wavefront, name, cfg, clip,
                                         warm, dev)
        if name == "default-config":
            if not summary["pipelined"]:
                raise RuntimeError("Config(): expected the pipelined path")
            launches32 = summary["kernel_launches"]
        log(f"{name} stage split (ms, one P frame, 2 references):",
            json.dumps(ld_p_split(torch, cfg, clip8, dev)))

    w, h = 256, 128
    small = synth_clip_natural(4, w, h, seed=0)
    checks = [(p, config_from_preset(p, width=w, height=h, qp=QP))
              for p in ("ultrafast", "superfast", "veryfast", "faster",
                        "fast")]
    checks += [("Config()", Config(width=w, height=h, qp=QP)),
               ("ref3-cu16", Config(width=w, height=h, qp=QP,
                                    intra_period=0, ref_frames=3,
                                    intra_min_cu=16, intra_max_cu=16))]
    for name, cfg in checks:
        clip = small[:3] if name == "fast" else small
        t0 = time.perf_counter()
        enc_card = Encoder(cfg, device=dev)
        card = [r for f in clip for r in enc_card.encode(*f)]
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        enc_cpu = Encoder(cfg, device="cpu")
        host = [r for f in clip for r in enc_cpu.encode(*f)]
        t_cpu = time.perf_counter() - t0
        for i, (c, hst) in enumerate(zip(card, host)):
            same_rec = all(np.array_equal(a, b) for a, b in zip(c[2], hst[2]))
            if c[0] != hst[0] or not same_rec or c[1].qp != hst[1].qp:
                raise RuntimeError(f"{name}: card and CPU differ at frame "
                                   f"{i}")
        log(f"{name} {w}x{h}: card == CPU bytes and recon over "
            f"{len(clip)} frames (QPs {[r[1].qp for r in card]}; card "
            f"{t_card:.3f} s, CPU {t_cpu:.3f} s)")
        enc_card.close()
        enc_cpu.close()
    return rows, inter_rows, joint_rows, launches32


def ippp_medium_config(width, height, **kw):
    """The medium preset's IPPP point (--gop 0 -p 0, one reference):
    variable P trees, intra CUs 8..32, inter CUs 8..64, RDOQ, SAO."""
    from kvazaar_tpu_torch.config import config_from_preset
    kw = dict(dict(qp=QP, intra_period=0, gop_len=1, ref_frames=1), **kw)
    return config_from_preset(kw.pop("preset", "medium"), width=width,
                              height=height, **kw)


def var_p_stage_split(torch, ife, frames):
    """Per-stage times of one variable P frame (frames[1] against the
    encoder's recon of frames[0]), each stage timed once by the host
    clock between synchronizes (the stages are host-bound, so this is
    also their device span): the coarse motion search, each size's
    intra and inter candidates, the whole search, tree and plan, merge
    RD, the cell MC, the direct inter pass alone, the whole var recon
    (with the ATen ops of one call), deblocking, SAO, the downloads,
    merge/AMVP + skip flags and CABAC, all in ms."""
    from kvazaar_tpu_torch.encoder import quadtree as qt
    from kvazaar_tpu_torch.encoder.frame_encoder import _set_sao, qp_to_lambda
    from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
    from kvazaar_tpu_torch.encoder.inter_search import mc_planes_cells
    from kvazaar_tpu_torch.encoder.intra_search import search_frame_modes
    from kvazaar_tpu_torch.ops.deblock import deblock_frame
    from kvazaar_tpu_torch.ops.inter import coarse_mv_grids

    cfg = ife.cfg
    ife.encode_frame(*frames[0])
    refs = ife._dpb
    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name + "_ms"] = 1000 * (time.perf_counter() - t0)
        return r

    planes = timed("upload", lambda: tuple(a[0] for a in ife._upload(
        ife.host_pack_sources([frames[1]]))))
    y, ref = planes[0], refs[0].to(torch.int32)
    lam_rd = qp_to_lambda(cfg.qp)
    sizes = [s for s in (8, 16, 32)
             if cfg.inter_min_cu <= s <= cfg.inter_max_cu]
    hints = timed("coarse_me", lambda: coarse_mv_grids(
        y, ref, cfg.me_range, tuple(sizes)))
    for s in (8, 16, 32):
        plan = make_intra_plan(ife.coded_w, ife.coded_h, s, chroma=False)
        if cfg.intra_min_cu <= s <= cfg.intra_max_cu:
            timed(f"intra_{s}", lambda: qt.intra_rd_recost(
                y, plan, search_frame_modes(y, plan, ife.lambda_satd, 8,
                                            cfg.rd >= 1)[0],
                cfg.qp, lam_rd, 8, p_slice=True))
        if s in hints:
            timed(f"inter_{s}", lambda: qt._inter_cost(
                y, ref, plan, hints[s], ife.lambda_satd, cfg.me_range, 8,
                cfg.me_subpel, cfg.qp, lam_rd))
    found = timed("search_total", lambda: ife.var_p_search(y, refs[0]))
    size8, sched_size8, mode_maps, inter8, mv_cells, vp = timed(
        "tree_and_plan", lambda: ife.var_p_plan(*found))
    mv_cells = timed("merge_rd", lambda: ife.merge_rd_p(
        y, refs[0], size8, inter8, mv_cells))
    sched = timed("sched_upload", lambda: ife.var_p_sched(
        vp, planes, size8, inter8, mv_cells))
    mcs = timed("mc", lambda: mc_planes_cells(*refs, sched["mv_cells"]))

    def direct():
        for kind, pls, mc, (pw, ph), kqp in (
                ("iluma", planes[:1], mcs[:1], (ife.coded_w, ife.coded_h),
                 cfg.qp),
                ("ichroma", planes[1:], mcs[1:],
                 (ife.coded_w // 2, ife.coded_h // 2), ife.qp_c)):
            n = len(pls) * pw * ph
            qt._direct_pass(sched[kind], pls, mc, pw, ph, kqp, 8,
                            cfg.signhide, cfg.rdoq, lam_rd,
                            torch.zeros(n, dtype=torch.int32,
                                        device=y.device),
                            torch.zeros(n, dtype=torch.int16,
                                        device=y.device))

    timed("direct_pass", direct)

    def recon():
        return qt.reconstruct_frame_var(
            sched, cfg.qp, ife.qp_c, ife.coded_w, ife.coded_h, True,
            signhide=cfg.signhide, rdoq=cfg.rdoq, lam=lam_rd, mc_planes=mcs)

    recs, levels, cbf8 = timed("var_recon", recon)

    def deblock():
        bs_v, bs_h = qt.var_bs_maps(sched["inter8"], cbf8, sched["mv_cells"],
                                    sched["edge_v"], sched["edge_h"])
        return tuple(r.to(torch.uint8) for r in deblock_frame(
            *recs, cfg.qp, 8, bs_v=bs_v, bs_h=bs_h))

    recs = timed("deblock", deblock)
    sao = None
    if cfg.sao:
        recs, sao = timed("sao", lambda: ife.var_sao(planes, recs))
    host = timed("d2h", lambda: (
        [r.cpu().numpy() for r in recs],
        [lv.cpu().numpy() for lv in levels],
        None if sao is None else sao.cpu().numpy()))
    fd = timed("merge_amvp_skip", lambda: ife.var_p_frame_data(
        size8, sched_size8, mode_maps, inter8, mv_cells, host[1]))
    _set_sao(fd, host[2])
    timed("cabac", lambda: ife._serialize_p(fd, 1, 1))
    out["frame_ms"] = sum(out[k] for k in (
        "upload_ms", "search_total_ms", "tree_and_plan_ms", "merge_rd_ms",
        "sched_upload_ms", "mc_ms", "var_recon_ms", "deblock_ms",
        "sao_ms", "d2h_ms", "merge_amvp_skip_ms", "cabac_ms") if k in out)
    out["n_steps_real"] = vp.n_steps_real
    out["inter_share"] = float(inter8.mean())
    out["recon_aten_ops"] = count_aten_ops(torch, recon)
    return out


def run_var_p(torch, wavefront, clip46, dev):
    """Phase 11: variable P trees with one reference.  The medium
    preset's IPPP point at 832x480 through Encoder.encode_stream (IDR +
    1 P warm-up, then VAR_P_TIMED timed P frames of the 46-frame motion
    clip), with its CU-size histogram and inter share and a stage split
    of one P frame; card == CPU bytes and recon at 256x128 (IDR + 2 P)
    for medium, slower and ultrafast at --gop 0 (ultrafast's fixed-grid
    I frame launching the CUDA kernel); and a set_base_qp +
    reset_stream ladder (QP 22 -> 27) on the card against fresh
    encoders."""
    from kvazaar_tpu_torch.api import Encoder
    cfg = ippp_medium_config(W, H)
    enc = Encoder(cfg, device=dev)
    if enc.can_pipeline():
        raise RuntimeError("ippp-medium: expected the per-frame path")
    ife = enc._intra
    trees = []
    plan_fn = ife.var_p_plan

    def keep_tree(*a):
        r = plan_fn(*a)
        trees.append((r[0], r[3]))
        return r

    ife.var_p_plan = keep_tree
    clip = clip46[:2 + VAR_P_TIMED]
    results = []
    t0 = time.perf_counter()
    for res in enc.encode_stream(clip):
        results.append(res)
        if len(results) == 2:
            t0 = time.perf_counter()
    dt = time.perf_counter() - t0
    del ife.var_p_plan
    if [r[1].slice_type for r in results] != [2] + [1] * (len(clip) - 1):
        raise RuntimeError("ippp-medium: expected IDR + P frames")
    bits_p, psnr_p = check_output(results[2:], "ippp-medium")
    cus, inter = {}, []
    for size8, inter8 in trees[1:]:
        sizes, cells = np.unique(size8, return_counts=True)
        for sz, c in zip(sizes, cells):
            cus[int(sz)] = cus.get(int(sz), 0) + int(c) * 64 // int(sz) ** 2
        inter.append(float(inter8.mean()))
    log("ippp-medium encode_stream:", json.dumps(dict(
        frames=len(clip), timed=VAR_P_TIMED, fps=VAR_P_TIMED / dt,
        idr_bits=results[0][1].bits, p_bits_per_frame=bits_p,
        psnr_y_p=psnr_p, idr_psnr_y=results[0][1].psnr_y,
        cus_by_size=cus, inter_share_of_cells=inter)))
    log("ippp-medium stage split (ms, one P frame):", json.dumps(
        var_p_stage_split(torch, enc._intra, clip46[:2])))
    enc.close()

    # At 128x64 (at 416x240 the CPU's var-tree encodes took 9 s each).
    w, h = 128, 64
    small = synth_clip_natural(3, w, h, seed=0)
    for name in ("medium", "slower", "ultrafast"):
        if name == "ultrafast":
            from kvazaar_tpu_torch.config import config_from_preset
            cfg = config_from_preset(name, width=w, height=h, qp=QP,
                                     lp_gop=None)
        else:
            cfg = ippp_medium_config(w, h, preset=name)
        for k in wavefront.LAUNCHES:
            wavefront.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        enc_card = Encoder(cfg, device=dev)
        card = [r for f in small for r in enc_card.encode(*f)]
        t_card = time.perf_counter() - t0
        launches = dict(wavefront.LAUNCHES)
        if name == "ultrafast" and launches["intra"] == 0:
            raise RuntimeError("ultrafast --gop 0: the I frame did not "
                               "launch the kernel")
        t0 = time.perf_counter()
        enc_cpu = Encoder(cfg, device="cpu")
        host = [r for f in small for r in enc_cpu.encode(*f)]
        t_cpu = time.perf_counter() - t0
        for i, (c, hst) in enumerate(zip(card, host)):
            if c[0] != hst[0] or not all(
                    np.array_equal(a, b) for a, b in zip(c[2], hst[2])):
                raise RuntimeError(f"{name} --gop 0: card and CPU differ at "
                                   f"frame {i}")
        log(f"{name} --gop 0 {w}x{h}: card == CPU bytes and recon over "
            f"{len(small)} frames (bits {[r[1].bits for r in card]}; "
            f"kernel launches {launches}; card {t_card:.3f} s, CPU "
            f"{t_cpu:.3f} s)")
        if name == "medium":
            enc_card.set_base_qp(27)
            enc_card.reset_stream()
            ladder = [r[0] for f in small for r in enc_card.encode(*f)]
            fresh = Encoder(ippp_medium_config(w, h, qp=27), device=dev)
            if ladder != [r[0] for f in small for r in fresh.encode(*f)]:
                raise RuntimeError("set_base_qp ladder: QP 27 differs from "
                                   "a fresh encoder")
            enc_card.set_base_qp(22)
            enc_card.reset_stream()
            again = [r[0] for f in small for r in enc_card.encode(*f)]
            if again != [r[0] for r in card]:
                raise RuntimeError("set_base_qp ladder: back at QP 22 the "
                                   "stream differs")
            log(f"set_base_qp ladder on the card (QP 22 -> 27 -> 22 with "
                f"reset_stream): == fresh encoders ({len(ladder)} frames "
                f"per QP)")
        enc_card.close()
        enc_cpu.close()


def gop_fixed_config(width, height, **kw):
    """GOP 8 on the fixed 16x16 grid (tests/test_gop.py's structure)."""
    from kvazaar_tpu_torch import Config
    return Config(width=width, height=height, qp=kw.pop("qp", QP),
                  intra_min_cu=16, intra_max_cu=16, gop_len=GOP,
                  intra_period=0, **kw)


def gop_medium_config(width, height, **kw):
    """The medium preset's default: GOP 8, variable B trees (intra CUs
    8..32, inter CUs 8..64), bipred, RDOQ, SAO."""
    from kvazaar_tpu_torch.config import config_from_preset
    return config_from_preset("medium", width=width, height=height,
                              **dict(dict(qp=QP), **kw))


def compare_kernel_b(torch, clip46, dev):
    """Phase 12: the inter variant == plain on a real fixed-grid B frame
    (frame 1 between the recon of frame 0 and of frame 2, coded as a P
    frame against it): its modes, inter map and L0 / L1 / bi-averaged MC
    planes.  Returns the rows."""
    from kvazaar_tpu_torch.encoder.frame_encoder import IntraFrameEncoder
    from kvazaar_tpu_torch.encoder.inter_search import bi_mc_planes
    from kvazaar_tpu_torch.encoder.intra_recon import wavefront_recon_plain
    from kvazaar_tpu_torch.ops.wavefront import wavefront_recon

    ife = IntraFrameEncoder(gop_fixed_config(W, H), device=dev)
    ife.submit_frames([clip46[0]])
    r0 = ife._dpb
    r1 = ife.submit_p(*clip46[2], [(0, r0)])[5]
    ys, cbs, crs = ife._upload(ife.host_pack_sources([clip46[1]]))
    modes, inter_map, dirs, mv0, mv1 = ife._b_predict(ys[0], r0[0], r1[0])
    mc_y, mc_cb, mc_cr = bi_mc_planes(r0, r1, mv0, mv1, dirs, ife.plan)
    share = {d: (inter_map & (dirs == k)).float().mean().item()
             for k, d in enumerate(("l0", "l1", "bi"))}
    if min(share.values()) == 0:
        raise RuntimeError(f"B frame: not every direction used: {share}")
    rows = []
    for orig, s, luma, qp, mc in (
            (ys, 16, True, QP, mc_y[None]),
            (torch.cat([cbs, crs]), 8, False, ife.qp_c,
             torch.stack([mc_cb, mc_cr]))):
        args = (orig, modes[None], ife.plan, s, luma, qp, 8,
                inter_map[None], mc.to(torch.uint8))
        got = wavefront_recon(*args)
        err = max_err(torch, got, wavefront_recon_plain(*args))
        row = dict(cu=16, s=s, luma=luma, items=orig.shape[0], b_frame=True,
                   dir_share=share, max_abs_err=err)
        time_row(torch, row, args, {}, ife.plan)
        row["bound_ms"], row["bound_by"] = bound_ms(
            (orig, modes, inter_map.to(torch.uint8), args[-1], *got),
            [(orig.numel(), s)])
        log("inter kernel vs plain:", json.dumps(row))
        if err != 0:
            raise RuntimeError(f"inter kernel != plain on a B frame: {row}")
        rows.append(row)
    return rows


def gop_summary(results, warm, dt, name):
    """fps, bits per frame by slice type, PSNR-Y and the POC order of a
    GOP run timed after ``warm`` results."""
    kinds = {}
    for r in results[warm:]:
        k = ("I" if r[1].slice_type == 2 else
             "P" if r[1].poc % GOP == 0 else "B")
        kinds.setdefault(k, []).append(r[1].bits)
    _bits, psnr_y = check_output(results[warm:], name)
    return dict(frames=len(results), timed=len(results) - warm,
                fps=(len(results) - warm) / dt,
                bits_per_frame={k: sum(v) / len(v) for k, v in kinds.items()},
                psnr_y=psnr_y, poc_order=[r[1].poc for r in results])


def timed_gop(torch, cfg, clip, n_timed, dev, hook=None):
    """Encodes the IDR and one GOP (warm), then n_timed frames, of clip
    through Encoder.encode_stream on the card; the clock runs
    from the warm GOP's last result to the end.  hook(enc) runs before
    the encode.  Returns (encoder, results, seconds)."""
    from kvazaar_tpu_torch.api import Encoder
    enc = Encoder(cfg, device=dev)
    if enc.can_pipeline():
        raise RuntimeError("GOP: expected the per-frame path")
    if hook:
        hook(enc)
    frames = clip[:GOP + 1 + n_timed]
    results = []
    t0 = time.perf_counter()
    for res in enc.encode_stream(frames):
        results.append(res)
        if len(results) == GOP + 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    dt = time.perf_counter() - t0
    if len(results) != len(frames):
        raise RuntimeError(f"GOP: {len(results)} results for {len(frames)} "
                           "frames")
    return enc, results, dt


def var_b_stage_split(torch, ife, frames):
    """Per-stage times of one variable B frame (frames[1] at POC 1, the
    GOP-8 layer of QP + 4, between the IDR of frames[0] and frames[2]
    coded as a P frame at POC 2), each stage timed once by the host clock
    between synchronizes: search (L0, L1, bi check at every size), tree
    and plan, B merge RD, the bi cell MC, the direct inter pass alone,
    the whole var recon, deblocking, SAO, the downloads, merge/AMVP +
    skip flags and CABAC, all in ms (phase 11 counts the ATen ops of a
    var P recon; a B frame's are not counted, to save the run's time)."""
    from kvazaar_tpu_torch.constants import SLICE_B
    from kvazaar_tpu_torch.encoder import quadtree as qt
    from kvazaar_tpu_torch.encoder.frame_encoder import _set_sao, chroma_qp
    from kvazaar_tpu_torch.encoder.inter_search import bi_mc_planes_cells
    from kvazaar_tpu_torch.ops.deblock import deblock_frame

    cfg = ife.cfg
    ife.encode_frame(*frames[0])
    r0 = ife._dpb
    ife.encode_frame_var_p(*frames[2], poc=2, ref_poc=0, qp=cfg.qp + 3,
                           qp_factor=0.3536)
    r1 = ife._dpb
    ql = ife._var_frame_qp_lam(cfg.qp + 4, 0.68, SLICE_B)
    qp, lam_rd = ql[0], ql[1]
    out = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name + "_ms"] = 1000 * (time.perf_counter() - t0)
        return r

    planes = timed("upload", lambda: tuple(a[0] for a in ife._upload(
        ife.host_pack_sources([frames[1]]))))
    found = timed("search_total", lambda: ife.var_b_search(
        planes[0], r0[0], r1[0], ql))
    size8, sched_size8, mode_maps, inter8, dirs8, emv0, emv1, vp = timed(
        "tree_and_plan", lambda: ife.var_b_plan(*found, ql))
    dirs8, emv0, emv1 = timed("merge_rd", lambda: ife.merge_rd_b(
        planes[0], r0[0], r1[0], size8, inter8, dirs8, emv0, emv1, 1,
        (0, 2), ql))
    sched = timed("sched_upload", lambda: ife.var_b_sched(
        vp, planes, size8, inter8, dirs8, emv0, emv1))
    mcs = timed("mc", lambda: bi_mc_planes_cells(
        r0, r1, sched["mv_cells"], sched["mv1_cells"], sched["dirs8"]))

    def direct():
        for kind, pls, mc, (pw, ph), kqp in (
                ("iluma", planes[:1], mcs[:1], (ife.coded_w, ife.coded_h),
                 qp),
                ("ichroma", planes[1:], mcs[1:],
                 (ife.coded_w // 2, ife.coded_h // 2), chroma_qp(qp))):
            n = len(pls) * pw * ph
            qt._direct_pass(sched[kind], pls, mc, pw, ph, kqp, 8,
                            cfg.signhide, cfg.rdoq, lam_rd,
                            torch.zeros(n, dtype=torch.int32,
                                        device=pls[0].device),
                            torch.zeros(n, dtype=torch.int16,
                                        device=pls[0].device))

    timed("direct_pass", direct)

    def recon():
        return qt.reconstruct_frame_var(
            sched, qp, chroma_qp(qp), ife.coded_w, ife.coded_h, True,
            signhide=cfg.signhide, rdoq=cfg.rdoq, lam=lam_rd, mc_planes=mcs)

    recs, levels, cbf8 = timed("var_recon", recon)

    def deblock():
        bs_v, bs_h = qt.var_bs_maps(
            sched["inter8"], cbf8, sched["mv_cells"], sched["edge_v"],
            sched["edge_h"], mv1_cells=sched["mv1_cells"],
            dirs8=sched["dirs8"])
        return tuple(r.to(torch.uint8) for r in deblock_frame(
            *recs, qp, 8, bs_v=bs_v, bs_h=bs_h))

    recs = timed("deblock", deblock)
    sao = None
    if cfg.sao:
        recs, sao = timed("sao", lambda: ife.var_sao(planes, recs,
                                                     lam=lam_rd))
    host = timed("d2h", lambda: (
        [r.cpu().numpy() for r in recs],
        [lv.cpu().numpy() for lv in levels],
        None if sao is None else sao.cpu().numpy()))
    fd = timed("merge_amvp_skip", lambda: ife.var_b_frame_data(
        size8, sched_size8, mode_maps, inter8, dirs8, emv0, emv1, host[1],
        1, (0, 2)))
    _set_sao(fd, host[2])
    timed("cabac", lambda: ife._serialize_b(fd, 1, 1, 1, qp=qp))
    out["frame_ms"] = sum(out[k] for k in (
        "upload_ms", "search_total_ms", "tree_and_plan_ms", "merge_rd_ms",
        "sched_upload_ms", "mc_ms", "var_recon_ms", "deblock_ms",
        "sao_ms", "d2h_ms", "merge_amvp_skip_ms", "cabac_ms") if k in out)
    out["n_steps_real"] = vp.n_steps_real
    out["inter_share"] = float(inter8.mean())
    out["bi_share_of_inter"] = float((dirs8[inter8] == 2).mean()) \
        if inter8.any() else 0.0
    return out


def card_equals_cpu(name, cfg, clip, dev, with_flush=True):
    """Encodes clip with cfg on the card and on the CPU through
    Encoder.encode (and flush); raises unless every picture's bytes and
    recon agree.  Returns the card's results."""
    from kvazaar_tpu_torch.api import Encoder
    runs = []
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        enc = Encoder(cfg, device=d)
        res = [r for f in clip for r in enc.encode(*f)]
        if with_flush:
            res += enc.flush()
        runs.append((res, time.perf_counter() - t0))
        enc.close()
    (card, t_card), (host, t_cpu) = runs
    if len(card) != len(clip) or len(host) != len(clip):
        raise RuntimeError(f"{name}: {len(card)} / {len(host)} results for "
                           f"{len(clip)} frames")
    for i, (c, hst) in enumerate(zip(card, host)):
        if c[0] != hst[0] or c[1].poc != hst[1].poc or not all(
                np.array_equal(a, b) for a, b in zip(c[2], hst[2])):
            raise RuntimeError(f"{name}: card and CPU differ at picture {i}")
    log(f"{name}: card == CPU bytes and recon over {len(clip)} frames "
        f"(POCs {[r[1].poc for r in card]}, QPs {[r[1].qp for r in card]}; "
        f"card {t_card:.3f} s, CPU {t_cpu:.3f} s)")
    return card


def run_gop(torch, wavefront, clip46, dev):
    """Phase 12: B pyramids.  The inter variant on a real B frame's
    bi-averaged MC planes == plain; GOP 8 on the fixed cu 16 grid and the
    medium preset's default (variable B trees) at 832x480 through
    Encoder.encode_stream, each warm over the IDR and one GOP and then
    timed, with a stage split of one variable B frame; card == CPU for a
    fixed-grid GOP 8, medium's GOP 8 with a tail and an open GOP with CRA
    and RASL pictures; and a set_base_qp + reset_stream ladder on a GOP-8
    medium encoder.  Returns the B-frame kernel rows."""
    from kvazaar_tpu_torch.api import Encoder
    from kvazaar_tpu_torch.constants import NAL_CRA_NUT
    from kvazaar_tpu_torch.encoder import frame_encoder as fe

    rows = compare_kernel_b(torch, clip46, dev)
    # The 46-frame motion clip: a clip that repeats every 8 frames would
    # make each P anchor a copy of the IDR.

    # GOP 8 on the fixed grid: each B frame's inter launches.
    per_b = []
    encode_b = fe.PFrameMixin.encode_b_frame

    def counted(self, y, cb, cr, poc, *a, **k):
        n0 = wavefront.LAUNCHES["inter"]
        r = encode_b(self, y, cb, cr, poc, *a, **k)
        per_b.append((poc, wavefront.LAUNCHES["inter"] - n0))
        return r

    for k in wavefront.LAUNCHES:
        wavefront.LAUNCHES[k] = 0
    fe.PFrameMixin.encode_b_frame = counted
    try:
        enc, results, dt = timed_gop(torch, gop_fixed_config(W, H),
                                     clip46, 2 * GOP, dev)
    finally:
        fe.PFrameMixin.encode_b_frame = encode_b
    launches = dict(wavefront.LAUNCHES)
    if len(per_b) != 3 * (GOP - 1) or min(n for _p, n in per_b) == 0:
        raise RuntimeError(f"gop8-fixed16: a B frame launched no kernel: "
                           f"{per_b}")
    summary = gop_summary(results, GOP + 1, dt, "gop8-fixed16")
    summary.update(kernel_launches=launches,
                   inter_launches_per_b_frame=[n for _p, n in per_b])
    log("gop8-fixed16 encode_stream:", json.dumps(summary))
    enc.close()

    # The medium default: variable B trees.
    trees = []

    def keep_trees(enc):
        ife = enc._intra
        for name, at in (("var_p_plan", 3), ("var_b_plan", 3)):
            fn = getattr(ife, name)

            def keep(*a, _fn=fn, _at=at):
                r = _fn(*a)
                trees.append((r[0], r[_at]))
                return r
            setattr(ife, name, keep)

    for k in wavefront.LAUNCHES:
        wavefront.LAUNCHES[k] = 0
    enc, results, dt = timed_gop(torch, gop_medium_config(W, H), clip46,
                                 GOP, dev, hook=keep_trees)
    summary = gop_summary(results, GOP + 1, dt, "gop8-medium")
    cus, inter = {}, []
    for size8, inter8 in trees[-GOP:]:
        sizes, cells = np.unique(size8, return_counts=True)
        for sz, c in zip(sizes, cells):
            cus[int(sz)] = cus.get(int(sz), 0) + int(c) * 64 // int(sz) ** 2
        inter.append(float(inter8.mean()))
    summary.update(kernel_launches=dict(wavefront.LAUNCHES),
                   cus_by_size=cus, inter_share_of_cells=inter)
    log("gop8-medium encode_stream:", json.dumps(summary))
    enc.close()
    ife = fe.IntraFrameEncoder(gop_medium_config(W, H), device=dev)
    log("gop8-medium stage split (ms, one B frame):", json.dumps(
        var_b_stage_split(torch, ife, clip46[:3])))
    ife.close()

    # At 128x64 (at 416x240 the CPU's encode of the fixed grid took 12 s,
    # and its var-tree encodes most of the phase).
    w, h = 128, 64
    card_equals_cpu(f"gop8-fixed16 {w}x{h}", gop_fixed_config(w, h),
                    synth_clip_natural(9, w, h, seed=0), dev)
    small = synth_clip_natural(11, w, h, seed=0)
    card = card_equals_cpu(f"gop8-medium {w}x{h}", gop_medium_config(w, h),
                           small, dev)
    cra = card_equals_cpu(f"open-gop4-medium {w}x{h}", gop_medium_config(
        w, h, gop_len=4, intra_period=4), synth_clip_natural(
        9, w, h, seed=3), dev)
    if [r[1].nal_type for r in cra].count(NAL_CRA_NUT) != 2:
        raise RuntimeError("open GOP: expected two CRA pictures")

    enc = Encoder(gop_medium_config(w, h), device=dev)
    first = [r[0] for r in card[:GOP + 1]]
    ladder = {}
    for qp in (22, 27, 22):
        enc.set_base_qp(qp)
        enc.reset_stream()
        got = [r[0] for f in small[:GOP + 1] for r in enc.encode(*f)]
        if qp in ladder and got != ladder[qp]:
            raise RuntimeError("GOP set_base_qp ladder: back at QP 22 the "
                               "stream differs")
        ladder[qp] = got
    fresh = Encoder(gop_medium_config(w, h, qp=27), device=dev)
    if ladder[27] != [r[0] for f in small[:GOP + 1]
                      for r in fresh.encode(*f)] or ladder[22] != first:
        raise RuntimeError("GOP set_base_qp ladder differs from fresh "
                           "encoders")
    log(f"GOP-8 medium set_base_qp ladder on the card (QP 22 -> 27 -> 22 "
        f"with reset_stream): == fresh encoders ({GOP + 1} frames per QP)")
    enc.close()
    fresh.close()
    return rows


RC_BITRATE = 2_000_000                # phase 13's cell: target bits/s


def rc_config(width, height, **kw):
    """Config() at QP 22 with a target bitrate and one IDR: fixed cu 32,
    LCU rate control with cu_qp_delta, 25 fps, one reference."""
    from kvazaar_tpu_torch import Config
    return Config(width=width, height=height, qp=QP,
                  **dict(dict(bitrate=RC_BITRATE, intra_period=0), **kw))


def compare_kernel_qp(torch, frames, clip46, dev):
    """Phase 13 (i): the joint launch with a per-block QP map (a random
    per-CTU map in [QP - 6, QP + 6], each block at its CTU's QP, chroma
    through Table 8-10) == the plain version per plane kind, intra and
    inter at cu 16 and 32, at 832x480 (the searched modes of one frame;
    a real P frame) and 1920x1088 (random inputs); a uniform map gives
    the scalar launch's levels and recon; timed against the scalar
    launch, with the bound.  Returns the rows."""
    from kvazaar_tpu_torch.constants import CHROMA_QP_TAB
    from kvazaar_tpu_torch.encoder.frame_encoder import (IntraFrameEncoder,
                                                         chroma_qp)
    from kvazaar_tpu_torch.encoder.intra_recon import wavefront_recon_plain
    from kvazaar_tpu_torch.encoder.intra_search import search_frame_modes
    from kvazaar_tpu_torch.ops.wavefront import wavefront_recon_planes

    rng = np.random.default_rng(13)
    rows = []

    def row_of(shape, ife, planes, modes, inter):
        plan, cu = ife.plan, ife.plan.cu_size
        cy, cx = -(-ife.coded_h // 64), -(-ife.coded_w // 64)
        qp_ctu = torch.from_numpy(rng.integers(
            QP - 6, QP + 7, (modes.shape[0], cy, cx), dtype=np.int32)).to(dev)
        qmap = ife._qp_blk_of(qp_ctu).contiguous()
        cmap = torch.from_numpy(CHROMA_QP_TAB.astype(np.int32)).to(dev)[
            qmap.long()]
        kw = {} if inter is None else dict(
            zip(("is_inter", "mc_y", "mc_cb", "mc_cr"), inter))

        def launch(qp_map=None):
            return wavefront_recon_planes(*planes, modes, plan, QP,
                                          chroma_qp(QP), qp_map=qp_map, **kw)

        got = launch(qmap)
        want = []

        def plain():
            for orig, mc, s, luma, m in (
                    (planes[0], kw.get("mc_y"), cu, True, qmap),
                    (planes[1], kw.get("mc_cb"), cu // 2, False, cmap),
                    (planes[2], kw.get("mc_cr"), cu // 2, False, cmap)):
                want.extend(wavefront_recon_plain(
                    orig, modes, plan, s, luma, QP, 8, kw.get("is_inter"),
                    mc, m))

        # The plain version runs once, timed while it computes the
        # reference outputs (seconds per run at 1920x1088).
        plain_ms = cuda_ms(torch, plain, 1)
        err = max_err(torch, got, want)
        uniform = torch.full_like(qmap, QP)
        same = max_err(torch, launch(uniform), launch()) == 0
        row = dict(shape=shape, cu=cu, variant="intra" if inter is None
                   else "inter", items=planes[0].shape[0], max_abs_err=err,
                   uniform_equals_scalar=same,
                   qp_range=[int(qmap.min()), int(qmap.max())],
                   ms=cuda_ms(torch, lambda: launch(qmap), 20),
                   scalar_ms=cuda_ms(torch, launch, 20), plain_ms=plain_ms,
                   n_steps=plan.n_steps)
        row["bound_ms"], row["bound_by"] = bound_ms(
            (*planes, modes, qmap, cmap, *kw.values(), *got),
            [(planes[0].numel(), cu), (2 * planes[1].numel(), cu // 2)])
        log("qp-map kernel vs plain:", json.dumps(row))
        if err != 0 or not same:
            raise RuntimeError(f"qp-map launch != plain at {row}")
        rows.append(row)

    for cu in (16, 32):
        ife = IntraFrameEncoder(headline_config(W, H, cu), device=dev)
        planes = ife._upload(ife.host_pack_sources(frames[:1]))
        modes = search_frame_modes(planes[0][0], ife.plan,
                                   ife.lambda_satd)[0][None]
        row_of(f"{W}x{H} 1 I frame", ife, planes, modes, None)
        ife, (ys, cbs, crs), modes, inter_map, mcs = p_frame_inputs(
            torch, clip46, cu, dev)
        row_of(f"{W}x{H} 1 P frame", ife, (ys, cbs, crs), modes[None],
               (inter_map[None], *(m[None] for m in mcs)))
        big_w, big_h = BIG[0]
        ife = IntraFrameEncoder(headline_config(big_w, big_h, cu),
                                device=dev)
        plan = ife.plan

        def rand(shape, hi, dtype=np.uint8):
            return torch.from_numpy(rng.integers(0, hi, shape,
                                                 dtype=dtype)).to(dev)

        planes = (rand((1, big_h, big_w), 256),
                  rand((1, big_h // 2, big_w // 2), 256),
                  rand((1, big_h // 2, big_w // 2), 256))
        modes = rand((1, plan.blocks_y, plan.blocks_x), 35, np.int32)
        row_of(f"{big_w}x{big_h} random intra", ife, planes, modes, None)
        row_of(f"{big_w}x{big_h} random inter", ife, planes, modes,
               (rand(tuple(modes.shape), 2) != 0,
                *(rand(tuple(p.shape), 256) for p in planes)))
    return rows


def rc_p_split(torch, enc, y, cb, cr, poc):
    """Per-stage times (ms) of one P frame of the rate-controlled cell
    after its run (the encoder's DPB as reference; its state is read,
    not advanced): the controller and the per-CTU map on the host; the
    device program of the frame by wall clock after a synchronize; and
    inside it, by CUDA events, the reconstruction with the QP map
    against the same launch at the frame QP, the effective-QP chain and
    deblocking with the effective map against the scalar QP; then the
    downloads and CABAC with cu_qp_delta."""
    from kvazaar_tpu_torch.encoder.frame_encoder import compute_bs_maps
    from kvazaar_tpu_torch.encoder.intra_recon import reconstruct_frames
    from kvazaar_tpu_torch.ops.deblock import deblock_frame
    ife, out = enc._intra, {}
    ref = ife._dpb
    t0 = time.perf_counter()
    _lam, qp = enc._rc.frame_lambda_qp(False)
    qmap = enc._qp_ctu_for(min(max(qp, enc._prev_qp - 3),
                               enc._prev_qp + 3), y, False)
    out["rc_and_map_ms"] = 1000 * (time.perf_counter() - t0)
    for _ in range(2):                     # warm, then timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = ife.submit_p(y, cb, cr, [(poc - 1, ref)], qmap)
        torch.cuda.synchronize()
    out["p_program_ms"] = 1000 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    dl = ife.download_p(handle)
    out["d2h_ms"] = 1000 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ife.finalize_p_downloaded(dl, poc, [poc - 1], multi=False, qp_ctu=qmap)
    out["cabac_ms"] = 1000 * (time.perf_counter() - t0)

    ys, cbs, crs = ife._upload(ife.host_pack_sources([(y, cb, cr)]))
    modes, inter_map, ref_sel, mv, mcs = ife._p_predict(ys[0], [ref])
    qp_ctu = ife._upload_qp(qmap)[None]
    qp_blk = ife._qp_blk_of(qp_ctu)
    box = {}

    def recon(qp_map):
        box["rec"] = reconstruct_frames(
            ys, cbs, crs, modes[None], ife.plan, QP, ife.qp_c,
            is_inter=inter_map[None], mc_y=mcs[0][None], mc_cb=mcs[1][None],
            mc_cr=mcs[2][None], qp_map=qp_map)

    def deblock(with_map):
        rec = box["rec"]
        cbf = (rec[1][0] != 0).flatten(1).any(dim=1).reshape(
            ife.plan.blocks_y, ife.plan.blocks_x)
        bs_v, bs_h = compute_bs_maps(inter_map, cbf, mv, ref=ref_sel)
        qm = (ife._deblock_qp_map(qp_ctu, (rec[1], rec[3], rec[5]))
              if with_map else None)
        deblock_frame(rec[0], rec[2], rec[4], QP, ife.cu, bs_v=bs_v,
                      bs_h=bs_h, qp_map=qm)

    for name, fn in (("recon_scalar", lambda: recon(None)),
                     ("recon_qp_map", lambda: recon(qp_blk)),
                     ("effective_qp", lambda: ife._deblock_qp_map(
                         qp_ctu, (box["rec"][1], box["rec"][3],
                                  box["rec"][5]))),
                     ("deblock_scalar", lambda: deblock(False)),
                     ("deblock_qp_map", lambda: deblock(True))):
        fn()                                            # warm
        out[name + "_ms"] = cuda_ms(torch, fn, 3)
    return out


def run_rate_control(torch, wavefront, clip46, dev):
    """Phase 13: rate control and per-CTU QP.  The kernel with a per-block
    QP map == plain (``compare_kernel_qp``); the cell rc-ippp-832x480-2mbps
    (Config() at QP 22 with --bitrate 2000000: LCU rate control through
    cu_qp_delta, fixed cu 32, one reference) through Encoder.encode_stream,
    IDR + 5 P frames warm and 40 P frames timed, one kernel launch with a
    QP map per P frame; card == CPU bytes and recon for ROI + AQ
    all-intra (256x128), the medium preset with --bitrate (128x64; GOP
    8, variable B trees, the GOP allocation; a GOP and a 2-frame tail)
    and the ultrafast preset with --bitrate (256x128; low-delay GOP,
    frame-level rate control).  Returns (kernel rows, the cell's QP-map launches)."""
    from kvazaar_tpu_torch.api import Encoder
    from kvazaar_tpu_torch.config import config_from_preset

    rows = compare_kernel_qp(torch, clip46[:FRAMES], clip46, dev)

    enc = Encoder(rc_config(W, H), device=dev)
    if enc.can_pipeline() or not enc.cfg.cu_qp_delta_active:
        raise RuntimeError("rc cell: expected per-CTU QP, per frame")
    ctu_qps, frame_qps = [], []
    note, rc_qp = enc._note_ctu_weights, enc._rc_qp

    def keep_map(fd, is_intra):
        ctu_qps.append(fd.qp_ctu.copy())
        return note(fd, is_intra)

    def keep_qp(lam, qp):
        out = rc_qp(lam, qp)
        frame_qps.append(out[1])
        return out

    enc._note_ctu_weights, enc._rc_qp = keep_map, keep_qp
    for counts in (wavefront.LAUNCHES, wavefront.QP_MAP_LAUNCHES):
        for k in counts:
            counts[k] = 0
    results, per_frame = [], []
    before = dict(wavefront.QP_MAP_LAUNCHES)
    t0 = time.perf_counter()
    for res in enc.encode_stream(clip46):
        now = dict(wavefront.QP_MAP_LAUNCHES)
        per_frame.append({k: now[k] - before[k] for k in now})
        before = now
        results.append(res)
        if len(results) == IPPP_WARM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
    dt = time.perf_counter() - t0
    launches = dict(wavefront.LAUNCHES)
    qp_launches = dict(wavefront.QP_MAP_LAUNCHES)
    if per_frame[0] != {"intra": 1, "inter": 0} or any(
            f != {"intra": 0, "inter": 1} for f in per_frame[1:]):
        raise RuntimeError(f"rc cell: expected one QP-map launch per "
                           f"frame, got {per_frame}")
    if launches != qp_launches:
        raise RuntimeError(f"rc cell: launches without a QP map: "
                           f"{launches} / {qp_launches}")
    kinds = [r[1].slice_type for r in results]
    if kinds[0] != 2 or any(k != 1 for k in kinds[1:]):
        raise RuntimeError(f"rc cell: expected IDR + P frames, got {kinds}")
    bits = [r[1].bits for r in results]
    _bits, psnr_y = check_output(results[IPPP_WARM:], "rc cell")
    fps_src = enc.cfg.framerate_num / enc.cfg.framerate_denom
    effective = np.stack(ctu_qps)
    summary = dict(
        frames=len(results), timed=len(results) - IPPP_WARM,
        fps=(len(results) - IPPP_WARM) / dt,
        target_kbps=RC_BITRATE / 1e3,
        kbps_all=sum(bits) * fps_src / len(bits) / 1e3,
        kbps_timed=sum(bits[IPPP_WARM:]) * fps_src
        / (len(bits) - IPPP_WARM) / 1e3,
        idr_bits=bits[0], p_bits_per_frame=sum(bits[1:]) / (len(bits) - 1),
        psnr_y=psnr_y,
        slice_qp=[min(r[1].qp for r in results),
                  max(r[1].qp for r in results)],
        rc_frame_qp=[min(frame_qps), max(frame_qps)],
        ctu_qp=[int(effective.min()), int(effective.max())],
        ctu_qp_timed=[int(effective[IPPP_WARM:].min()),
                      int(effective[IPPP_WARM:].max())],
        kernel_launches=launches, qp_map_launches=qp_launches)
    log("rc-ippp-832x480-2mbps encode_stream:", json.dumps(summary))
    log("rc-ippp stage split (ms, one P frame):", json.dumps(
        rc_p_split(torch, enc, *clip46[-1], len(clip46) - 1)))
    enc.close()

    w, h = 256, 128
    small = synth_clip_natural(11, w, h, seed=0)
    roi = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "roi_phase13.txt")
    os.makedirs(os.path.dirname(roi), exist_ok=True)
    with open(roi, "w") as f:
        f.write("3 2\n-4 2 0\n3 -2 1\n")
    card_equals_cpu(f"roi-aq all-intra {w}x{h}", rc_config(
        w, h, bitrate=0, intra_period=1, roi=roi, aq=1.0), small[:3], dev)
    # At 128x64: at 416x240 the CPU's var-tree encode took half the
    # phase.
    card_equals_cpu("medium --bitrate 100000 128x64", config_from_preset(
        "medium", width=128, height=64, qp=QP, bitrate=100_000),
        synth_clip_natural(11, 128, 64, seed=0), dev)
    card_equals_cpu(f"ultrafast --bitrate 330000 {w}x{h}",
                    config_from_preset("ultrafast", width=w, height=h,
                                       qp=QP, bitrate=330_000),
                    small[:6], dev)
    return rows, qp_launches


TENBIT_BITRATE = 15_000_000           # phase 14's 4K cell: target bits/s
TENBIT_FPS = 25                       # ... at 25 frames a second


def to_10bit(clip, seed):
    """A clip's 8-bit planes as 10-bit content: (p << 2) plus seeded low
    bits, uint16 in 0..1023."""
    rng = np.random.default_rng(seed)
    return [tuple((p.astype(np.uint16) << 2)
                  + rng.integers(0, 4, p.shape, dtype=np.uint16)
                  for p in f) for f in clip]


def tenbit_config(width, height, cu=16):
    """The headline configuration at input_bitdepth=10."""
    cfg = headline_config(width, height, cu)
    cfg.input_bitdepth = 10
    return cfg


def gop_rc_10bit_config(width, height, **kw):
    """BASELINE config #5: Config() at 10-bit with a GOP-8 B pyramid and
    a target bitrate (fixed cu 32, frame-level rate control)."""
    from kvazaar_tpu_torch import Config
    return Config(width=width, height=height, qp=QP, **dict(dict(
        input_bitdepth=10, gop_len=GOP, intra_period=0,
        bitrate=TENBIT_BITRATE), **kw))


def compare_kernel_10bit(torch, frames10, clip10, big10, dev):
    """Phase 14 (i): the kernel's 10-bit instances == the plain version
    per plane kind on the card, timed against the 8-bit launch at the
    same shape (the 8-bit samples p >> 2, the same modes, inter map and
    QP map): intra at cu 16 (8 frames, the searched modes), inter at
    cu 32 (a real P frame, and a real B frame's L0 / L1 / bi-averaged
    MC planes), the per-block QP instance at cu 32 (a P frame with a
    random per-CTU map; a uniform map == the scalar launch), each at
    832x480, and on one 3840x2160 frame of the 4K clip (the searched
    modes, a random inter map and the next frame as MC planes; cu 32
    intra too, which codes the 4K cell's IDR).  The kernel reads int16
    planes at 10-bit and uint8 / int32 at 8-bit.  Returns the rows by
    name."""
    from kvazaar_tpu_torch.constants import CHROMA_QP_TAB
    from kvazaar_tpu_torch.encoder.frame_encoder import (IntraFrameEncoder,
                                                         chroma_qp)
    from kvazaar_tpu_torch.encoder.inter_search import bi_mc_planes
    from kvazaar_tpu_torch.encoder.intra_recon import wavefront_recon_plain
    from kvazaar_tpu_torch.encoder.intra_search import search_frame_modes
    from kvazaar_tpu_torch.ops.wavefront import (_smem_optin, launch_layout,
                                                 wavefront_recon_planes)

    rng = np.random.default_rng(14)
    rows = {}
    qp_c = chroma_qp(QP)

    def row_of(name, plan, planes, modes, inter=None, qp_ctu=None,
               ife=None):
        kw = {} if inter is None else dict(
            zip(("is_inter", "mc_y", "mc_cb", "mc_cr"), inter))
        qmap = cmap = None
        if qp_ctu is not None:
            qmap = ife._qp_blk_of(qp_ctu).contiguous()
            cmap = torch.from_numpy(CHROMA_QP_TAB.astype(np.int32)).to(
                dev)[qmap.long()]
        p16 = tuple(p.to(torch.int16) for p in planes)
        k16 = {k: v if k == "is_inter" else v.to(torch.int16)
               for k, v in kw.items()}
        p8 = tuple((p >> 2).to(torch.int32) for p in planes)
        k8 = {k: v if k == "is_inter" else (v >> 2).to(torch.int32)
              for k, v in kw.items()}

        def launch(bd=10, qp_map=qmap):
            pl, k = (p16, k16) if bd == 10 else (p8, k8)
            return wavefront_recon_planes(*pl, modes, plan, QP, qp_c, bd,
                                          qp_map=qp_map, **k)

        got = launch()
        want = []

        def plain():
            for orig, mc, s, luma, qp, m in (
                    (p16[0], k16.get("mc_y"), plan.cu_size, True, QP, qmap),
                    (p16[1], k16.get("mc_cb"), plan.cu_size // 2, False,
                     qp_c, cmap),
                    (p16[2], k16.get("mc_cr"), plan.cu_size // 2, False,
                     qp_c, cmap)):
                want.extend(wavefront_recon_plain(
                    orig, modes, plan, s, luma, qp, 10, k16.get("is_inter"),
                    mc, m))

        # One timed run of the plain version computes the reference
        # (seconds per run at 3840x2160).
        plain_ms = cuda_ms(torch, plain, 1)
        err = max_err(torch, got, want)
        row = dict(shape=name, cu=plan.cu_size, items=planes[0].shape[0],
                   variant="intra" if inter is None else "inter",
                   qp_map=qmap is not None, max_abs_err=err,
                   rec_max=int(got[0].max()),
                   ms=cuda_ms(torch, launch, 20), plain_ms=plain_ms,
                   n_steps=plan.n_steps)
        # The 8-bit launch stages int32 samples: at cu 32 and 3840 wide
        # it needs more shared memory than a block may opt in to.
        smem8 = launch_layout(plan, plan.cu_size, planes[0].shape[2], 8)[2]
        row["smem_bytes_8bit"] = smem8
        row["ms_8bit"] = row["ratio_to_8bit"] = None
        if smem8 <= _smem_optin(torch.cuda.current_device()):
            row["ms_8bit"] = cuda_ms(torch, lambda: launch(8), 20)
            row["ratio_to_8bit"] = row["ms"] / row["ms_8bit"]
        if qmap is not None:
            row["uniform_equals_scalar"] = max_err(
                torch, launch(qp_map=torch.full_like(qmap, QP)),
                launch(qp_map=None)) == 0
            row["scalar_ms"] = cuda_ms(torch, lambda: launch(qp_map=None),
                                       20)
        ring, threads, smem = launch_layout(plan, plan.cu_size,
                                            planes[0].shape[2], 10)
        row.update(ring=ring, threads=threads, smem_bytes=smem)
        row["bound_ms"], row["bound_by"] = bound_ms(
            (*p16, modes, *k16.values(),
             *(m for m in (qmap, cmap) if m is not None), *got),
            [(planes[0].numel(), plan.cu_size),
             (2 * planes[1].numel(), plan.cu_size // 2)])
        log("10-bit kernel vs plain:", json.dumps(row))
        if err != 0 or not row.get("uniform_equals_scalar", True) or \
                row["rec_max"] <= 255:
            raise RuntimeError(f"10-bit kernel != plain at {row}")
        rows[name] = row

    # Intra, cu 16: the intra cell's batch.
    ife = IntraFrameEncoder(tenbit_config(W, H), device=dev)
    planes = ife._upload(ife.host_pack_sources(frames10))
    modes = torch.stack([search_frame_modes(y, ife.plan, ife.lambda_satd,
                                            10)[0] for y in planes[0]])
    row_of("intra cu16 832x480 8 frames", ife.plan, planes, modes)

    # Inter, cu 32: a P frame and a B frame of the fixed grid.
    ife = IntraFrameEncoder(gop_rc_10bit_config(W, H, bitrate=0),
                            device=dev)
    ife.submit_frames([clip10[0]])
    r0 = ife._dpb
    r1 = ife.submit_p(*clip10[2], [(0, r0)])[5]
    ys, cbs, crs = ife._upload(ife.host_pack_sources([clip10[1]]))
    modes, inter_map, _ref, _mv, mcs = ife._p_predict(ys[0], [r0])
    one = (inter_map[None], *(m[None] for m in mcs))
    row_of("inter cu32 832x480 P frame", ife.plan, (ys, cbs, crs),
           modes[None], one)
    bmodes, b_inter, dirs, mv0, mv1 = ife._b_predict(ys[0], r0[0], r1[0])
    bmc = bi_mc_planes(r0, r1, mv0, mv1, dirs, ife.plan, 10)
    row_of("inter cu32 832x480 B frame", ife.plan, (ys, cbs, crs),
           bmodes[None], (b_inter[None], *(m[None] for m in bmc)))
    rows["inter cu32 832x480 B frame"]["dir_share"] = {
        d: (b_inter & (dirs == k)).float().mean().item()
        for k, d in enumerate(("l0", "l1", "bi"))}

    # The per-block QP instance, cu 32, on the P frame.
    cy, cx = -(-ife.coded_h // 64), -(-ife.coded_w // 64)
    qp_ctu = torch.from_numpy(rng.integers(
        QP - 6, QP + 7, (1, cy, cx), dtype=np.int32)).to(dev)
    row_of("qp-map cu32 832x480 P frame", ife.plan, (ys, cbs, crs),
           modes[None], one, qp_ctu, ife)

    # One 3840x2160 frame of the 4K clip at each instance.
    big_w, big_h = BIG[1]
    for cu in (16, 32):
        ife = IntraFrameEncoder(tenbit_config(big_w, big_h, cu), device=dev)
        plan = ife.plan
        planes = ife._upload(ife.host_pack_sources(big10[:1]))
        modes = search_frame_modes(planes[0][0], plan, ife.lambda_satd,
                                   10)[0][None]
        row_of(f"intra cu{cu} {big_w}x{big_h} 1 frame", plan, planes,
               modes)
        if cu == 16:
            continue
        mcs = ife._upload(ife.host_pack_sources(big10[1:2]))
        inter = (torch.from_numpy(rng.integers(
            0, 2, tuple(modes.shape), dtype=np.int32)).to(dev) != 0, *mcs)
        row_of(f"inter cu32 {big_w}x{big_h} 1 frame", plan, planes, modes,
               inter)
        cy, cx = -(-ife.coded_h // 64), -(-ife.coded_w // 64)
        qp_ctu = torch.from_numpy(rng.integers(
            QP - 6, QP + 7, (1, cy, cx), dtype=np.int32)).to(dev)
        row_of(f"qp-map cu32 {big_w}x{big_h} 1 frame", plan, planes, modes,
               inter, qp_ctu, ife)
    return rows


def run_tenbit_intra_cell(torch, wavefront, frames10, dev):
    """Phase 14 (ii): the cell intra-10bit-832x480-qp22, the headline
    configuration at input_bitdepth=10, timed as phase 6 (one warm-up
    batch, then TIMED_BATCHES batches of the 8-frame clip), with the
    10-bit launches counted around the timed run.  Returns its summary."""
    from kvazaar_tpu_torch.api import Encoder
    enc = Encoder(tenbit_config(W, H), device=dev)
    list(enc.encode_stream(frames10[:BATCH]))            # warm-up
    torch.cuda.synchronize()
    clip = frames10 * TIMED_BATCHES
    for counts in (wavefront.LAUNCHES, wavefront.LAUNCHES_10BIT):
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    results = list(enc.encode_stream(clip))
    dt = time.perf_counter() - t0
    launches = dict(wavefront.LAUNCHES_10BIT)
    if launches["intra"] == 0 or launches["intra"] != \
            wavefront.LAUNCHES["intra"]:
        raise RuntimeError(f"intra-10bit cell: expected 10-bit launches "
                           f"only, got {launches} / {wavefront.LAUNCHES}")
    if len(results) != len(clip):
        raise RuntimeError(f"intra-10bit cell: {len(results)} results for "
                           f"{len(clip)} frames")
    bits, psnr_y = check_output(results, "intra-10bit cell")
    summary = dict(frames=len(clip), batch=BATCH, fps=len(clip) / dt,
                   bits_per_frame=bits, psnr_y_peak_1023=psnr_y,
                   kernel_launches_10bit=launches, stage_wall_s=enc.stats)
    log("intra-10bit-832x480-qp22 encode_stream:", json.dumps(summary))
    enc.close()
    return summary


def run_tenbit_4k_cell(torch, wavefront, big10, dev):
    """Phase 14 (iii): the cell gop8-rc-10bit-3840x2160-15mbps, BASELINE
    config #5 (10-bit, GOP 8, --bitrate 15000000 at 25 fps, fixed cu
    32, a frame encoder per QP): the IDR and one GOP warm, then one GOP
    timed, through Encoder.encode_stream, with the 10-bit launches
    counted around the whole run and the peak device memory.  Returns
    its summary."""
    cfg = gop_rc_10bit_config(*BIG[1])
    for counts in (wavefront.LAUNCHES, wavefront.LAUNCHES_10BIT):
        for k in counts:
            counts[k] = 0
    torch.cuda.reset_peak_memory_stats()
    enc, results, dt = timed_gop(torch, cfg, big10, GOP, dev)
    launches = dict(wavefront.LAUNCHES_10BIT)
    if launches["inter"] == 0 or launches["intra"] == 0 or \
            launches["inter"] != wavefront.LAUNCHES["inter"]:
        raise RuntimeError(f"4K cell: expected 10-bit launches of both "
                           f"variants, got {launches} / "
                           f"{wavefront.LAUNCHES}")
    summary = gop_summary(results, GOP + 1, dt, "4K cell")
    bits = [r[1].bits for r in results]
    qps = [r[1].qp for r in results]
    summary.update(
        target_kbps=TENBIT_BITRATE / 1e3,
        kbps_timed=sum(bits[GOP + 1:]) * TENBIT_FPS
        / (len(bits) - GOP - 1) / 1e3,
        kbps_all=sum(bits) * TENBIT_FPS / len(bits) / 1e3,
        qps=qps, qp_range=[min(qps), max(qps)],
        frame_encoders=len(enc._encoders) if hasattr(enc, "_encoders")
        else None,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        kernel_launches_10bit=launches)
    log("gop8-rc-10bit-3840x2160-15mbps encode_stream:", json.dumps(summary))
    enc.close()
    return summary


def run_tenbit(torch, wavefront, dev):
    """Phase 14: 10-bit (Main 10).  The kernel's 10-bit instances == plain
    (``compare_kernel_10bit``); the cells intra-10bit-832x480-qp22 and
    gop8-rc-10bit-3840x2160-15mbps; card == CPU bytes and recon for four
    10-bit streams: superfast --period 1, ultrafast at its default,
    medium at its default (GOP 8, variable B trees; 256x128) and
    Config() with --bitrate (IPPP, a per-CTU QP map, launched with the
    10-bit per-block QP instance, counted around its card run).  The
    10-bit clips are the seeded clips shifted up two bits with seeded low
    bits.  Returns (kernel rows, launches per 10-bit record)."""
    from kvazaar_tpu_torch.config import config_from_preset

    t0 = time.perf_counter()
    frames10 = to_10bit(synth_clip_natural(FRAMES, W, H, seed=0), 140)
    clip10 = to_10bit(synth_clip_natural(3, W, H, seed=4), 141)
    big10 = to_10bit(synth_clip_natural(2 * GOP + 1, *BIG[1], seed=0), 142)
    log(f"10-bit clips: {time.perf_counter() - t0:.3f} s")
    rows = compare_kernel_10bit(torch, frames10, clip10, big10, dev)
    intra = run_tenbit_intra_cell(torch, wavefront, frames10, dev)
    big = run_tenbit_4k_cell(torch, wavefront, big10, dev)

    w, h = 256, 128
    small = to_10bit(synth_clip_natural(GOP + 1, w, h, seed=0), 143)
    card_equals_cpu(f"10-bit superfast --period 1 {w}x{h}", config_from_preset(
        "superfast", width=w, height=h, qp=QP, intra_period=1,
        input_bitdepth=10), small[:2], dev)
    card_equals_cpu(f"10-bit ultrafast {w}x{h}", config_from_preset(
        "ultrafast", width=w, height=h, qp=QP, input_bitdepth=10),
        small[:4], dev)
    card_equals_cpu("10-bit medium 128x64", config_from_preset(
        "medium", width=128, height=64, qp=QP, input_bitdepth=10),
        to_10bit(synth_clip_natural(GOP + 1, 128, 64, seed=0), 143), dev)
    for k in wavefront.LAUNCHES_10BIT:
        wavefront.LAUNCHES_10BIT[k] = 0
    card_equals_cpu(f"10-bit Config() --bitrate 330000 {w}x{h}",
                    rc_config(w, h, bitrate=330_000, input_bitdepth=10),
                    small[:4], dev)
    qp_map_launches = wavefront.LAUNCHES_10BIT["qp_map"]
    if qp_map_launches == 0:
        raise RuntimeError("10-bit --bitrate stream: no 10-bit QP-map "
                           "launch")
    launches = dict(intra=intra["kernel_launches_10bit"]["intra"],
                    intra_cu32=big["kernel_launches_10bit"]["intra"],
                    inter_cu32=big["kernel_launches_10bit"]["inter"],
                    qp_map=qp_map_launches)
    return rows, launches


LOSSLESS_TIMED = 2                    # phase 15's cell: one timed batch
LOSSLESS_WARM = 1                     # ... after a warm-up batch of 1


def lossless_config(width, height, cu=16, **kw):
    """The headline configuration with lossless=True (the encoder turns
    deblocking off)."""
    cfg = headline_config(width, height, cu)
    cfg.lossless = True
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def modes_10_26(torch, rng, shape, dev):
    """Seeded intra modes, about 60 % of them 10 or 26 (the RDPCM
    modes)."""
    m = np.where(rng.random(shape) < 0.6, rng.choice([10, 26], shape),
                 rng.integers(0, 35, shape)).astype(np.int32)
    return torch.from_numpy(m).to(dev)


def compare_kernel_bypass(torch, frames, frames10, big10, dev):
    """Phase 15 (i): the kernel's transquant-bypass instances == the plain
    version per plane kind on the card (max abs error 0, the recon equal
    to the source), at 832x480: intra at cu 16 (the cell's 8 frames), cu
    8 and cu 32 (2 frames), each with the searched modes and with random
    modes rich in 10 and 26; inter at cu 16 and 32 on a real P frame of
    a lossless stream (the DPB is the source) and on a random inter map
    with random MC planes; RDPCM off and on; at 10-bit intra cu 16 and
    inter cu 32; and one 3840x2160 10-bit frame at cu 32 (intra and a
    random inter map, compare-only).  The timed rows also time the
    non-bypass launch at the same shape (``ms_transform``).  Returns the
    rows by name."""
    from kvazaar_tpu_torch.encoder.frame_encoder import (IntraFrameEncoder,
                                                         chroma_qp)
    from kvazaar_tpu_torch.encoder.intra_recon import wavefront_recon_plain
    from kvazaar_tpu_torch.encoder.intra_search import search_frame_modes
    from kvazaar_tpu_torch.ops.wavefront import (launch_layout,
                                                 wavefront_recon_planes)

    rng = np.random.default_rng(15)
    rows = {}
    qp_c = chroma_qp(QP)

    def row_of(name, plan, planes, modes, bd=8, rdpcm=False, inter=None,
               timed=True):
        kw = {} if inter is None else dict(
            zip(("is_inter", "mc_y", "mc_cb", "mc_cr"), inter))

        def launch(lossless=True):
            return wavefront_recon_planes(*planes, modes, plan, QP, qp_c,
                                          bd, lossless=lossless,
                                          rdpcm=rdpcm and lossless, **kw)

        got = launch()
        want = []

        def plain():
            for orig, mc, s, luma, qp in (
                    (planes[0], kw.get("mc_y"), plan.cu_size, True, QP),
                    (planes[1], kw.get("mc_cb"), plan.cu_size // 2, False,
                     qp_c),
                    (planes[2], kw.get("mc_cr"), plan.cu_size // 2, False,
                     qp_c)):
                want.extend(wavefront_recon_plain(
                    orig, modes, plan, s, luma, qp, bd, kw.get("is_inter"),
                    mc, None, True, rdpcm))

        plain_ms = cuda_ms(torch, plain, 1)
        err = max_err(torch, got, want)
        src_err = max_err(torch, got[0::2], planes)
        row = dict(shape=name, cu=plan.cu_size, bitdepth=bd, rdpcm=rdpcm,
                   items=planes[0].shape[0],
                   variant="intra" if inter is None else "inter",
                   max_abs_err=err, max_abs_rec_minus_source=src_err,
                   plain_ms=plain_ms, n_steps=plan.n_steps)
        if inter is not None:
            row["inter_share"] = inter[0].float().mean().item()
        else:
            row["rdpcm_mode_share"] = ((modes == 10) | (modes == 26)
                                       ).float().mean().item()
        if timed:
            row["ms"] = cuda_ms(torch, launch, 20)
            row["ms_transform"] = cuda_ms(torch, lambda: launch(False), 20)
            row["ratio_to_transform"] = row["ms"] / row["ms_transform"]
            ring, threads, smem = launch_layout(plan, plan.cu_size,
                                                planes[0].shape[2], bd)
            row.update(ms_per_step=row["ms"] / plan.n_steps, ring=ring,
                       threads=threads, smem_bytes=smem)
            # The bypass does no transform: about 20 operations a
            # sample (prediction, residual, DPCM).
            row["bound_ms"], row["bound_by"] = bound_ms(
                (*planes, modes, *kw.values(), *got),
                [(planes[0].numel() + 2 * planes[1].numel(), 0)])
        log("bypass kernel vs plain:", json.dumps(row))
        if err != 0 or src_err != 0:
            raise RuntimeError(f"bypass kernel != plain or source at {row}")
        rows[name] = row

    def searched(ife, planes, bd=8):
        return torch.stack([search_frame_modes(y, ife.plan, ife.lambda_satd,
                                               bd)[0] for y in planes[0]])

    # Intra at cu 16 (the cell's batch), cu 8 and cu 32.
    for cu, n in ((16, BATCH), (8, 2), (32, 2)):
        ife = IntraFrameEncoder(lossless_config(W, H, cu), device=dev)
        planes = ife._upload(ife.host_pack_sources(frames[:n]))
        modes = searched(ife, planes)
        for rdpcm in (False, True):
            row_of(f"intra cu{cu} 832x480 {n} frames rdpcm={rdpcm}",
                   ife.plan, planes, modes, rdpcm=rdpcm)
        row_of(f"intra cu{cu} 832x480 {n} frames, random modes 10/26",
               ife.plan, planes, modes_10_26(torch, rng, tuple(modes.shape),
                                             dev), rdpcm=True, timed=False)

    # Inter at cu 16 and 32: a real P frame of a lossless IPPP stream
    # (searched against frame 0, whose recon is its source), and random
    # inputs.
    for cu in (16, 32):
        ife = IntraFrameEncoder(lossless_config(W, H, cu, intra_period=0),
                                device=dev)
        ife.submit_frames([frames[0]])
        ys, cbs, crs = ife._upload(ife.host_pack_sources([frames[1]]))
        modes, inter_map, _ref, _mv, mcs = ife._p_predict(ys[0], [ife._dpb])
        real = (inter_map[None], *(m[None] for m in mcs))
        for rdpcm in (False, True):
            row_of(f"inter cu{cu} 832x480 P frame rdpcm={rdpcm}", ife.plan,
                   (ys, cbs, crs), modes[None], rdpcm=rdpcm, inter=real)
        rand_inter = (torch.from_numpy(rng.random(
            (1, *inter_map.shape)) < 0.5).to(dev),
            *(torch.from_numpy(rng.integers(0, 256, tuple(p.shape),
                                            dtype=np.int32)).to(dev)
              for p in (ys, cbs, crs)))
        row_of(f"inter cu{cu} 832x480 random", ife.plan, (ys, cbs, crs),
               modes_10_26(torch, rng, (1, *inter_map.shape), dev),
               rdpcm=True, inter=rand_inter, timed=False)

    # 10-bit: intra cu 16 over the 8-frame batch, inter cu 32 on a real
    # P frame, RDPCM on.
    ife = IntraFrameEncoder(lossless_config(W, H, 16, input_bitdepth=10),
                            device=dev)
    p10 = ife._upload(ife.host_pack_sources(frames10))
    p16 = tuple(p.to(torch.int16) for p in p10)
    row_of("10-bit intra cu16 832x480 8 frames", ife.plan, p16,
           searched(ife, p10, 10), bd=10, rdpcm=True)
    ife = IntraFrameEncoder(lossless_config(W, H, 32, input_bitdepth=10,
                                            intra_period=0), device=dev)
    ife.submit_frames([frames10[0]])
    ys, cbs, crs = ife._upload(ife.host_pack_sources([frames10[1]]))
    modes, inter_map, _ref, _mv, mcs = ife._p_predict(ys[0], [ife._dpb])
    row_of("10-bit inter cu32 832x480 P frame", ife.plan,
           tuple(p.to(torch.int16) for p in (ys, cbs, crs)), modes[None],
           bd=10, rdpcm=True, inter=(inter_map[None],
                                     *(m[None].to(torch.int16)
                                       for m in mcs)))

    # One 3840x2160 10-bit frame at cu 32: intra and a random inter map.
    big_w, big_h = BIG[1]
    ife = IntraFrameEncoder(lossless_config(big_w, big_h, 32,
                                            input_bitdepth=10), device=dev)
    planes = tuple(p.to(torch.int16) for p in
                   ife._upload(ife.host_pack_sources(big10[:1])))
    modes = modes_10_26(torch, rng, (1, ife.plan.blocks_y,
                                     ife.plan.blocks_x), dev)
    row_of(f"10-bit intra cu32 {big_w}x{big_h} 1 frame", ife.plan, planes,
           modes, bd=10, rdpcm=True)
    mcs = tuple(p.to(torch.int16) for p in
                ife._upload(ife.host_pack_sources(big10[1:2])))
    row_of(f"10-bit inter cu32 {big_w}x{big_h} 1 frame", ife.plan, planes,
           modes, bd=10, rdpcm=True,
           inter=(torch.from_numpy(rng.random(tuple(modes.shape)) < 0.5
                                   ).to(dev), *mcs))
    return rows


def run_lossless_cell(torch, wavefront, frames, dev):
    """Phase 15 (ii): the cell lossless-832x480, the headline
    configuration with lossless=True: one warm-up batch of LOSSLESS_WARM
    frames (the Python CABAC takes about 5 s a frame and has nothing to
    warm), then one timed batch of LOSSLESS_TIMED frames of the clip
    through Encoder.encode_stream (with the recon, to check it against the
    source), with the bypass launches counted around the timed run; and
    a stage split: the device's search and bypass reconstruction of one
    batch (CUDA events), its download, and the Python CABAC of one frame
    (wall clock), per frame.  Returns its summary."""
    from kvazaar_tpu_torch.api import Encoder
    from kvazaar_tpu_torch.encoder.intra_recon import reconstruct_frames
    from kvazaar_tpu_torch.encoder.intra_search import search_frame_modes
    enc = Encoder(lossless_config(W, H), device=dev)
    if enc.cfg.deblock or not enc._intra.params.transquant_bypass:
        raise RuntimeError("lossless cell: deblocking on or no bypass")
    list(enc.encode_stream(frames[:LOSSLESS_WARM]))      # warm-up
    torch.cuda.synchronize()
    clip = frames[:LOSSLESS_TIMED]
    for counts in (wavefront.LAUNCHES, wavefront.BYPASS_LAUNCHES):
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    results = list(enc.encode_stream(clip, need_recon=True))
    dt = time.perf_counter() - t0
    launches = dict(wavefront.BYPASS_LAUNCHES)
    if launches["intra"] != 1 or launches["intra"] != \
            wavefront.LAUNCHES["intra"]:
        raise RuntimeError(f"lossless cell: expected one bypass launch a "
                           f"batch, got {launches} / {wavefront.LAUNCHES}")
    if len(results) != len(clip):
        raise RuntimeError(f"lossless cell: {len(results)} results for "
                           f"{len(clip)} frames")
    exact = all(np.array_equal(r, s) for (_c, _i, rec), f in
                zip(results, clip) for r, s in zip(rec, f))
    psnr = {r[1].psnr_y for r in results}
    if not exact or psnr != {999.99}:
        raise RuntimeError(f"lossless cell: recon != source ({exact}) or "
                           f"PSNR-Y {psnr}")
    bits = [r[1].bits for r in results]
    summary = dict(frames=len(clip), batch=len(clip), fps=len(clip) / dt,
                   bits_per_frame=sum(bits) / len(bits),
                   recon_equals_source=exact, psnr_y=psnr.pop(),
                   kernel_launches_bypass=launches,
                   stage_wall_s=enc.stats)
    log("lossless-832x480 encode_stream:", json.dumps(summary))

    ife = enc._intra
    ys, cbs, crs = ife._upload(ife.host_pack_sources(frames[:BATCH]))
    box = {}

    def search():
        box["modes"] = torch.stack([search_frame_modes(
            y, ife.plan, ife.lambda_satd, 8, True)[0] for y in ys])

    def recon():
        reconstruct_frames(ys, cbs, crs, box["modes"], ife.plan, QP,
                           ife.qp_c, lossless=True)

    split = {}
    for name, fn in (("search", search), ("recon_bypass", recon)):
        fn()
        split[name + "_ms"] = cuda_ms(torch, fn, 3) / BATCH
    handle = ife.submit_frames(frames[:BATCH])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n, modes, lv, rec, _sses, sao, _cmodes, _ts = ife.download_frames(
        handle)
    split["d2h_ms"] = 1000 * (time.perf_counter() - t0) / BATCH
    t0 = time.perf_counter()
    ife._host_finalize(modes[0], lv[0][0], lv[1][0], lv[2][0], None,
                       None, None)
    split["cabac_python_ms"] = 1000 * (time.perf_counter() - t0)
    split["cabac_share"] = split["cabac_python_ms"] / sum(split.values())
    log("lossless-832x480 stage split (ms/frame):", json.dumps(split))
    summary["split"] = split
    enc.close()
    return summary


def sse_card_equals_cpu(torch, dev):
    """Phase 15 (iii): the pipelined FrameInfo (PSNR from the device
    SSEs, summed in the JAX package's float32 order) of 128x128 noise at
    QP 51, whose SSEs pass 2^24: card == CPU for all-intra (8 frames) and
    IPPP (IDR + 3 P), bytes and every field."""
    import dataclasses
    from kvazaar_tpu_torch.api import Encoder
    rng = np.random.default_rng(150)
    w = h = 128
    clip = [tuple(rng.integers(0, 256, s).astype(np.uint8)
                  for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
            for _ in range(BATCH)]
    for period, n in ((1, BATCH), (0, 4)):
        cfg = headline_config(w, h)
        cfg.qp, cfg.intra_period = 51, period
        out = []
        for d in (dev, "cpu"):
            enc = Encoder(cfg, device=d)
            out.append(list(enc.encode_stream(clip[:n])))
            enc.close()
        card, host = out
        if [c for c, _, _ in card] != [c for c, _, _ in host] or [
                dataclasses.astuple(i) for _, i, _ in card] != [
                dataclasses.astuple(i) for _, i, _ in host]:
            raise RuntimeError(f"pipelined FrameInfo card != CPU (period "
                               f"{period})")
        log(f"128x128 QP 51 period {period}: card == CPU bytes and "
            f"FrameInfo over {n} frames (PSNR-Y "
            f"{[i.psnr_y for _, i, _ in card]})")


def run_lossless(torch, wavefront, dev):
    """Phase 15: lossless (transquant bypass) and implicit RDPCM.  The
    bypass instances == plain (``compare_kernel_bypass``); the cell
    lossless-832x480; the pipelined FrameInfo above 2^24, card == CPU;
    card == CPU bytes and recon at 256x128 for lossless streams with the
    bypass launches counted around the card runs.  Returns (kernel rows,
    launches per bypass record)."""
    from kvazaar_tpu_torch import Config
    from kvazaar_tpu_torch.config import config_from_preset

    frames = synth_clip_natural(FRAMES, W, H, seed=0)
    frames10 = to_10bit(frames, 150)
    big10 = to_10bit(synth_clip_natural(2, *BIG[1], seed=0), 151)
    rows = compare_kernel_bypass(torch, frames, frames10, big10, dev)
    cell = run_lossless_cell(torch, wavefront, frames, dev)
    sse_card_equals_cpu(torch, dev)

    # At 256x128: at 416x240 both sides' Python CABAC took most of these
    # checks' time.
    w, h = 256, 128
    small = synth_clip_natural(5, w, h, seed=0)
    small10 = to_10bit(small[:1], 152)
    counted = {}

    def streams(key, *cases):
        for k in wavefront.BYPASS_LAUNCHES:
            wavefront.BYPASS_LAUNCHES[k] = 0
        for name, cfg, clip in cases:
            card_equals_cpu(name, cfg, clip, dev)
        counted[key] = dict(wavefront.BYPASS_LAUNCHES)

    streams("intra",
            (f"lossless RDPCM --period 1 cu 16 {w}x{h}",
             lossless_config(w, h, implicit_rdpcm=True), small[:1]))
    streams("cu32",
            (f"lossless Config() --period 1 {w}x{h}",
             Config(width=w, height=h, qp=QP, lossless=True,
                    intra_period=1), small[:2]))
    streams("inter",
            (f"lossless RDPCM IPPP cu 16 {w}x{h}",
             lossless_config(w, h, implicit_rdpcm=True, intra_period=0),
             small[:3]),
            ("lossless fixed GOP 4 128x64",
             lossless_config(128, 64, gop_len=4, intra_period=0),
             synth_clip_natural(5, 128, 64, seed=0)))
    streams("10bit",
            (f"10-bit lossless RDPCM --period 1 {w}x{h}",
             lossless_config(w, h, implicit_rdpcm=True, input_bitdepth=10),
             small10))
    card_equals_cpu(f"lossless medium --gop 0 {w}x{h}", config_from_preset(
        "medium", width=w, height=h, qp=QP, lossless=True, rdoq=False,
        sao=False, intra_period=0, gop_len=1, ref_frames=1), small[:2], dev)
    if not (counted["intra"]["rdpcm"] and counted["cu32"]["intra"]
            and counted["inter"]["inter"] and counted["10bit"]["10bit"]):
        raise RuntimeError(f"lossless streams: missing bypass launches "
                           f"{counted}")
    launches = dict(cu16=cell["kernel_launches_bypass"]["intra"],
                    cu32=counted["cu32"]["intra"],
                    inter=counted["inter"]["inter"],
                    tenbit=counted["10bit"]["intra"])
    return rows, launches


TILES = (3, 3)                        # phase 16: the tile grid of BASELINE #4
TILE_SHAPES = ((1920, 1088), (3840, 2176))   # ... its kernel rows' frames
TILE_W, TILE_H = 1920, 1080           # ... and its cells' frames
TILE_INTRA_WARM, TILE_INTRA_TIMED = 1, 2     # ... all-intra batches
TILE_P_TIMED = 2                      # ... P frames after IDR + 1 P


def tiles_config(width, height, cu=16, **kw):
    """The headline configuration (cu 16, rd 1, deblocking, WPP) on a
    3x3 tile grid."""
    cfg = headline_config(width, height, cu)
    cfg.tiles_x, cfg.tiles_y = TILES
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def compare_kernel_tiles(torch, dev):
    """Phase 16 (i): the kernel on tiled plans (a thread block per tile)
    == the plain version per plane kind on the card, max abs error 0, at
    1920x1088 3x3, cu 16 and cu 32, 8- and 10-bit, intra (the searched
    modes of the seeded natural clip, 4 frames at 8-bit cu 16, the
    all-intra cell's batch, else 1) and inter (a random inter map, the
    next frame as the MC planes), and at 3840x2176 3x3 cu 32 10-bit.
    Each row is timed against the launch on the same inputs and the
    untiled plan of the frame (``untiled_ms``), with the tile's steps,
    ring, threads, shared memory and the bound.  Returns the rows by
    name."""
    from kvazaar_tpu_torch.encoder.frame_encoder import IntraFrameEncoder
    from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
    from kvazaar_tpu_torch.encoder.intra_recon import wavefront_recon_plain
    from kvazaar_tpu_torch.encoder.intra_search import search_frame_modes
    from kvazaar_tpu_torch.ops.wavefront import (launch_layout, tile_shape,
                                                 wavefront_recon_planes)

    rng = np.random.default_rng(16)
    rows = {}

    def row_of(name, ife, planes, modes, bd, inter=None):
        plan = ife.plan
        flat = make_intra_plan(plan.width, plan.height, plan.cu_size,
                               True)
        kw = {} if inter is None else dict(
            zip(("is_inter", "mc_y", "mc_cb", "mc_cr"), inter))

        def launch(p=plan):
            return wavefront_recon_planes(*planes, modes, p, QP, ife.qp_c,
                                          bd, **kw)

        got = launch()
        want = []

        def plain():
            for orig, mc, s, luma, qp in (
                    (planes[0], kw.get("mc_y"), plan.cu_size, True, QP),
                    (planes[1], kw.get("mc_cb"), plan.cu_size // 2, False,
                     ife.qp_c),
                    (planes[2], kw.get("mc_cr"), plan.cu_size // 2, False,
                     ife.qp_c)):
                want.extend(wavefront_recon_plain(
                    orig, modes, plan, s, luma, qp, bd, kw.get("is_inter"),
                    mc))

        plain_ms = cuda_ms(torch, plain, 1)
        err = max_err(torch, got, want)
        if err != 0:
            raise RuntimeError(f"tiled kernel != plain at {name}")
        ms = cuda_ms(torch, launch, 20)
        untiled = cuda_ms(torch, lambda: launch(flat), 20)
        ring, threads, smem = launch_layout(plan, plan.cu_size,
                                            planes[0].shape[2], bd)
        n_steps, n_slots, _, tile_bw, _ = tile_shape(plan)
        row = dict(shape=name, cu=plan.cu_size, bitdepth=bd,
                   tiles=list(plan.tiles), items=planes[0].shape[0],
                   variant="intra" if inter is None else "inter",
                   max_abs_err=err, ms=ms, untiled_ms=untiled,
                   ratio_to_untiled=ms / untiled, plain_ms=plain_ms,
                   tile_steps=n_steps, untiled_steps=flat.n_steps,
                   tile_slots=n_slots, tile_width_blocks=tile_bw,
                   ring=ring, untiled_ring=launch_layout(
                       flat, plan.cu_size, planes[0].shape[2], bd)[0],
                   threads=threads, smem_bytes=smem,
                   thread_blocks=3 * planes[0].shape[0] * plan.tiles[0]
                   * plan.tiles[1])
        row["bound_ms"], row["bound_by"] = bound_ms(
            (*planes, modes, *kw.values(), *got),
            [(planes[0].numel(), plan.cu_size),
             (2 * planes[1].numel(), plan.cu_size // 2)])
        log("tiled kernel vs plain:", json.dumps(row))
        rows[name] = row

    clips = {}
    for (w, h), cu, bd in ((TILE_SHAPES[0], 16, 8), (TILE_SHAPES[0], 16, 10),
                           (TILE_SHAPES[0], 32, 8), (TILE_SHAPES[0], 32, 10),
                           (TILE_SHAPES[1], 32, 10)):
        if (w, h) not in clips:
            n = TILE_INTRA_TIMED if w == TILE_SHAPES[0][0] else 1
            clips[w, h] = synth_clip_natural(n + 1, w, h, seed=16)
        clip = clips[w, h] if bd == 8 else to_10bit(clips[w, h], 160)
        n = len(clip) - 1 if (cu, bd) == (16, 8) else 1
        ife = IntraFrameEncoder(tiles_config(w, h, cu, input_bitdepth=bd),
                                device=dev)
        up = ife._upload(ife.host_pack_sources(clip))
        modes = torch.stack([search_frame_modes(y, ife.plan, ife.lambda_satd,
                                                bd, True)[0]
                             for y in up[0][:n]])
        if bd == 10:
            up = tuple(p.to(torch.int16) for p in up)
        planes = tuple(p[:n] for p in up)
        row_of(f"intra cu{cu} {w}x{h} 3x3 {bd}-bit {n} frames", ife,
               planes, modes, bd)
        inter_map = torch.from_numpy(rng.random(
            (1, ife.plan.blocks_y, ife.plan.blocks_x)) < 0.5).to(dev)
        row_of(f"inter cu{cu} {w}x{h} 3x3 {bd}-bit", ife,
               tuple(p[:1] for p in up), modes[:1], bd,
               (inter_map, *(p[-1:] for p in up)))
    return rows


def tiles_streams_card_equals_cpu(wavefront, dev):
    """Phase 16 (ii): card == CPU bytes and recon at 416x240 for tiles
    3x3 + WPP IPPP (Config(), cu 32), --slices tiles all-intra (tiles
    2x2, WPP off) and the superfast preset at --period 1 with tiles 2x2
    (SAO's host decision; inter CUs fixed at 16, as tiles need), and at
    256x128 for --slices wpp on the medium preset at --gop 0 (a
    variable-tree I frame and a variable P frame) and a fixed-grid GOP 4
    with tiles 2x2; the tiled launches counted around the card runs."""
    from kvazaar_tpu_torch import Config
    from kvazaar_tpu_torch.config import config_from_preset
    w, h = 416, 240
    small = synth_clip_natural(5, w, h, seed=0)
    for k in wavefront.TILE_LAUNCHES:
        wavefront.TILE_LAUNCHES[k] = 0
    card_equals_cpu(f"tiles 3x3 + WPP IPPP Config() {w}x{h}",
                    Config(width=w, height=h, qp=QP, intra_period=0,
                           tiles_x=3, tiles_y=3), small[:3], dev)
    card_equals_cpu(f"--slices tiles all-intra tiles 2x2 {w}x{h}",
                    tiles_config(w, h, tiles_x=2, tiles_y=2, wpp=False,
                                 slices="tiles"), small[:2], dev)
    # The variable-tree and GOP streams at 256x128 (at 416x240 their CPU
    # encodes took 9-13 s).
    sw, sh = 256, 128
    small2 = synth_clip_natural(5, sw, sh, seed=0)
    card_equals_cpu(f"--slices wpp medium --gop 0 {sw}x{sh}",
                    config_from_preset("medium", width=sw, height=sh, qp=QP,
                                       intra_period=0, gop_len=1,
                                       ref_frames=1, slices="wpp"),
                    small2[:2], dev)
    card_equals_cpu(f"superfast --period 1 tiles 2x2 {w}x{h}",
                    config_from_preset("superfast", width=w, height=h,
                                       qp=QP, intra_period=1, tiles_x=2,
                                       tiles_y=2, inter_min_cu=16),
                    small[:2], dev)
    card_equals_cpu(f"fixed GOP 4 tiles 2x2 {sw}x{sh}",
                    tiles_config(sw, sh, tiles_x=2, tiles_y=2, gop_len=4,
                                 intra_period=0), small2, dev)
    if min(wavefront.TILE_LAUNCHES.values()) == 0:
        raise RuntimeError(f"tiled streams: no tiled launch of a variant "
                           f"({wavefront.TILE_LAUNCHES})")


def run_tiles(torch, wavefront, dev):
    """Phase 16: tiles and slices.  The kernel on tiled plans == plain
    (``compare_kernel_tiles``); the cell
    ``tiles3x3-ippp-1920x1080-qp22`` (BASELINE config #4 on the package
    defaults: Config() with tiles 3x3, fixed cu 32, rd 1, one reference,
    WPP; IDR + 1 P warm, then TILE_P_TIMED P frames of a seeded 1080p
    motion clip) and ``tiles3x3-intra-1920x1080-qp22`` (the headline
    all-intra configuration on a 3x3 grid, pipelined: a warm-up batch of
    TILE_INTRA_WARM frames, then one timed batch of TILE_INTRA_TIMED),
    each with its tiled launches and a stage split with the Python
    CABAC's share; and card == CPU for the tile and slice streams.
    Returns (kernel rows, tiled launches per record)."""
    from kvazaar_tpu_torch import Config
    from kvazaar_tpu_torch.api import Encoder
    from kvazaar_tpu_torch.encoder.frame_encoder import IntraFrameEncoder

    rows = compare_kernel_tiles(torch, dev)
    clip = synth_clip_natural(2 + TILE_P_TIMED, TILE_W, TILE_H, seed=4)
    for k in wavefront.TILE_LAUNCHES:
        wavefront.TILE_LAUNCHES[k] = 0
    results, summary = timed_stream(
        torch, wavefront, "tiles3x3-ippp-1920x1080-qp22",
        Config(width=TILE_W, height=TILE_H, qp=QP, tiles_x=TILES[0],
               tiles_y=TILES[1]), clip, 2, dev)
    launches = dict(p_intra=wavefront.TILE_LAUNCHES["intra"],
                    p_inter=wavefront.TILE_LAUNCHES["inter"])
    if (launches["p_intra"], launches["p_inter"]) != (1, len(clip) - 1):
        raise RuntimeError(f"tiles3x3-ippp: expected one tiled launch a "
                           f"frame, got {wavefront.TILE_LAUNCHES}")
    ife = IntraFrameEncoder(Config(width=TILE_W, height=TILE_H, qp=QP,
                                   tiles_x=TILES[0], tiles_y=TILES[1]),
                            device=dev)
    # The slice data of a tiled frame is the Python serializer's.
    split = p_stage_split(torch, ife, clip)
    split["cabac_python_ms"] = split.pop("cabac_ms")
    split["cabac_share"] = split["cabac_python_ms"] / sum(split.values())
    log("tiles3x3-ippp stage split (ms, one P frame):", json.dumps(split))
    ife.close()

    enc = Encoder(tiles_config(TILE_W, TILE_H), device=dev)
    list(enc.encode_stream(clip[:TILE_INTRA_WARM]))      # warm-up
    torch.cuda.synchronize()
    for k in wavefront.TILE_LAUNCHES:
        wavefront.TILE_LAUNCHES[k] = 0
    t0 = time.perf_counter()
    results = list(enc.encode_stream(clip[:TILE_INTRA_TIMED]))
    dt = time.perf_counter() - t0
    launches["intra"] = wavefront.TILE_LAUNCHES["intra"]
    if launches["intra"] != 1:
        raise RuntimeError(f"tiles3x3-intra: expected one tiled launch, "
                           f"got {wavefront.TILE_LAUNCHES}")
    bits, psnr_y = check_output(results, "tiles3x3-intra")
    log("tiles3x3-intra-1920x1080-qp22 encode_stream:", json.dumps(dict(
        frames=len(results), batch=TILE_INTRA_TIMED,
        fps=len(results) / dt, bits_per_frame=bits, psnr_y=psnr_y,
        tiled_launches=launches["intra"], stage_wall_s=enc.stats)))
    split = stage_split(torch, enc._intra, clip[:1])
    split["cabac_python_ms"] = split.pop("cabac_ms")
    split["cabac_share"] = split["cabac_python_ms"] / sum(split.values())
    log("tiles3x3-intra stage split (ms, one frame):", json.dumps(split))
    enc.close()

    tiles_streams_card_equals_cpu(wavefront, dev)
    return rows, launches


TOOL_FRAMES = 8                       # phase 17: the intra rows' batch
TOOLS_BIG = (3840, 2176)              # ... its compare-only 4K frame


def tools_config(width, height, cu=16, **kw):
    """The headline configuration at rd 3 with RDOQ and sign hiding: the
    rd 2 re-rank, the chroma-mode search and the kernel's RDOQ /
    sign-hiding instance with explicit chroma modes."""
    cfg = headline_config(width, height, cu)
    cfg.rd, cfg.rdoq, cfg.signhide = 3, True, True
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def compare_kernel_tools(torch, clip46, dev):
    """Phase 17 (i): the kernel's RDOQ / sign-hiding instances and its
    explicit chroma modes == the plain version on the card, max abs
    error 0: RDOQ, sign hiding, both, RDOQ with a per-block QP map and
    (intra) both with random explicit chroma modes, at 832x480 cu 16
    and 32 (cu 8, whose plain version is the slowest: intra both with
    chroma modes, inter both; 10-bit: both (intra with chroma modes) and
    RDOQ with a QP map), intra (random modes over all 35, so every scanIdx; 8 frames
    at cu 16, the intra cell's batch, else 1) and inter (cu 32: a real P
    frame of the ld-slower cell's grid; cu 8 and 16: a random inter map,
    the next frame as the MC planes), 8-bit; 10-bit intra cu 16 and
    inter cu 32; the tiled plans of 1920x1088 3x3 (cu 16 intra, cu 32
    inter); and 3840x2176 cu 32 10-bit compare-only (intra, every tool
    with a QP map and chroma modes).  Each row is timed against the same launch without
    the tool (``ms_without``), with the bound counted from the code
    (``tools_bound_ms``).  Returns the rows by name."""
    from kvazaar_tpu_torch.encoder.frame_encoder import IntraFrameEncoder
    from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
    from kvazaar_tpu_torch.encoder.intra_recon import wavefront_recon_plain
    from kvazaar_tpu_torch.constants import CHROMA_QP_TAB
    from kvazaar_tpu_torch.ops.wavefront import wavefront_recon_planes

    rng = np.random.default_rng(17)
    lam = 0.57 * 2.0 ** ((QP - 12) / 3.0)
    rows = {}

    def rand_modes(plan, n):
        return torch.from_numpy(rng.integers(
            0, 35, (n, plan.blocks_y, plan.blocks_x)).astype(np.int32)).to(
                dev)

    def row_of(name, plan, planes, modes, bd, qp_c, variants, inter=None):
        kw0 = {} if inter is None else dict(
            zip(("is_inter", "mc_y", "mc_cb", "mc_cr"), inter))
        cu = plan.cu_size
        for var in variants:
            kw = dict(kw0, rdoq="rdoq" in var, signhide="sh" in var,
                      lam=lam)
            if "qpmap" in var:
                kw["qp_map"] = torch.from_numpy(rng.integers(
                    QP - 6, QP + 7, tuple(modes.shape)).astype(
                        np.int32)).to(dev)
            if "cmodes" in var:
                kw["cmodes"] = rand_modes(plan, modes.shape[0])

            def launch(kw=kw):
                return wavefront_recon_planes(*planes, modes, plan, QP, qp_c,
                                              bd, **kw)

            got = launch()
            want = []
            qpm = kw.get("qp_map")
            qpm_c = None if qpm is None else torch.from_numpy(
                CHROMA_QP_TAB.astype(np.int32)).to(dev)[qpm.long()]

            def plain():
                for orig, mc, s, luma, qp, m, qm in (
                        (planes[0], kw.get("mc_y"), cu, True, QP, modes,
                         qpm),
                        (planes[1], kw.get("mc_cb"), cu // 2, False, qp_c,
                         kw.get("cmodes", modes), qpm_c),
                        (planes[2], kw.get("mc_cr"), cu // 2, False, qp_c,
                         kw.get("cmodes", modes), qpm_c)):
                    want.extend(wavefront_recon_plain(
                        orig, m, plan, s, luma, qp, bd, kw.get("is_inter"),
                        mc, qm, rdoq=kw["rdoq"], lam=lam,
                        signhide=kw["signhide"]))

            plain_ms = cuda_ms(torch, plain, 1)
            err = max_err(torch, got, want)
            if err != 0:
                raise RuntimeError(f"tools kernel != plain at {name} {var}")
            row = dict(shape=name, variant=var, cu=cu, bitdepth=bd,
                       kind="intra" if inter is None else "inter",
                       items=planes[0].shape[0], tiles=list(plan.tiles),
                       max_abs_err=err, plain_ms=plain_ms,
                       n_steps=plan.n_steps)
            if not name.startswith("compare-only"):
                base = {k: v for k, v in kw.items()
                        if k not in ("rdoq", "signhide", "cmodes")}
                row["ms"] = cuda_ms(torch, launch, 20)
                row["ms_without"] = cuda_ms(torch, lambda: launch(base), 20)
                row["ratio"] = row["ms"] / row["ms_without"]
            ins = [*planes, modes, *kw0.values(), *got]
            ins += [kw[k] for k in ("qp_map", "cmodes") if k in kw]
            work = [(planes[0].numel(), cu), (2 * planes[1].numel(),
                                               cu // 2)]
            row["bound_ms"], row["bound_by"] = bound_ms(ins, work)
            row["tools_bound_ms"], row["tools_bound_by"] = bound_ms_tools(
                ins, work, kw["rdoq"], kw["signhide"])
            log("tools kernel vs plain:", json.dumps(row))
            rows[f"{name} {var}"] = row

    all5 = ("rdoq", "sh", "rdoq+sh", "rdoq+qpmap", "rdoq+sh+cmodes")
    clip = clip46[:TOOL_FRAMES + 1]
    for cu in (8, 16, 32):
        # cu 8's plain version is the slowest (496 steps): one row a
        # variant there, every variant at cu 16 and 32.
        intra_v = all5[4:] if cu == 8 else all5
        inter_v = all5[2:3] if cu == 8 else all5[:4]
        ife = IntraFrameEncoder(tools_config(W, H, cu), device=dev)
        up = ife._upload(ife.host_pack_sources(clip))
        n = TOOL_FRAMES if cu == 16 else 1
        planes = tuple(p[:n] for p in up)
        row_of(f"intra cu{cu} {W}x{H} {n} frames", ife.plan, planes,
               rand_modes(ife.plan, n), 8, ife.qp_c, intra_v)
        if cu == 32:
            pife, (ys, cbs, crs), modes, inter_map, mcs = p_frame_inputs(
                torch, clip46, cu, dev)
            row_of(f"inter cu{cu} {W}x{H} P frame", pife.plan,
                   (ys, cbs, crs), modes[None], 8, pife.qp_c, inter_v,
                   (inter_map[None], *(m[None] for m in mcs)))
            pife.close()
        else:
            inter_map = torch.from_numpy(rng.random(
                (1, ife.plan.blocks_y, ife.plan.blocks_x)) < 0.5).to(dev)
            row_of(f"inter cu{cu} {W}x{H} random", ife.plan,
                   tuple(p[:1] for p in up), rand_modes(ife.plan, 1), 8,
                   ife.qp_c, inter_v,
                   (inter_map, *(p[1:2] for p in up)))
        ife.close()

    clip10 = to_10bit(clip, 170)
    for cu, kind in ((16, "intra"), (32, "inter")):
        ife = IntraFrameEncoder(tools_config(W, H, cu, input_bitdepth=10),
                                device=dev)
        up = tuple(p.to(torch.int16) for p in ife._upload(
            ife.host_pack_sources(clip10[:2])))
        inter = None if kind == "intra" else (
            torch.from_numpy(rng.random((1, ife.plan.blocks_y,
                                         ife.plan.blocks_x)) < 0.5).to(dev),
            *(p[1:] for p in up))
        row_of(f"{kind} cu{cu} {W}x{H} 10-bit", ife.plan,
               tuple(p[:1] for p in up), rand_modes(ife.plan, 1), 10,
               ife.qp_c, ("rdoq+sh+cmodes" if kind == "intra" else "rdoq+sh",
                          "rdoq+qpmap"), inter)
        ife.close()

    (tw, th), big = TILE_SHAPES[0], synth_clip_natural(2, *TILE_SHAPES[0],
                                                       seed=17)
    for cu, kind in ((16, "intra"), (32, "inter")):
        ife = IntraFrameEncoder(tools_config(tw, th, cu, tiles_x=TILES[0],
                                             tiles_y=TILES[1]), device=dev)
        up = ife._upload(ife.host_pack_sources(big))
        inter = None if kind == "intra" else (
            torch.from_numpy(rng.random((1, ife.plan.blocks_y,
                                         ife.plan.blocks_x)) < 0.5).to(dev),
            *(p[1:] for p in up))
        row_of(f"{kind} cu{cu} {tw}x{th} 3x3", ife.plan,
               tuple(p[:1] for p in up), rand_modes(ife.plan, 1), 8,
               ife.qp_c, ("rdoq+sh",), inter)
        ife.close()

    bw, bh = TOOLS_BIG
    plan = make_intra_plan(bw, bh, 32, True)
    big10 = to_10bit(synth_clip_natural(1, bw, bh, seed=18), 171)
    planes = [torch.from_numpy(np.stack([f[k] for f in big10]).astype(
        np.int16)).to(dev) for k in range(3)]
    row_of(f"compare-only intra cu32 {bw}x{bh} 10-bit", plan, planes,
           rand_modes(plan, 1), 10, int(CHROMA_QP_TAB[QP]),
           ("rdoq+sh+qpmap+cmodes",))
    return rows


def bound_ms_tools(tensors, work, rdoq, signhide):
    """``bound_ms`` with RDOQ's and sign hiding's operations per sample
    counted from the kernel's code (csrc/wavefront.cu,
    ``quantize_tools``): RDOQ about 60 (the round-half level, three
    candidates' dequantization, distortion and rate, two double-precision
    multiply-adds, the argmin, and a sixteenth of a group's two sums of
    16 and its test), sign hiding about 12 (a sixteenth of a group's
    scan of 16 coefficients, 12 operations each), on top of the 8 S + 20
    of the transform and the rest."""
    extra = (60 if rdoq else 0) + (12 if signhide else 0)
    return bound_ms(tensors, [(n * (8 * s + 20 + extra) / (8 * s + 20), s)
                              for n, s in work])


def tools_streams_card_equals_cpu(wavefront, dev):
    """Phase 17 (iii): card == CPU bytes and recon at 256x128 for
    ``medium --gop lp-g4d4t1``, ``medium --gop 0 --ref 2``,
    Config(rdoq=True) with --bitrate (per-CTU QP), Config() with RDOQ,
    sign hiding and tiles 2x2, ``medium --period 1 --rd 3`` (variable
    trees with chroma modes), ``placebo --gop 0 --ref 3`` and a 10-bit
    fixed-grid GOP 8 with RDOQ and sign hiding; the RDOQ / sign-hiding
    launches counted around the card runs."""
    from kvazaar_tpu_torch import Config
    from kvazaar_tpu_torch.config import config_from_preset
    w, h = 256, 128
    small = synth_clip_natural(9, w, h, seed=0)
    for k in wavefront.TOOL_LAUNCHES:
        wavefront.TOOL_LAUNCHES[k] = 0

    def preset(name, **kw):
        return config_from_preset(name, width=w, height=h, qp=QP, **kw)

    card_equals_cpu(f"medium --gop lp-g4d4t1 {w}x{h}",
                    preset("medium", lp_gop=(4, 4, 1), gop_len=0),
                    small[:5], dev)
    card_equals_cpu(f"medium --gop 0 --ref 2 {w}x{h}",
                    preset("medium", gop_len=0, ref_frames=2), small[:3],
                    dev)
    # At 256x128 (at 416x240 the CPU's encode took 10 s).
    card_equals_cpu("placebo --gop 0 --ref 3 256x128",
                    config_from_preset("placebo", width=256, height=128,
                                       qp=QP, gop_len=0, ref_frames=3),
                    synth_clip_natural(3, 256, 128, seed=0), dev)
    card_equals_cpu(f"Config(rdoq) --bitrate 330000 {w}x{h}",
                    Config(width=w, height=h, qp=QP, rdoq=True,
                           bitrate=330_000, intra_period=0), small[:3],
                    dev)
    card_equals_cpu(f"Config(rdoq, signhide) tiles 2x2 {w}x{h}",
                    Config(width=w, height=h, qp=QP, rdoq=True,
                           signhide=True, tiles_x=2, tiles_y=2), small[:3],
                    dev)
    # At 256x128 (at 416x240 the CPU's encode took 14 s).
    card_equals_cpu("10-bit fixed GOP 8 RDOQ + sign hiding 256x128",
                    Config(width=256, height=128, qp=QP, input_bitdepth=10,
                           gop_len=8, intra_period=0, rdoq=True,
                           signhide=True),
                    to_10bit(synth_clip_natural(9, 256, 128, seed=0), 172),
                    dev)
    card_equals_cpu(f"medium --period 1 --rd 3 {w}x{h}",
                    preset("medium", intra_period=1, rd=3), small[:2], dev)
    t = dict(wavefront.TOOL_LAUNCHES)
    if min(t["intra"], t["inter"], t["signhide"], t["qp_map"], t["10bit"],
           t["tiled"]) == 0:
        raise RuntimeError(f"tools streams: an instance was not launched "
                           f"({t})")
    return t


def run_tools(torch, wavefront, clip46, dev):
    """Phase 17: RDOQ, sign hiding, --rd 2 and --rd 3 on the fixed grid.
    The kernel's RDOQ / sign-hiding instances and explicit chroma modes
    == plain (``compare_kernel_tools``); the cell
    ``intra-rd3-rdoq-sh-832x480-qp22`` (the headline configuration at rd
    3 with RDOQ and sign hiding; batches and timing as the headline) and
    ``ld-slower-832x480-qp22`` (``--preset slower --gop lp-g4d4t1``: a
    variable-tree I frame, then fixed cu 32 P frames with RDOQ and sign
    hiding at a QP per position; one warm pass over the 8-frame clip,
    then 8 timed P frames), each with its tool launches counted and a
    stage split; and card == CPU for seven streams at 256x128.  Returns
    (kernel rows, launches per record)."""
    from kvazaar_tpu_torch.api import Encoder
    from kvazaar_tpu_torch.config import config_from_preset

    rows = compare_kernel_tools(torch, clip46, dev)
    frames = clip46[:FRAMES]
    launches = {}
    enc = Encoder(tools_config(W, H), device=dev)
    list(enc.encode_stream(frames[:BATCH]))                 # warm-up
    torch.cuda.synchronize()
    for k in wavefront.TOOL_LAUNCHES:
        wavefront.TOOL_LAUNCHES[k] = 0
    wavefront.CMODE_LAUNCHES["intra"] = 0
    t0 = time.perf_counter()
    results = list(enc.encode_stream(frames * TIMED_BATCHES))
    dt = time.perf_counter() - t0
    launches["intra"] = wavefront.TOOL_LAUNCHES["intra"]
    launches["cmodes"] = wavefront.CMODE_LAUNCHES["intra"]
    if launches["intra"] == 0 or launches["cmodes"] != launches["intra"]:
        raise RuntimeError(f"intra-rd3: expected RDOQ / sign-hiding launches "
                           f"with chroma modes, got {wavefront.TOOL_LAUNCHES}"
                           f" / {wavefront.CMODE_LAUNCHES}")
    bits, psnr_y = check_output(results, "intra-rd3")
    log("intra-rd3-rdoq-sh-832x480-qp22 encode_stream:", json.dumps(dict(
        frames=len(results), batch=BATCH, fps=len(results) / dt,
        bits_per_frame=bits, psnr_y=psnr_y, tool_launches=launches["intra"],
        stage_wall_s=enc.stats)))
    split = stage_split(torch, enc._intra, frames[:BATCH])
    log("intra-rd3 stage split (ms/frame, one batch of 8):",
        json.dumps(split))
    enc.close()

    cfg = config_from_preset("slower", width=W, height=H, qp=QP,
                             lp_gop=(4, 4, 1), gop_len=0)
    clip8 = synth_clip_natural(8, W, H, seed=4)
    enc = Encoder(cfg, device=dev)
    results = []
    for res in enc.encode_stream(clip8 * 2):
        results.append(res)
        if len(results) == len(clip8):
            torch.cuda.synchronize()
            for k in wavefront.TOOL_LAUNCHES:
                wavefront.TOOL_LAUNCHES[k] = 0
            t0 = time.perf_counter()
    dt = time.perf_counter() - t0
    launches["inter"] = wavefront.TOOL_LAUNCHES["inter"]
    timed = results[len(clip8):]
    if (launches["inter"] != len(timed)
            or any(r[1].slice_type != 1 for r in timed)):
        raise RuntimeError(f"ld-slower: expected one RDOQ / sign-hiding P "
                           f"launch a P frame, got {wavefront.TOOL_LAUNCHES}")
    bits, psnr_y = check_output(timed, "ld-slower")
    log("ld-slower-832x480-qp22 encode_stream:", json.dumps(dict(
        frames=len(results), timed=len(timed), fps=len(timed) / dt,
        bits_per_frame=bits, idr_bits=results[0][1].bits, psnr_y=psnr_y,
        qps=sorted({r[1].qp for r in results}),
        tool_launches=launches["inter"])))
    enc.close()
    log("ld-slower stage split (ms, one P frame, 1 reference):",
        json.dumps(ld_p_split(torch, cfg, clip8, dev, nref=1)))

    streams = tools_streams_card_equals_cpu(wavefront, dev)
    launches.update({k: streams[k] for k in ("qp_map", "10bit", "tiled")})
    return rows, launches


NXN_FRAMES = 8                        # phase 18: the kernel rows' batch
NXN_BIG = (1920, 1088)                # ... its compare-only frame
NXN_WARM, NXN_TIMED = 1, 2            # ... the NxN cell's batches
NXN_SMALL = (128, 64)                 # ... the card == CPU streams


def nxn_config(width, height, **kw):
    """The headline configuration at the intra-NxN point with transform
    skip: fixed CU 4 (8x8 CUs coded PART_NxN, four 4x4 luma TBs with the
    DST-VII), rd 1, deblocking, WPP."""
    cfg = headline_config(width, height, cu=4)
    cfg.transform_skip = True
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def trdepth_config(width, height, **kw):
    """``--preset medium --period 1 --tr-depth-intra 1``: variable intra
    trees 8..32 whose 16 and 32 CUs may split their TBs, RDOQ, SAO."""
    from kvazaar_tpu_torch.config import config_from_preset
    return config_from_preset("medium", width=width, height=height, qp=QP,
                              intra_period=1, tr_depth_intra=1, **kw)


def compare_kernel_nxn(torch, clip46, dev):
    """Phase 18 (i): the kernel's cu 4 instances (luma on the plan of 4x4
    blocks with the DST-VII and, as a run-time flag, the transform-skip
    decision) and the chroma-only launch of the cu 8 instances on the
    NxN point's cu 8 plan == the plain version on the card, max abs
    error 0 (levels, recon and skip flags): 832x480 over 8 frames with
    the searched modes and with random modes over all 35, transform skip
    off and on, sign hiding, RDOQ with sign hiding, lossless, 10-bit with
    transform skip, and a 1920x1088 compare-only frame.  Each row is
    timed against the cu 8 joint launch (luma + Cb + Cr) on the same
    frames (``ms_cu8``), with its layout (threads, shared memory, steps)
    and its bound (``nxn_bound_ms``: the transform-skip rows count its
    second roundtrip).  Returns the rows by name."""
    from kvazaar_tpu_torch.encoder.frame_encoder import IntraFrameEncoder
    from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
    from kvazaar_tpu_torch.encoder.intra_recon import wavefront_recon_plain
    from kvazaar_tpu_torch.encoder.intra_search import search_frame_modes
    from kvazaar_tpu_torch.ops.wavefront import (launch_layout,
                                                 wavefront_recon_chroma,
                                                 wavefront_recon_planes)

    rng = np.random.default_rng(18)
    lam = 0.57 * 2.0 ** ((QP - 12) / 3.0)
    rows = {}

    def row_of(name, ife, planes, modes, bd, variants, timed=True):
        plan, plan_c = ife.plan, ife.plan_c
        ys, cbs, crs = planes
        dm = modes[:, ::2, ::2].contiguous()
        for var in variants:
            tools = dict(rdoq="rdoq" in var, signhide="sh" in var,
                         lossless="lossless" in var, lam=lam)
            ts = "tskip" in var

            def luma(tools=tools, ts=ts):
                return wavefront_recon_planes(ys, None, None, modes, plan,
                                              QP, ife.qp_c, bd, tskip=ts,
                                              **tools)

            def chroma(tools=tools):
                return wavefront_recon_chroma(cbs, crs, dm, plan_c,
                                              ife.qp_c, bd, **tools)

            got_y = [t for t in luma() if t is not None]
            got_c = list(chroma())
            want = {}

            def plain_luma(tools=tools, ts=ts):
                want["y"] = wavefront_recon_plain(ys, modes, plan, 4, True,
                                                  QP, bd, tskip=ts, **tools)

            def plain_chroma(tools=tools):
                rc = wavefront_recon_plain(torch.cat([cbs, crs]), dm,
                                           plan_c, 4, False, ife.qp_c, bd,
                                           **tools)
                b = cbs.shape[0]
                want["c"] = [rc[0][:b], rc[1][:b], rc[0][b:], rc[1][b:]]

            plain_ms_luma = cuda_ms(torch, plain_luma, 1)
            plain_ms_chroma = cuda_ms(torch, plain_chroma, 1)
            # rec_y, lv_y (, the skip flags); rec_cb, lv_cb, rec_cr, lv_cr.
            err = max(max_err(torch, got_y, want["y"]),
                      max_err(torch, got_c, want["c"]))
            if err != 0 or len(got_y) != len(want["y"]):
                raise RuntimeError(f"cu 4 kernel != plain at {name} {var}")
            ring, threads, smem = launch_layout(plan, 4, ys.shape[2], bd)
            ring_c, threads_c, smem_c = launch_layout(plan_c, 4,
                                                      cbs.shape[2], bd)
            row = dict(shape=name, variant=var, bitdepth=bd,
                       items=ys.shape[0], max_abs_err=err,
                       plain_ms_luma=plain_ms_luma,
                       plain_ms_chroma=plain_ms_chroma, n_steps=plan.n_steps,
                       n_steps_chroma=plan_c.n_steps, ring=ring,
                       threads=threads, smem_bytes=smem,
                       threads_chroma=threads_c, smem_bytes_chroma=smem_c)
            if ts:
                row["skipped_share"] = float(got_y[2].float().mean())
            if timed:
                row["ms_luma"] = cuda_ms(torch, luma, 10)
                row["ms_chroma"] = cuda_ms(torch, chroma, 10)
                row["ms"] = row["ms_luma"] + row["ms_chroma"]
                row["ms_cu8"] = ife_cu8_ms(torch, ife, planes, bd, tools)
                row["ratio_cu8"] = row["ms"] / row["ms_cu8"]
            # Bounds of each launch: the transform-skip decision runs a
            # second quantization and roundtrip of every luma sample.
            for part, ins, work in (
                    ("luma", [ys, modes, *got_y],
                     [(ys.numel() * (2 if ts else 1), 4)]),
                    ("chroma", [cbs, crs, dm, *got_c],
                     [(2 * cbs.numel(), 4)])):
                if tools["rdoq"] or tools["signhide"]:
                    b = bound_ms_tools(ins, work, tools["rdoq"],
                                       tools["signhide"])
                else:
                    b = bound_ms(ins, work)
                row[f"bound_ms_{part}"], row[f"bound_by_{part}"] = b
            log("cu4 kernel vs plain:", json.dumps(row))
            rows[f"{name} {var}"] = row

    def ife_cu8_ms(torch, ife, planes, bd, tools):
        """The cu 8 joint launch on the same frames, random modes (the
        tools as the row's, without transform skip)."""
        plan8 = make_intra_plan(ife.coded_w, ife.coded_h, 8, True)
        modes8 = torch.from_numpy(rng.integers(0, 35, (
            planes[0].shape[0], plan8.blocks_y, plan8.blocks_x)).astype(
                np.int32)).to(dev)
        return cuda_ms(torch, lambda: wavefront_recon_planes(
            *planes, modes8, plan8, QP, ife.qp_c, bd, **tools), 10)

    def rand_modes(ife, n):
        return torch.from_numpy(rng.integers(0, 35, (
            n, ife.plan.blocks_y, ife.plan.blocks_x)).astype(np.int32)).to(
                dev)

    clip = clip46[:NXN_FRAMES]
    ife = IntraFrameEncoder(nxn_config(W, H), device=dev)
    planes = ife._upload(ife.host_pack_sources(clip))
    searched = torch.stack([search_frame_modes(
        y, ife.plan, ife.lambda_satd, 8, True)[0] for y in planes[0]])
    row_of(f"{W}x{H} {NXN_FRAMES} frames searched", ife, planes, searched,
           8, ("plain", "tskip", "tskip+sh", "rdoq+sh", "lossless"))
    row_of(f"{W}x{H} {NXN_FRAMES} frames random", ife, planes,
           rand_modes(ife, NXN_FRAMES), 8, ("tskip+sh",))
    ife.close()

    ife = IntraFrameEncoder(nxn_config(W, H, input_bitdepth=10), device=dev)
    up = tuple(p.to(torch.int16) for p in ife._upload(
        ife.host_pack_sources(to_10bit(clip[:2], 180))))
    row_of(f"{W}x{H} 10-bit 2 frames", ife, up, rand_modes(ife, 2), 10,
           ("tskip", "rdoq+sh"))
    ife.close()

    bw, bh = NXN_BIG
    ife = IntraFrameEncoder(nxn_config(bw, bh), device=dev)
    big = ife._upload(ife.host_pack_sources(
        synth_clip_natural(1, bw, bh, seed=19)))
    row_of(f"compare-only {bw}x{bh}", ife, big, rand_modes(ife, 1), 8,
           ("tskip+sh",), timed=False)
    ife.close()
    return rows


def run_nxn_cell(torch, wavefront, clip46, dev):
    """Phase 18 (ii): the cell intra-nxn-tskip-832x480-qp22 (the headline
    configuration at the intra-NxN point with transform skip): a warm-up
    batch of NXN_WARM frames, then one timed batch of NXN_TIMED through
    Encoder.encode_stream, the cu 4 and transform-skip launches counted
    around it; and a stage split per frame: the device's search, luma
    (cu 4) and chroma reconstruction of the batch (CUDA events), its
    download, and the Python CABAC of one frame (wall clock).  Returns
    its summary."""
    from kvazaar_tpu_torch.api import Encoder
    from kvazaar_tpu_torch.encoder.intra_recon import (
        reconstruct_chroma_frames, reconstruct_frames)
    from kvazaar_tpu_torch.encoder.intra_search import search_frame_modes
    enc = Encoder(nxn_config(W, H), device=dev)
    frames = clip46[:NXN_TIMED]
    list(enc.encode_stream(clip46[:NXN_WARM]))             # warm-up
    torch.cuda.synchronize()
    for counts in (wavefront.CU4_LAUNCHES, wavefront.TSKIP_LAUNCHES):
        for k in counts:
            counts[k] = 0
    t0 = time.perf_counter()
    results = list(enc.encode_stream(frames))
    dt = time.perf_counter() - t0
    cu4, tskip = dict(wavefront.CU4_LAUNCHES), dict(wavefront.TSKIP_LAUNCHES)
    if cu4["luma"] == 0 or cu4["chroma"] != cu4["luma"] or \
            tskip["luma"] != cu4["luma"]:
        raise RuntimeError(f"nxn cell: expected cu 4 launches with "
                           f"transform skip and a chroma launch each, got "
                           f"{cu4} / {tskip}")
    if len(results) != len(frames):
        raise RuntimeError(f"nxn cell: {len(results)} results for "
                           f"{len(frames)} frames")
    bits, psnr_y = check_output(results, "nxn cell")
    summary = dict(frames=len(frames), fps=len(frames) / dt,
                   bits_per_frame=bits, psnr_y=psnr_y, cu4_launches=cu4,
                   tskip_launches=tskip, stage_wall_s=enc.stats)
    log("intra-nxn-tskip-832x480-qp22 encode_stream:", json.dumps(summary))

    ife = enc._intra
    ys, cbs, crs = ife._upload(ife.host_pack_sources(frames))
    box = {}

    def search():
        box["modes"] = torch.stack([search_frame_modes(
            y, ife.plan, ife.lambda_satd, 8, True)[0] for y in ys])

    def recon_luma():
        reconstruct_frames(ys, None, None, box["modes"], ife.plan, QP,
                           ife.qp_c, tskip=True, **ife._recon_tools())

    def recon_chroma():
        reconstruct_chroma_frames(cbs, crs,
                                  box["modes"][:, ::2, ::2].contiguous(),
                                  ife.plan_c, ife.qp_c, **ife._recon_tools())

    split = {}
    for name, fn in (("search", search), ("recon_cu4", recon_luma),
                     ("recon_chroma", recon_chroma)):
        fn()
        split[name + "_ms"] = cuda_ms(torch, fn, 3) / len(frames)
    handle = ife.submit_frames(frames)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n, modes, lv, _rec, _sses, _sao, _cmodes, ts = ife.download_frames(
        handle, need_recon=False)
    split["d2h_ms"] = 1000 * (time.perf_counter() - t0) / len(frames)
    t0 = time.perf_counter()
    ife._host_finalize(modes[0], lv[0][0], lv[1][0], lv[2][0], None, None,
                       None, ts_y=ts[0])
    split["cabac_python_ms"] = 1000 * (time.perf_counter() - t0)
    split["cabac_share"] = split["cabac_python_ms"] / sum(split.values())
    split["tskip_share"] = float(ts.mean())
    log("intra-nxn stage split (ms/frame):", json.dumps(split))
    summary["split"] = split
    enc.close()
    return summary


def run_trdepth_cell(torch, dev):
    """Phase 18 (iii): the cell intra-medium-trdepth-832x480-qp22
    (``trdepth_config``): one warm-up and one timed frame through
    Encoder.encode_stream; then the stage split of the variable tree
    (``var_stage_split``, one frame) with the share of 8x8 cells whose CU
    split its TBs."""
    from kvazaar_tpu_torch.api import Encoder
    frames = synth_clip_natural(2, W, H, seed=5)
    enc = Encoder(trdepth_config(W, H), device=dev)
    list(enc.encode_stream(frames[:1]))                    # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = list(enc.encode_stream(frames[1:]))
    dt = time.perf_counter() - t0
    bits, psnr_y = check_output(results, "trdepth cell")
    split, depths, cus = var_stage_split(torch, enc._intra, frames[1:],
                                         count=False)
    if "trsplit_cell_share" not in split:
        raise RuntimeError("trdepth cell: the tree took no TU-split costs")
    summary = dict(frames=len(results), fps=len(results) / dt,
                   bits_per_frame=bits, psnr_y=psnr_y,
                   trsplit_cell_share=split["trsplit_cell_share"],
                   n_steps_real=depths, cu_histogram=cus)
    log("intra-medium-trdepth-832x480-qp22 encode_stream:",
        json.dumps(summary))
    log("intra-medium-trdepth stage split (ms, one frame):",
        json.dumps(split))
    enc.close()
    return summary


def nxn_streams_card_equals_cpu(wavefront, dev):
    """Phase 18 (iv): card == CPU bytes and recon at NXN_SMALL for cu 4
    with WPP and sign hiding, cu 4 with transform skip, cu 4 10-bit
    4:0:0, cu 4 with RDOQ, cu 4 lossless, --tr-depth-intra 1 all-intra
    8..32 at rd 2, the same flag on a variable-tree IPPP stream and on a
    medium GOP 4, and the tiled I + P stream with RDOQ and sign hiding
    that holds F2 (ROADMAP §3); the cu 4 launches counted around the
    card runs.  Returns them."""
    from kvazaar_tpu_torch import Config
    from kvazaar_tpu_torch.config import config_from_preset
    w, h = NXN_SMALL
    small = synth_clip_natural(3, w, h, seed=6)
    for counts in (wavefront.CU4_LAUNCHES, wavefront.TSKIP_LAUNCHES):
        for k in counts:
            counts[k] = 0

    def nxn(**kw):
        return Config(**dict(dict(width=w, height=h, qp=QP, intra_min_cu=4,
                                  intra_max_cu=4, intra_period=1), **kw))

    card_equals_cpu(f"cu 4 WPP + sign hiding {w}x{h}",
                    nxn(wpp=True, signhide=True), small[:2], dev)
    card_equals_cpu(f"cu 4 transform skip {w}x{h}",
                    nxn(transform_skip=True, qp=32), small[:2], dev)
    card_equals_cpu(f"cu 4 10-bit 4:0:0 {w}x{h}",
                    nxn(input_bitdepth=10, chroma_format=400),
                    [(f[0], None, None) for f in to_10bit(small[:1], 181)],
                    dev)
    card_equals_cpu(f"cu 4 RDOQ {w}x{h}", nxn(rdoq=True), small[:1], dev)
    card_equals_cpu(f"cu 4 lossless {w}x{h}", nxn(lossless=True),
                    small[:1], dev)
    td = dict(width=w, height=h, qp=QP, intra_min_cu=8, intra_max_cu=32,
              rd=2, tr_depth_intra=1)
    card_equals_cpu(f"--tr-depth-intra 1 all-intra {w}x{h}",
                    Config(intra_period=1, **td), small[:2], dev)
    card_equals_cpu(f"--tr-depth-intra 1 IPPP {w}x{h}",
                    Config(intra_period=0, **td), small[:3], dev)
    card_equals_cpu(f"medium --gop 4 --tr-depth-intra 1 {w}x{h}",
                    config_from_preset("medium", width=w, height=h, qp=QP,
                                       gop_len=4, intra_period=0,
                                       tr_depth_intra=1),
                    synth_clip_natural(5, w, h, seed=7), dev)
    card_equals_cpu("F2: Config(rdoq, signhide) tiles 2x2 I + P 128x128",
                    Config(width=128, height=128, qp=27, tiles_x=2,
                           tiles_y=2, rdoq=True, signhide=True,
                           intra_period=2),
                    synth_clip_natural(2, 128, 128, seed=16), dev)
    c, t = dict(wavefront.CU4_LAUNCHES), dict(wavefront.TSKIP_LAUNCHES)
    if min(c["luma"], c["chroma"], c["10bit"], c["tq"], c["lossless"],
           t["luma"]) == 0:
        raise RuntimeError(f"nxn streams: an instance was not launched "
                           f"({c} / {t})")
    return {**{f"cu4_{k}": v for k, v in c.items()},
            **{f"tskip_{k}": v for k, v in t.items()}}


def run_nxn(torch, wavefront, clip46, dev):
    """Phase 18: the intra-NxN point (fixed CU 4, DST-VII), transform
    skip and --tr-depth-intra.  The kernel's cu 4 instances and the
    NxN chroma launch == plain (``compare_kernel_nxn``); the cells
    intra-nxn-tskip-832x480-qp22 (``run_nxn_cell``) and
    intra-medium-trdepth-832x480-qp22 (``run_trdepth_cell``); and card ==
    CPU for nine streams (``nxn_streams_card_equals_cpu``).  Returns
    (kernel rows, cell summary, launches per record)."""
    rows = compare_kernel_nxn(torch, clip46, dev)
    cell = run_nxn_cell(torch, wavefront, clip46, dev)
    run_trdepth_cell(torch, dev)
    launches = nxn_streams_card_equals_cpu(wavefront, dev)
    launches.update(cell_luma=cell["cu4_launches"]["luma"],
                    cell_chroma=cell["cu4_launches"]["chroma"])
    return rows, launches


SL_FRAMES = 8                         # phase 19: the intra cu 16 rows
SL_TILES = (1920, 1088)               # ... the tiled rows' frame
SL_BIG = (3840, 2176)                 # ... its compare-only 4K frame
SL_SMALL = (128, 64)                  # ... the card == CPU streams
SL_QP_HIGH = 37                       # ... the clip-then-shift rows' QP
_CQM_NAMES = (
    "INTRA4X4_LUMA", "INTRA4X4_CHROMAU", "INTRA4X4_CHROMAV",
    "INTER4X4_LUMA", "INTER4X4_CHROMAU", "INTER4X4_CHROMAV",
    "INTRA8X8_LUMA", "INTRA8X8_CHROMAU", "INTRA8X8_CHROMAV",
    "INTER8X8_LUMA", "INTER8X8_CHROMAU", "INTER8X8_CHROMAV",
    "INTRA16X16_LUMA", "INTRA16X16_CHROMAU", "INTRA16X16_CHROMAV",
    "INTER16X16_LUMA", "INTER16X16_CHROMAU", "INTER16X16_CHROMAV",
    "INTRA32X32_LUMA", "INTER32X32_LUMA")


def write_cqm(path, seed=7, nxn=False):
    """A cqmfile whose matrices all differ (intra / inter, Y / Cb / Cr,
    each size), entries in 8..80 rising away from DC, DC entries in
    12..30 (tests/test_torch_scaling.py writes the same); nxn: the intra
    4x4 Cr matrix equals the Cb one, as the intra-NxN point requires (F4
    in ROADMAP §3)."""
    rng = np.random.default_rng(seed)
    text, mats = [], {}
    for name in _CQM_NAMES:
        n = 4 if "4X4" in name else 8
        yy, xx = np.mgrid[0:n, 0:n]
        m = 12 + 5 * (yy + xx) * 8 // n + rng.integers(-4, 5, (n, n))
        if nxn and name == "INTRA4X4_CHROMAV":
            m = mats["INTRA4X4_CHROMAU"]
        mats[name] = m
        text.append(name + "\n" + ",".join(
            str(v) for v in np.clip(m, 8, 80).ravel()) + "\n")
        if n == 8 and "8X8" not in name:
            text.append(f"{name}_DC\n{int(rng.integers(12, 31))}\n")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("".join(text))
    return path


def sl_paths():
    """The phase's cqm files under build/ (the full one and the intra-NxN
    one), written once."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    return (write_cqm(os.path.join(root, "phase19.cqm")),
            write_cqm(os.path.join(root, "phase19-nxn.cqm"), nxn=True))


def compare_kernel_sl(torch, clip46, dev):
    """Phase 19 (i): the kernel's scaling-list instances == the plain
    version on the card, max abs error 0, every plane with its own
    tables (the script's custom cqm, whose matrices all differ, or the
    default lists): 832x480 intra cu 16 over 8 frames (the intra cell's
    batch) and cu 32 over one at QP 22, cu 8 over one at QP 37; inter on
    a real cu 32 P frame (the ld-slower-cqm cell's grid) and a random cu 8
    one at QP 37; RDOQ with sign hiding; 10-bit intra cu 16; 1920x1088 3x3
    tiled intra cu 16 and inter cu 32; cu 4 with its chroma launch of the
    cu 8 instances (the NxN cqm); and 3840x2176 cu 32 10-bit intra
    compare-only with its layout.  Each row is timed against the same
    launch without the lists (``ms_flat``).  Returns the rows by name."""
    from kvazaar_tpu_torch.constants import CHROMA_QP_TAB
    from kvazaar_tpu_torch.encoder.frame_encoder import IntraFrameEncoder
    from kvazaar_tpu_torch.encoder.geometry import make_intra_plan
    from kvazaar_tpu_torch.encoder.intra_recon import wavefront_recon_plain
    from kvazaar_tpu_torch.ops.quant import scaling_tables
    from kvazaar_tpu_torch.ops.scaling import ScalingLists, parse_cqmfile
    from kvazaar_tpu_torch.ops.wavefront import (launch_layout,
                                                 wavefront_recon_chroma,
                                                 wavefront_recon_planes)

    cqm, cqm_nxn = sl_paths()
    lists = {"custom": parse_cqmfile(cqm), "default": ScalingLists("default"),
             "nxn": parse_cqmfile(cqm_nxn)}
    rng = np.random.default_rng(19)
    rows = {}

    def rand_modes(plan, n):
        return torch.from_numpy(rng.integers(
            0, 35, (n, plan.blocks_y, plan.blocks_x)).astype(np.int32)).to(
                dev)

    def row_of(name, plan, planes, modes, bd, qp, variants, inter=None,
               timed=True):
        kw0 = {} if inter is None else dict(
            zip(("is_inter", "mc_y", "mc_cb", "mc_cr"), inter))
        cu = plan.cu_size
        qp_c = int(CHROMA_QP_TAB[qp])
        lam = 0.57 * 2.0 ** ((qp - 12) / 3.0)
        for var in variants:
            sl = lists[var.split("+")[0]]
            kw = dict(kw0, rdoq="rdoq" in var, signhide="sh" in var,
                      lam=lam)

            def launch(scaling=sl, kw=kw):
                return wavefront_recon_planes(*planes, modes, plan, qp, qp_c,
                                              bd, scaling=scaling, **kw)

            got = launch()
            want = []

            def plain():
                for orig, mc, s, luma, pq, comp in (
                        (planes[0], kw.get("mc_y"), cu, True, qp, 0),
                        (planes[1], kw.get("mc_cb"), cu // 2, False, qp_c,
                         1),
                        (planes[2], kw.get("mc_cr"), cu // 2, False, qp_c,
                         2)):
                    want.extend(wavefront_recon_plain(
                        orig, modes, plan, s, luma, pq, bd,
                        kw.get("is_inter"), mc, rdoq=kw["rdoq"], lam=lam,
                        signhide=kw["signhide"],
                        scaling_tab=scaling_tables(sl, s, comp, pq, dev)))

            plain_ms = cuda_ms(torch, plain, 1)
            err = max_err(torch, got, want)
            if err != 0:
                raise RuntimeError(f"sl kernel != plain at {name} {var}")
            ring, threads, smem = launch_layout(plan, cu, planes[0].shape[2],
                                                bd)
            row = dict(shape=name, variant=var, cu=cu, bitdepth=bd, qp=qp,
                       kind="intra" if inter is None else "inter",
                       items=planes[0].shape[0], tiles=list(plan.tiles),
                       max_abs_err=err, plain_ms=plain_ms,
                       n_steps=plan.n_steps, ring=ring, threads=threads,
                       smem_bytes=smem)
            if timed:
                row["ms"] = cuda_ms(torch, launch, 20)
                row["ms_flat"] = cuda_ms(torch, lambda: launch(None), 20)
                row["ratio"] = row["ms"] / row["ms_flat"]
            tabs = [4 * 4 * s * s for s in (cu, cu // 2, cu // 2)]
            ins = [*planes, modes, *kw0.values(), *got]
            work = [(planes[0].numel(), cu), (2 * planes[1].numel(),
                                               cu // 2)]
            if kw["rdoq"] or kw["signhide"]:
                b, by = bound_ms_tools(ins, work, kw["rdoq"], kw["signhide"])
            else:
                b, by = bound_ms(ins, work)
            # The tables: read once per launch, (4, S, S) int32 a plane.
            row["bound_ms"] = b + 1e3 * sum(tabs) / PEAK_BYTES_S
            row["bound_by"] = by
            log("sl kernel vs plain:", json.dumps(row))
            rows[f"{name} {var}"] = row

    clip = clip46[:SL_FRAMES + 1]
    for cu in (8, 16, 32):
        ife = IntraFrameEncoder(headline_config(W, H, cu), device=dev)
        up = ife._upload(ife.host_pack_sources(clip))
        n = SL_FRAMES if cu == 16 else 1
        planes = tuple(p[:n] for p in up)
        if cu != 8:
            row_of(f"intra cu{cu} {W}x{H} {n} frames", ife.plan, planes,
                   rand_modes(ife.plan, n), 8, QP,
                   ("default", "custom+rdoq+sh") if cu == 16
                   else ("custom",))
        else:
            row_of(f"intra cu8 {W}x{H} 1 frames qp{SL_QP_HIGH}", ife.plan,
                   planes, rand_modes(ife.plan, 1), 8, SL_QP_HIGH,
                   ("custom",))
            inter_map = torch.from_numpy(rng.random(
                (1, ife.plan.blocks_y, ife.plan.blocks_x)) < 0.5).to(dev)
            row_of(f"inter cu8 {W}x{H} random qp{SL_QP_HIGH}", ife.plan,
                   tuple(p[:1] for p in up), rand_modes(ife.plan, 1), 8,
                   SL_QP_HIGH, ("custom+rdoq+sh",),
                   (inter_map, *(p[1:2] for p in up)))
        ife.close()
    pife, (ys, cbs, crs), modes, inter_map, mcs = p_frame_inputs(
        torch, clip46, 32, dev)
    row_of(f"inter cu32 {W}x{H} P frame", pife.plan, (ys, cbs, crs),
           modes[None], 8, QP, ("custom", "custom+rdoq+sh"),
           (inter_map[None], *(m[None] for m in mcs)))
    pife.close()

    clip10 = to_10bit(clip[:1], 190)
    plan = make_intra_plan(W, H, 16, True)
    up = tuple(torch.from_numpy(np.stack([f[k] for f in clip10]).astype(
        np.int16)).to(dev) for k in range(3))
    row_of(f"intra cu16 {W}x{H} 10-bit", plan, up, rand_modes(plan, 1), 10,
           QP, ("custom+rdoq+sh",))

    (tw, th), big = SL_TILES, synth_clip_natural(2, *SL_TILES, seed=19)
    for cu, kind in ((16, "intra"), (32, "inter")):
        plan = make_intra_plan(tw, th, cu, True, tiles=TILES)
        up = [torch.from_numpy(np.stack([f[k] for f in big])).to(dev)
              for k in range(3)]
        inter = None if kind == "intra" else (
            torch.from_numpy(rng.random((1, plan.blocks_y,
                                         plan.blocks_x)) < 0.5).to(dev),
            *(p[1:] for p in up))
        row_of(f"{kind} cu{cu} {tw}x{th} 3x3", plan,
               tuple(p[:1] for p in up), rand_modes(plan, 1), 8, QP,
               ("custom+rdoq+sh" if kind == "inter" else "custom",), inter)

    # cu 4: luma on the plan of 4x4 blocks, chroma on the cu 8 plan.
    ife = IntraFrameEncoder(nxn_config(W, H, transform_skip=False),
                            device=dev)
    ys, cbs, crs = (p[:2] for p in ife._upload(ife.host_pack_sources(
        clip[:2])))
    modes = rand_modes(ife.plan, 2)
    dm = modes[:, ::2, ::2].contiguous()
    sl = lists["nxn"]
    lam = 0.57 * 2.0 ** ((QP - 12) / 3.0)
    for var in ("nxn", "nxn+rdoq+sh"):
        tools = dict(rdoq="rdoq" in var, signhide="sh" in var, lam=lam)

        def luma(scaling=sl, tools=tools):
            return wavefront_recon_planes(ys, None, None, modes, ife.plan,
                                          QP, ife.qp_c, scaling=scaling,
                                          **tools)[:2]

        def chroma(scaling=sl, tools=tools):
            return wavefront_recon_chroma(cbs, crs, dm, ife.plan_c,
                                          ife.qp_c, scaling=scaling, **tools)

        got = [*luma(), *chroma()]
        want = []

        def plain(tools=tools):
            want.extend(wavefront_recon_plain(
                ys, modes, ife.plan, 4, True, QP, 8,
                scaling_tab=scaling_tables(sl, 4, 0, QP, dev), **tools))
            for orig, comp in ((cbs, 1), (crs, 2)):
                want.extend(wavefront_recon_plain(
                    orig, dm, ife.plan_c, 4, False, ife.qp_c, 8,
                    scaling_tab=scaling_tables(sl, 4, comp, ife.qp_c, dev),
                    **tools))

        plain_ms = cuda_ms(torch, plain, 1)
        err = max_err(torch, got, want)
        if err != 0:
            raise RuntimeError(f"sl cu 4 kernel != plain at {var}")
        ms = cuda_ms(torch, luma, 10) + cuda_ms(torch, chroma, 10)
        ms_flat = (cuda_ms(torch, lambda: luma(None), 10)
                   + cuda_ms(torch, lambda: chroma(None), 10))
        ins, work = [ys, cbs, crs, modes, dm, *got], [(ys.numel(), 4),
                                                      (2 * cbs.numel(), 4)]
        b, by = (bound_ms_tools(ins, work, True, True) if tools["rdoq"]
                 else bound_ms(ins, work))
        row = dict(shape=f"cu4 {W}x{H} 2 frames + chroma", variant=var,
                   cu=4, bitdepth=8, qp=QP, kind="intra", items=2,
                   tiles=[1, 1], max_abs_err=err, plain_ms=plain_ms,
                   n_steps=ife.plan.n_steps, ms=ms, ms_flat=ms_flat,
                   ratio=ms / ms_flat, bound_ms=b, bound_by=by)
        log("sl kernel vs plain:", json.dumps(row))
        rows[f"{row['shape']} {var}"] = row
    ife.close()

    bw, bh = SL_BIG
    plan = make_intra_plan(bw, bh, 32, True)
    big10 = to_10bit(synth_clip_natural(1, bw, bh, seed=20), 191)
    planes = [torch.from_numpy(np.stack([f[k] for f in big10]).astype(
        np.int16)).to(dev) for k in range(3)]
    row_of(f"compare-only intra cu32 {bw}x{bh} 10-bit", plan, planes,
           rand_modes(plan, 1), 10, QP, ("custom+rdoq+sh",), timed=False)
    return rows


def sl_config(width, height, **kw):
    """The headline configuration with the spec's default scaling
    lists."""
    cfg = headline_config(width, height)
    cfg.scaling_list = "default"
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def sl_streams_card_equals_cpu(wavefront, dev):
    """Phase 19 (iii): card == CPU bytes and recon at SL_SMALL for
    default-list IPPP, custom-list cu 4 (the NxN cqm), a custom-list
    medium GOP 4 (variable B trees, a frame encoder per layer QP),
    10-bit custom cu 16 and, at 128x128, tiles 2x2 with RDOQ, sign
    hiding and the custom cqm; the SL launches counted around the card
    runs.  Returns them."""
    from kvazaar_tpu_torch import Config
    from kvazaar_tpu_torch.config import config_from_preset
    cqm, cqm_nxn = sl_paths()
    w, h = SL_SMALL
    small = synth_clip_natural(5, w, h, seed=8)
    for k in wavefront.SL_LAUNCHES:
        wavefront.SL_LAUNCHES[k] = 0
    card_equals_cpu(f"default lists IPPP {w}x{h}",
                    Config(width=w, height=h, qp=QP, intra_period=0,
                           scaling_list="default"), small[:3], dev)
    card_equals_cpu(f"cqm cu 4 {w}x{h}",
                    Config(width=w, height=h, qp=QP, intra_min_cu=4,
                           intra_max_cu=4, intra_period=1, cqmfile=cqm_nxn),
                    small[:1], dev)
    card_equals_cpu(f"medium --gop 4 --cqmfile {w}x{h}",
                    config_from_preset("medium", width=w, height=h, qp=QP,
                                       gop_len=4, intra_period=0,
                                       cqmfile=cqm), small, dev)
    card_equals_cpu(f"10-bit cu 16 --cqmfile {w}x{h}",
                    Config(width=w, height=h, qp=QP, input_bitdepth=10,
                           intra_min_cu=16, intra_max_cu=16, intra_period=0,
                           cqmfile=cqm), to_10bit(small[:2], 192), dev)
    card_equals_cpu("tiles 2x2 RDOQ + sign hiding --cqmfile 128x128",
                    Config(width=128, height=128, qp=QP, tiles_x=2,
                           tiles_y=2, rdoq=True, signhide=True,
                           intra_period=0, cqmfile=cqm),
                    synth_clip_natural(2, 128, 128, seed=9), dev)
    c = dict(wavefront.SL_LAUNCHES)
    if min(c.values()) == 0:
        raise RuntimeError(f"sl streams: an instance was not launched ({c})")
    return c


def run_scaling(torch, wavefront, clip46, dev):
    """Phase 19: scaling lists.  The kernel's SL instances == plain
    (``compare_kernel_sl``); the cells
    ``intra-scaling-default-832x480-qp22`` (``sl_config``; batches and
    timing as the headline) and ``ld-slower-cqm-832x480-qp22``
    (``--preset slower --gop lp-g4d4t1 --cqmfile``: a variable-tree I
    frame, then fixed cu 32 P frames with RDOQ and sign hiding through
    the TQ SL instance, a frame encoder per position QP; timed as
    ld-slower), each with its SL launches and a stage split; and card ==
    CPU for five streams (``sl_streams_card_equals_cpu``).  Returns
    (kernel rows, launches per record)."""
    from kvazaar_tpu_torch.api import Encoder
    from kvazaar_tpu_torch.config import config_from_preset

    rows = compare_kernel_sl(torch, clip46, dev)
    launches = {}
    frames = clip46[:FRAMES]
    enc = Encoder(sl_config(W, H), device=dev)
    list(enc.encode_stream(frames[:BATCH]))                 # warm-up
    torch.cuda.synchronize()
    for k in wavefront.SL_LAUNCHES:
        wavefront.SL_LAUNCHES[k] = 0
    wavefront.LAUNCHES["intra"] = 0
    t0 = time.perf_counter()
    results = list(enc.encode_stream(frames * TIMED_BATCHES))
    dt = time.perf_counter() - t0
    launches["cell_intra"] = wavefront.SL_LAUNCHES["intra"]
    if launches["cell_intra"] == 0 or \
            launches["cell_intra"] != wavefront.LAUNCHES["intra"]:
        raise RuntimeError(f"intra-scaling: expected SL launches only, got "
                           f"{wavefront.SL_LAUNCHES} / {wavefront.LAUNCHES}")
    bits, psnr_y = check_output(results, "intra-scaling")
    log("intra-scaling-default-832x480-qp22 encode_stream:", json.dumps(dict(
        frames=len(results), batch=BATCH, fps=len(results) / dt,
        bits_per_frame=bits, psnr_y=psnr_y,
        sl_launches=launches["cell_intra"],
        native_cabac=enc._intra._native_cabac(), stage_wall_s=enc.stats)))
    log("intra-scaling stage split (ms/frame, one batch of 8):",
        json.dumps(stage_split(torch, enc._intra, frames[:BATCH])))
    enc.close()

    cqm, _ = sl_paths()
    cfg = config_from_preset("slower", width=W, height=H, qp=QP,
                             lp_gop=(4, 4, 1), gop_len=0, cqmfile=cqm)
    clip8 = synth_clip_natural(8, W, H, seed=4)
    enc = Encoder(cfg, device=dev)
    results = []
    for res in enc.encode_stream(clip8 * 2):
        results.append(res)
        if len(results) == len(clip8):
            torch.cuda.synchronize()
            for k in wavefront.SL_LAUNCHES:
                wavefront.SL_LAUNCHES[k] = 0
            t0 = time.perf_counter()
    dt = time.perf_counter() - t0
    launches["cell_inter"] = wavefront.SL_LAUNCHES["inter"]
    timed = results[len(clip8):]
    if (launches["cell_inter"] != len(timed)
            or wavefront.SL_LAUNCHES["tq"] != len(timed)
            or any(r[1].slice_type != 1 for r in timed)):
        raise RuntimeError(f"ld-slower-cqm: expected one TQ SL P launch a "
                           f"P frame, got {wavefront.SL_LAUNCHES}")
    bits, psnr_y = check_output(timed, "ld-slower-cqm")
    log("ld-slower-cqm-832x480-qp22 encode_stream:", json.dumps(dict(
        frames=len(results), timed=len(timed), fps=len(timed) / dt,
        bits_per_frame=bits, idr_bits=results[0][1].bits, psnr_y=psnr_y,
        qps=sorted({r[1].qp for r in results}),
        sl_launches=launches["cell_inter"])))
    enc.close()
    log("ld-slower-cqm stage split (ms, one P frame, 1 reference):",
        json.dumps(ld_p_split(torch, cfg, clip8, dev, nref=1)))

    launches.update(sl_streams_card_equals_cpu(wavefront, dev))
    return rows, launches


SMP_WARM, SMP_TIMED = 2, 8            # phase 20: IDR + 1 P, then 8 P
SMP_SMALL = (128, 64)                  # ... the card == CPU streams


def smp_config(width, height, cu=16, **kw):
    """IPPP with SMP inter partitions (2NxN, Nx2N; AMP's four asymmetric
    splits with amp=True at cu 32) on the fixed cu grid, QP 22, one
    reference, deblocking, WPP."""
    from kvazaar_tpu_torch import Config
    return Config(width=width, height=height, qp=QP, intra_period=0,
                  intra_min_cu=cu, intra_max_cu=cu, smp=True, **kw)


def compare_kernel_smp(torch, clip46, dev):
    """Phase 20 (i): the inter variant == plain on the card, max abs
    error 0, on real SMP / AMP P frames at 832x480 (frame 1 searched
    against frame 0's deblocked recon through the SMP branch of the P
    program: its modes, inter map and the MC planes of the PUs' 8x8-cell
    motion field): SMP cu 16, AMP cu 32, and AMP cu 32 with RDOQ and sign
    hiding (the TQ instance), each as the encoder launches it (the joint
    luma + Cb + Cr launch with the frame encoder's tools), timed against
    its plain version, with its bound.  Returns the rows by name."""
    from kvazaar_tpu_torch.encoder.frame_encoder import IntraFrameEncoder
    from kvazaar_tpu_torch.encoder.intra_recon import wavefront_recon_plain
    from kvazaar_tpu_torch.ops.wavefront import wavefront_recon_planes

    rows = {}
    for name, cu, kw in (("smp cu16", 16, {}),
                         ("amp cu32", 32, dict(amp=True)),
                         ("amp cu32 rdoq+sh", 32,
                          dict(amp=True, rdoq=True, signhide=True))):
        ife = IntraFrameEncoder(smp_config(W, H, cu, **kw), device=dev)
        ife.submit_frames([clip46[0]])       # DPB: frame 0, deblocked
        ys, cbs, crs = ife._upload(ife.host_pack_sources([clip46[1]]))
        modes, inter_map, part, _mv_pu, _mv_cells, mcs = \
            ife._p_predict_smp(ys[0], ife._dpb)
        tools = {k: v for k, v in ife._recon_tools().items()
                 if k in ("rdoq", "signhide", "lam")}
        inter = dict(is_inter=inter_map[None], mc_y=mcs[0][None],
                     mc_cb=mcs[1][None], mc_cr=mcs[2][None])

        def launch():
            return wavefront_recon_planes(ys, cbs, crs, modes[None],
                                          ife.plan, QP, ife.qp_c, 8,
                                          **inter, **tools)

        def plain():
            out = []
            for orig, mc, s, luma, qp in (
                    (ys, inter["mc_y"], cu, True, QP),
                    (cbs, inter["mc_cb"], cu // 2, False, ife.qp_c),
                    (crs, inter["mc_cr"], cu // 2, False, ife.qp_c)):
                out.extend(wavefront_recon_plain(
                    orig, modes[None], ife.plan, s, luma, qp, 8,
                    inter["is_inter"], mc, **tools))
            return out

        got = launch()
        err = max_err(torch, got, plain())
        if err != 0:
            raise RuntimeError(f"smp kernel != plain at {name}")
        ins = [ys, cbs, crs, modes, inter_map, *mcs, *got]
        work = [(ys.numel(), cu), (cbs.numel() + crs.numel(), cu // 2)]
        row = dict(shape=f"{name} {W}x{H} P frame", cu=cu,
                   inter_share=inter_map.float().mean().item(),
                   smp_share=(part > 0).float().mean().item(),
                   amp_share=(part >= 4).float().mean().item(),
                   max_abs_err=err, ms=cuda_ms(torch, launch, 20),
                   plain_ms=cuda_ms(torch, plain, 1),
                   n_steps=ife.plan.n_steps)
        if tools.get("rdoq") or tools.get("signhide"):
            row["bound_ms"], row["bound_by"] = bound_ms_tools(
                ins, work, tools["rdoq"], tools["signhide"])
        else:
            row["bound_ms"], row["bound_by"] = bound_ms(ins, work)
        log("smp kernel vs plain:", json.dumps(row))
        rows[name] = row
        ife.close()
    return rows


def smp_streams_card_equals_cpu(wavefront, dev):
    """Phase 20 (ii): card == CPU bytes and recon at 128x64 for SMP cu 16,
    AMP cu 32 with RDOQ and sign hiding, SMP cu 32 with --bitrate (a
    frame encoder per QP: SMP turns per-CTU QP off), TMVP IPPP at cu 16,
    the ultrafast preset with TMVP (lp-g4d4t1) and TMVP with an IDR
    every 3 frames (the collocated motion resets there); the inter
    launches of the SMP cu 16 card run and the TQ inter launches of the
    AMP one counted."""
    from kvazaar_tpu_torch import Config
    from kvazaar_tpu_torch.config import config_from_preset
    w, h = SMP_SMALL
    small = synth_clip_natural(5, w, h, seed=20)
    launches = {}

    def counted(name, cfg, clip, table, key):
        for k in table:
            table[k] = 0
        card_equals_cpu(name, cfg, clip, dev)
        launches[name] = table[key]
        if table[key] == 0:
            raise RuntimeError(f"{name}: no {key} launch ({table})")

    counted(f"smp cu16 {w}x{h}", smp_config(w, h), small[:4],
            wavefront.LAUNCHES, "inter")
    counted(f"amp cu32 rdoq+sh {w}x{h}",
            smp_config(w, h, 32, amp=True, rdoq=True, signhide=True),
            small[:4], wavefront.TOOL_LAUNCHES, "inter")
    card_equals_cpu(f"smp cu32 --bitrate 300000 {w}x{h}",
                    smp_config(w, h, 32, bitrate=300_000), small[:4], dev)
    card_equals_cpu(f"tmvp cu16 {w}x{h}",
                    Config(width=w, height=h, qp=QP, intra_period=0,
                           intra_min_cu=16, intra_max_cu=16, tmvp=True),
                    small[:4], dev)
    card_equals_cpu(f"ultrafast tmvp {w}x{h}",
                    config_from_preset("ultrafast", width=w, height=h,
                                       qp=QP, tmvp=True), small, dev)
    card_equals_cpu(f"tmvp --period 3 {w}x{h}",
                    Config(width=w, height=h, qp=QP, intra_period=3,
                           tmvp=True), small, dev)
    return launches


def run_smp(torch, wavefront, clip46, dev):
    """Phase 20: SMP/AMP inter partitions and TMVP on fixed-grid P
    frames.  The inter variant == plain on real SMP / AMP P frames
    (``compare_kernel_smp``); the cells ``ippp-amp-832x480-qp22`` (cu 32
    IPPP with SMP and AMP, pipelined: IDR + 1 P warm, 8 timed P frames
    of the 46-frame clip) and ``ld-ultrafast-tmvp-832x480-qp22`` (the
    ultrafast preset with TMVP: one warm pass over the 8-frame clip, then
    8 timed P frames), each with its inter launches; and card == CPU
    for six streams (``smp_streams_card_equals_cpu``).  Returns (kernel
    rows, launches per record)."""
    from kvazaar_tpu_torch import Config
    from kvazaar_tpu_torch.config import config_from_preset

    rows = compare_kernel_smp(torch, clip46, dev)
    _res, amp = timed_stream(
        torch, wavefront, "ippp-amp-832x480-qp22",
        Config(width=W, height=H, qp=22, intra_period=0, intra_min_cu=32,
               intra_max_cu=32, smp=True, amp=True),
        clip46[:SMP_WARM + SMP_TIMED], SMP_WARM, dev)
    if not amp["pipelined"]:
        raise RuntimeError("ippp-amp: expected the pipelined path")
    clip8 = synth_clip_natural(8, W, H, seed=4)
    _res, tmvp = timed_stream(
        torch, wavefront, "ld-ultrafast-tmvp-832x480-qp22",
        config_from_preset("ultrafast", width=W, height=H, qp=QP,
                           tmvp=True), clip8 * 2, len(clip8), dev)
    launches = smp_streams_card_equals_cpu(wavefront, dev)
    return rows, {"smp_cu16": launches[f"smp cu16 {SMP_SMALL[0]}x"
                                       f"{SMP_SMALL[1]}"],
                  "amp_cu32": amp["kernel_launches"]["inter"],
                  "amp_tq": launches[f"amp cu32 rdoq+sh {SMP_SMALL[0]}x"
                                     f"{SMP_SMALL[1]}"],
                  "tmvp": tmvp["kernel_launches"]["inter"]}


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

    t_start = t0 = time.perf_counter()
    wavefront.build(verbose=True)
    log(f"kernel build: {time.perf_counter() - t0:.3f} s")

    frames = synth_clip_natural(FRAMES, W, H, seed=0)
    rows = compare_kernel(torch, frames, dev)
    clip46 = synth_clip_natural(IPPP_WARM + IPPP_TIMED, W, H, seed=0)
    inter_rows = compare_kernel_inter(torch, clip46, dev)
    joint_rows = joint_launch(torch, frames, clip46, dev)

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

    log(f"phases 1-6: {time.perf_counter() - t_start:.1f} s")

    def timed(name, fn, *args):
        t_phase = time.perf_counter()
        out = fn(*args)
        log(f"{name}: {time.perf_counter() - t_phase:.1f} s")
        return out

    inter_launches = timed("phase 7", run_ippp, torch, wavefront, clip46,
                           dev)
    timed("phase 8", run_var, torch, wavefront, frames, dev)
    timed("phase 9a", run_superfast, torch, wavefront, frames, dev)
    timed("phase 9b", run_medium_slower, torch, wavefront, frames, dev)
    timed("phase 9c", compare_ops, torch, frames, dev)
    rows32, inter_rows32, joint32, launches32 = timed(
        "phase 10", run_low_delay, torch, wavefront, clip46, dev)
    timed("phase 11", run_var_p, torch, wavefront, clip46, dev)
    timed("phase 12", run_gop, torch, wavefront, clip46, dev)
    qp_rows, qp_launches = timed("phase 13", run_rate_control, torch,
                                 wavefront, clip46, dev)
    rows10, launches10 = timed("phase 14", run_tenbit, torch, wavefront,
                               dev)
    rows_ll, launches_ll = timed("phase 15", run_lossless, torch,
                                 wavefront, dev)
    rows_t, launches_t = timed("phase 16", run_tiles, torch, wavefront, dev)
    rows_q, launches_q = timed("phase 17", run_tools, torch, wavefront,
                               clip46, dev)
    rows_n, launches_n = timed("phase 18", run_nxn, torch, wavefront,
                               clip46, dev)
    rows_s, launches_s = timed("phase 19", run_scaling, torch, wavefront,
                               clip46, dev)
    rows_p, launches_p = timed("phase 20", run_smp, torch, wavefront,
                               clip46, dev)
    log(f"all phases: {time.perf_counter() - t_start:.1f} s")

    # The cell's shape: a P frame at cu 32 with a per-CTU QP map.
    qp_cell = next(r for r in qp_rows if r["cu"] == 32
                   and r["shape"] == f"{W}x{H} 1 P frame")

    def record(name, replaces, n, joint, rs):
        """The main path's joint launch (luma + Cb + Cr at the row's CU
        size); the error over every shape of the variant."""
        return {"name": name, "route": "cuda",
                "source": "kvazaar_tpu_torch/csrc/wavefront.cu",
                "replaces": replaces, "launches": n,
                "max_abs_err": max(r["max_abs_err"] for r in (*rs, joint)),
                "ms": joint["ms"],
                "plain_ms": sum(r["plain_ms"] for r in rs
                                if r["cu"] == joint["cu"]),
                "bound_ms": joint["bound_ms"],
                "bound_by": joint["bound_by"], "library_ms": None}

    def record10(name, replaces, n, row):
        """A 10-bit instance at the shape of the path that runs it; the
        error over every 10-bit row (all are 0 or the phase failed)."""
        return {"name": name, "route": "cuda",
                "source": "kvazaar_tpu_torch/csrc/wavefront.cu",
                "replaces": replaces, "launches": n,
                "max_abs_err": max(r["max_abs_err"] for r in rows10.values()),
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": None}

    def bypass_record(name, replaces, n, row):
        """A bypass instance at the shape of the path that runs it; the
        error over every bypass row (all are 0 or the phase failed)."""
        return {"name": name, "route": "cuda",
                "source": "kvazaar_tpu_torch/csrc/wavefront.cu",
                "replaces": replaces, "launches": n,
                "max_abs_err": max(r["max_abs_err"]
                                   for r in rows_ll.values()),
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": None}

    def tile_record(name, replaces, n, row):
        """The kernel on a tiled plan at the shape of the path that runs
        it; the error over every tiled row (all are 0 or the phase
        failed)."""
        return {"name": name, "route": "cuda",
                "source": "kvazaar_tpu_torch/csrc/wavefront.cu",
                "replaces": replaces, "launches": n,
                "max_abs_err": max(r["max_abs_err"]
                                   for r in rows_t.values()),
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": None}

    def tool_record(name, replaces, n, row):
        """An RDOQ / sign-hiding instance at the shape of the path that
        runs it (its bound with the tools' operations); the error over
        every tools row (all are 0 or the phase failed)."""
        return {"name": name, "route": "cuda",
                "source": "kvazaar_tpu_torch/csrc/wavefront.cu",
                "replaces": replaces, "launches": n,
                "max_abs_err": max(r["max_abs_err"]
                                   for r in rows_q.values()),
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["tools_bound_ms"],
                "bound_by": row["tools_bound_by"], "library_ms": None}

    def nxn_record(name, n, row, part="luma"):
        """A cu 4 instance (part "luma") or the NxN chroma launch of the
        cu 8 instances ("chroma") at the shape of the path that runs it;
        the error over every phase 18 row (all are 0 or the phase
        failed)."""
        return {"name": name, "route": "cuda",
                "source": "kvazaar_tpu_torch/csrc/wavefront.cu",
                "replaces": "kvazaar_tpu/ops/wavefront_pallas.py:149",
                "launches": n,
                "max_abs_err": max(r["max_abs_err"]
                                   for r in rows_n.values()),
                "ms": row[f"ms_{part}"], "plain_ms": row[f"plain_ms_{part}"],
                "bound_ms": row[f"bound_ms_{part}"],
                "bound_by": row[f"bound_by_{part}"], "library_ms": None}

    def sl_record(name, replaces, n, row):
        """A scaling-list instance at the shape of the path that runs it;
        the error over every phase 19 row (all are 0 or the phase
        failed)."""
        return {"name": name, "route": "cuda",
                "source": "kvazaar_tpu_torch/csrc/wavefront.cu",
                "replaces": replaces, "launches": n,
                "max_abs_err": max(r["max_abs_err"]
                                   for r in rows_s.values()),
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": None}

    def smp_record(name, n, row):
        """The inter variant on a real SMP / AMP P frame at the shape of
        the path that runs it; the error over every phase 20 row (all are
        0 or the phase failed)."""
        return {"name": name, "route": "cuda",
                "source": "kvazaar_tpu_torch/csrc/wavefront.cu",
                "replaces": "kvazaar_tpu/ops/wavefront_pallas.py:283",
                "launches": n,
                "max_abs_err": max(r["max_abs_err"]
                                   for r in rows_p.values()),
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": None}

    nxn_rows = f"{W}x{H} {NXN_FRAMES} frames searched"
    big_t = f"{TILE_SHAPES[0][0]}x{TILE_SHAPES[0][1]} 3x3"
    log(json.dumps({"kernels": [
        record("wavefront_recon", "kvazaar_tpu/ops/wavefront_pallas.py:149",
               launches, joint_rows[0], rows),
        record("wavefront_recon_inter",
               "kvazaar_tpu/ops/wavefront_pallas.py:283", inter_launches,
               joint_rows[1], inter_rows),
        record("wavefront_recon_cu32",
               "kvazaar_tpu/ops/wavefront_pallas.py:149",
               launches32["intra"], joint32[0], rows32),
        record("wavefront_recon_inter_cu32",
               "kvazaar_tpu/ops/wavefront_pallas.py:283",
               launches32["inter"], joint32[1], inter_rows32),
        {"name": "wavefront_recon_qpmap", "route": "cuda",
         "source": "kvazaar_tpu_torch/csrc/wavefront.cu",
         "replaces": "kvazaar_tpu/ops/wavefront_pallas.py:283",
         "launches": sum(qp_launches.values()),
         "max_abs_err": max(r["max_abs_err"] for r in qp_rows),
         "ms": qp_cell["ms"], "plain_ms": qp_cell["plain_ms"],
         "bound_ms": qp_cell["bound_ms"], "bound_by": qp_cell["bound_by"],
         "library_ms": None},
        *(record10(name, replaces, launches10[key], rows10[shape])
          for name, replaces, key, shape in (
              ("wavefront_recon_10bit", "kvazaar_tpu/ops/wavefront_pallas.py"
               ":149", "intra", "intra cu16 832x480 8 frames"),
              ("wavefront_recon_cu32_10bit",
               "kvazaar_tpu/ops/wavefront_pallas.py:149", "intra_cu32",
               f"intra cu32 {BIG[1][0]}x{BIG[1][1]} 1 frame"),
              ("wavefront_recon_inter_cu32_10bit",
               "kvazaar_tpu/ops/wavefront_pallas.py:283", "inter_cu32",
               f"inter cu32 {BIG[1][0]}x{BIG[1][1]} 1 frame"),
              ("wavefront_recon_qpmap_10bit",
               "kvazaar_tpu/ops/wavefront_pallas.py:283", "qp_map",
               "qp-map cu32 832x480 P frame"))),
        *(bypass_record(name, replaces, launches_ll[key], rows_ll[shape])
          for name, replaces, key, shape in (
              ("wavefront_recon_bypass",
               "kvazaar_tpu/ops/wavefront_pallas.py:149", "cu16",
               "intra cu16 832x480 8 frames rdpcm=False"),
              ("wavefront_recon_bypass_cu32",
               "kvazaar_tpu/ops/wavefront_pallas.py:149", "cu32",
               "intra cu32 832x480 2 frames rdpcm=False"),
              ("wavefront_recon_bypass_inter",
               "kvazaar_tpu/ops/wavefront_pallas.py:283", "inter",
               "inter cu16 832x480 P frame rdpcm=True"),
              ("wavefront_recon_bypass_10bit",
               "kvazaar_tpu/ops/wavefront_pallas.py:149", "tenbit",
               "10-bit intra cu16 832x480 8 frames"))),
        *(tile_record(name, replaces, launches_t[key], rows_t[shape])
          for name, replaces, key, shape in (
              ("wavefront_recon_tiles",
               "kvazaar_tpu/ops/wavefront_pallas.py:149", "intra",
               f"intra cu16 {big_t} 8-bit {TILE_INTRA_TIMED} frames"),
              ("wavefront_recon_tiles_cu32",
               "kvazaar_tpu/ops/wavefront_pallas.py:149", "p_intra",
               f"intra cu32 {big_t} 8-bit 1 frames"),
              ("wavefront_recon_inter_tiles_cu32",
               "kvazaar_tpu/ops/wavefront_pallas.py:283", "p_inter",
               f"inter cu32 {big_t} 8-bit"))),
        *(tool_record(name, replaces, launches_q[key], rows_q[shape])
          for name, replaces, key, shape in (
              ("wavefront_recon_rdoq_sh_cmodes",
               "kvazaar_tpu/ops/wavefront_pallas.py:149", "intra",
               f"intra cu16 {W}x{H} {TOOL_FRAMES} frames rdoq+sh+cmodes"),
              ("wavefront_recon_inter_rdoq_sh_cu32",
               "kvazaar_tpu/ops/wavefront_pallas.py:283", "inter",
               f"inter cu32 {W}x{H} P frame rdoq+sh"),
              ("wavefront_recon_rdoq_qpmap_cu32",
               "kvazaar_tpu/ops/wavefront_pallas.py:283", "qp_map",
               f"inter cu32 {W}x{H} P frame rdoq+qpmap"),
              ("wavefront_recon_rdoq_sh_10bit",
               "kvazaar_tpu/ops/wavefront_pallas.py:283", "10bit",
               f"inter cu32 {W}x{H} 10-bit rdoq+sh"),
              ("wavefront_recon_rdoq_sh_tiles",
               "kvazaar_tpu/ops/wavefront_pallas.py:283", "tiled",
               f"inter cu32 {big_t} rdoq+sh"))),
        nxn_record("wavefront_recon_nxn_tskip", launches_n["cell_luma"],
                   rows_n[f"{nxn_rows} tskip"]),
        nxn_record("wavefront_recon_nxn_chroma", launches_n["cell_chroma"],
                   rows_n[f"{nxn_rows} tskip"], "chroma"),
        nxn_record("wavefront_recon_nxn_rdoq_sh", launches_n["cu4_tq"],
                   rows_n[f"{nxn_rows} rdoq+sh"]),
        nxn_record("wavefront_recon_nxn_bypass", launches_n["cu4_lossless"],
                   rows_n[f"{nxn_rows} lossless"]),
        nxn_record("wavefront_recon_nxn_10bit", launches_n["cu4_10bit"],
                   rows_n[f"{W}x{H} 10-bit 2 frames tskip"]),
        *(sl_record(name, replaces, launches_s[key], rows_s[shape])
          for name, replaces, key, shape in (
              ("wavefront_recon_sl", "kvazaar_tpu/ops/wavefront_pallas.py"
               ":149", "cell_intra",
               f"intra cu16 {W}x{H} {SL_FRAMES} frames default"),
              ("wavefront_recon_inter_sl_rdoq_sh_cu32",
               "kvazaar_tpu/ops/wavefront_pallas.py:283", "cell_inter",
               f"inter cu32 {W}x{H} P frame custom+rdoq+sh"),
              ("wavefront_recon_sl_10bit",
               "kvazaar_tpu/ops/wavefront_pallas.py:149", "10bit",
               f"intra cu16 {W}x{H} 10-bit custom+rdoq+sh"),
              ("wavefront_recon_sl_tiles",
               "kvazaar_tpu/ops/wavefront_pallas.py:283", "tiled",
               f"inter cu32 {SL_TILES[0]}x{SL_TILES[1]} 3x3 custom+rdoq+sh"),
              ("wavefront_recon_sl_nxn",
               "kvazaar_tpu/ops/wavefront_pallas.py:149", "cu4",
               f"cu4 {W}x{H} 2 frames + chroma nxn"))),
        *(smp_record(name, launches_p[key], rows_p[shape])
          for name, key, shape in (
              ("wavefront_recon_inter_smp_cu16", "smp_cu16", "smp cu16"),
              ("wavefront_recon_inter_amp_cu32", "amp_cu32", "amp cu32"),
              ("wavefront_recon_inter_amp_rdoq_sh_cu32", "amp_tq",
               "amp cu32 rdoq+sh")))]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
