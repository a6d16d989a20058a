"""Command-line front end of the port (counterpart of kvazaar_tpu/cli.py).

Usage:
    python -m kvazaar_tpu_torch -i in.yuv --input-res 832x480 \
        -o out.hevc -q 22 --period 1 [--device cuda] [--frames N]

Takes the JAX package's argument parser and flag-to-config mapping
(jax-free) plus ``--device``.  The structure follows the preset unless
``--period``/``--gop`` say otherwise, as in the JAX CLI, so the port
needs ``--period 1``; configs outside its all-intra fixed-grid slice
raise NotImplementedError.
"""

from __future__ import annotations

import sys
import time

from kvazaar_tpu.cli import build_argparser as _base_argparser
from kvazaar_tpu.config import Config, config_from_preset
from kvazaar_tpu.io.yuv import read_frames_async, write_frame


def build_argparser():
    ap = _base_argparser()
    ap.prog = "kvazaar_tpu_torch"
    ap.add_argument("--device", default="cuda",
                    help="torch device the encoder runs on "
                         "(default: cuda)")
    return ap


def config_from_args(args) -> Config:
    """The Config the JAX package's CLI builds from the same flags
    (kvazaar_tpu/cli.py main), so that a flag the port does not cover
    reaches the encoder and raises there instead of being dropped."""
    w, h = (int(v) for v in args.input_res.split("x"))
    cfg = config_from_preset(args.preset, width=w, height=h, qp=args.qp,
                             input_bitdepth=args.bitdepth,
                             bitrate=args.bitrate,
                             hash=args.hash,
                             chroma_format=420
                             if args.input_format == "P420" else 400)
    if args.gop is not None:
        cfg.set("gop", args.gop)
    if args.period is not None:
        cfg.intra_period = args.period
    if args.input_fps:
        if "/" in args.input_fps:
            num, den = args.input_fps.split("/")
            cfg.framerate_num, cfg.framerate_denom = int(num), int(den)
        else:
            cfg.framerate_num = int(round(float(args.input_fps) * 1000))
            cfg.framerate_denom = 1000
    if args.sar:
        sw, _, sh = args.sar.partition(":")
        cfg.sar_width, cfg.sar_height = int(sw), int(sh)
    if args.no_lcu_rc:
        cfg.lcu_rc = False
    if args.slices:
        cfg.slices = args.slices
    if args.source_scan_type != "progressive":
        cfg.set("source_scan_type", args.source_scan_type)
    if args.level:
        cfg.level = args.level
    if args.high_tier:
        cfg.tier = "high"
    cfg.threads = args.threads
    cfg.owf = args.owf
    for name, key in (("ref", "ref_frames"), ("rd", "rd"),
                      ("tr_depth_intra", "tr_depth_intra"),
                      ("me_range", "me_range"), ("sao", "sao"),
                      ("rdoq", "rdoq"), ("signhide", "signhide"),
                      ("cqmfile", "cqmfile"), ("roi", "roi"),
                      ("aq", "aq"),
                      ("scaling_list", "scaling_list")):
        v = getattr(args, name)
        if v is not None:
            setattr(cfg, key, v)
    if args.subme is not None:
        cfg.me_subpel = args.subme > 0
    if args.smp:
        cfg.smp = True
    if args.amp:
        cfg.smp = True
        cfg.amp = True
    if args.crypto:
        cfg.crypto = args.crypto
    if args.me:
        cfg.me = args.me
    if args.bipred is not None:
        cfg.bipred = bool(args.bipred)
    if args.no_wpp:
        cfg.wpp = False
    if args.no_deblock:
        cfg.deblock = False
    if args.lossless:
        cfg.lossless = True
    if args.aud:
        cfg.aud = True
    if args.no_info:
        cfg.info = False
    if args.tiles:
        cfg.set("tiles", args.tiles)
    for kv in args.set:
        key, _, value = kv.partition("=")
        cfg.set(key, value)
    return cfg


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.trace:
        raise NotImplementedError("--trace (a device profiler trace) is "
                                  "not ported")
    cfg = config_from_args(args)
    w, h = cfg.width, cfg.height
    from kvazaar_tpu_torch.api import Encoder
    enc = Encoder(cfg, device=args.device)

    t0 = time.time()
    n = 0
    total_bits = 0
    psnr_acc = [0.0, 0.0, 0.0]
    dbg = open(args.debug, "wb") if args.debug else None
    try:
        with open(args.output, "wb") as out:
            src = read_frames_async(
                args.input, w, h, cfg.input_bitdepth,
                cfg.chroma_format == 420, args.frames, skip=args.seek,
                file_bitdepth=args.input_bitdepth,
                big_endian=args.msb_first)
            for chunks, info, rec in enc.encode_stream(
                    src, need_recon=dbg is not None):
                out.write(chunks)
                total_bits += info.bits
                psnr_acc[0] += info.psnr_y
                psnr_acc[1] += info.psnr_u
                psnr_acc[2] += info.psnr_v
                if dbg:
                    write_frame(dbg, rec[0], rec[1], rec[2],
                                cfg.input_bitdepth)
                if not args.no_psnr:
                    print(f"POC {info.poc} QP {info.qp} "
                          f"({total_bits // 8} bytes total) "
                          f"PSNR Y {info.psnr_y:.4f} U {info.psnr_u:.4f} "
                          f"V {info.psnr_v:.4f}", file=sys.stderr)
                n += 1
    finally:
        if dbg:
            dbg.close()
    dt = time.time() - t0
    if n:
        print(f" Processed {n} frames, {total_bits} bits "
              f"AVG PSNR Y {psnr_acc[0] / n:.4f} U {psnr_acc[1] / n:.4f} "
              f"V {psnr_acc[2] / n:.4f}", file=sys.stderr)
        print(f" Total time: {dt:.3f} s, FPS: {n / dt:.2f}",
              file=sys.stderr)
        if args.stats:
            s = enc.stats
            fr = max(s.get("frames", 0), 1)
            print(f" Stages (ms/frame): submit "
                  f"{1000 * s['submit_s'] / fr:.1f}  download "
                  f"{1000 * s['download_s'] / fr:.1f}  finalize "
                  f"{1000 * s['finalize_s'] / fr:.1f}  "
                  f"(pipelined: stages overlap)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
