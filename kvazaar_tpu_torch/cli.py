"""Command-line front end of the port (counterpart of kvazaar_tpu/cli.py).

Usage:
    python -m kvazaar_tpu_torch -i in.yuv --input-res 832x480 \
        -o out.hevc -q 22 --period 0 [--device cuda] [--frames N]

Takes a copy of the JAX package's argument parser and its
flag-to-config mapping, plus ``--device``.  The structure follows the
preset unless ``--period``/``--gop`` say otherwise, as in the JAX CLI:
``--period 1`` is all-intra, ``--period 0`` IPPP after one IDR and
``--period N`` an IDR every N frames; with no flags the ultrafast
preset's low-delay GOP structure.  Configs the port does not cover
raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import sys
import time

from kvazaar_tpu_torch.config import Config, config_from_preset
from kvazaar_tpu_torch.io.yuv import read_frames_async, write_frame


def _base_argparser() -> argparse.ArgumentParser:
    """The JAX package's parser (kvazaar_tpu/cli.py build_argparser),
    copied verbatim."""
    ap = argparse.ArgumentParser(prog="kvazaar_tpu")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("--input-res", required=True,
                    help="WxH of the raw input")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-q", "--qp", type=int, default=22)
    ap.add_argument("-n", "--frames", type=int, default=None)
    ap.add_argument("--seek", type=int, default=0,
                    help="skip the first N input frames "
                         "(yuv_io_seek, src/yuv_io.c:256)")
    ap.add_argument("--preset", default="ultrafast")
    ap.add_argument("--input-bitdepth", type=int, default=None,
                    help="bit depth of the input FILE (converted to "
                         "the coding bit depth on read)")
    ap.add_argument("--bitdepth", type=int, default=8,
                    choices=[8, 10], help="coding bit depth")
    ap.add_argument("--msb-first", action="store_true",
                    help=">8-bit input is big-endian")
    ap.add_argument("--input-format", default="P420",
                    choices=["P400", "P420"])
    ap.add_argument("--source-scan-type", default="progressive",
                    choices=["progressive", "tff", "bff"],
                    help="interlaced input: encode as field pictures")
    ap.add_argument("--input-fps", default=None,
                    help="framerate as float or num/denom")
    ap.add_argument("-p", "--period", type=int, default=None,
                    help="intra period: 1=all-intra, N=IDR every N, "
                         "0=first frame only (default: the preset's "
                         "structure, else all-intra)")
    ap.add_argument("--gop", default=None,
                    help="GOP structure: 0 (IPPP), 4/8 (B pyramid), "
                         "or lp-g#d#t# low-delay (src/cfg.c:885); "
                         "default: the preset's structure")
    ap.add_argument("--bitrate", type=int, default=0,
                    help="target bits/s (0 = fixed QP)")
    ap.add_argument("--no-lcu-rc", action="store_true",
                    help="disable per-CTU bit allocation under "
                         "--bitrate (frame-level RC only)")
    ap.add_argument("--roi", default=None,
                    help="delta-QP ROI map file: 'W H' then W*H "
                         "offsets on a CTU grid")
    ap.add_argument("--aq", type=float, default=None,
                    help="variance adaptive-quantization strength "
                         "(0..3)")
    ap.add_argument("--ref", type=int, default=None,
                    help="reference frames per list")
    ap.add_argument("--rd", type=int, default=None)
    ap.add_argument("--tr-depth-intra", type=int, default=None,
                    help="intra TU-split search depth (0/1)")
    ap.add_argument("--me-range", type=int, default=None)
    ap.add_argument("--subme", type=int, default=None,
                    help="0 = integer-pel only, >0 = half+quarter")
    ap.add_argument("--me", default=None,
                    help="integer search algorithm name (informative: "
                         "the dense exhaustive search covers every "
                         "pattern search)")
    ap.add_argument("--bipred", type=int, default=None,
                    help="bi-prediction in B slices (0/1)")
    ap.add_argument("--smp", action="store_true",
                    help="enable 2NxN/Nx2N inter partitions")
    ap.add_argument("--amp", action="store_true",
                    help="enable asymmetric inter partitions "
                         "(implies --smp; 32x32 CUs)")
    ap.add_argument("--crypto", default=None, metavar="KEY",
                    help="selective encryption: AES-CTR keystream over "
                         "sign bins (hex key or passphrase)")
    ap.add_argument("--tiles", default=None, metavar="WxH",
                    help="uniform tile grid, e.g. 3x3; combines with "
                         "WPP (one substream per CTU row per tile)")
    ap.add_argument("--no-wpp", action="store_true")
    ap.add_argument("--slices", default=None,
                    choices=["wpp", "tiles"],
                    help="wpp: each CTU row a dependent slice "
                         "segment; tiles: independent slice per tile")
    ap.add_argument("--sao", action="store_true", default=None)
    ap.add_argument("--no-sao", dest="sao", action="store_false")
    ap.add_argument("--rdoq", action="store_true", default=None)
    ap.add_argument("--no-rdoq", dest="rdoq", action="store_false")
    ap.add_argument("--signhide", action="store_true", default=None)
    ap.add_argument("--no-signhide", dest="signhide",
                    action="store_false")
    ap.add_argument("--no-deblock", action="store_true")
    ap.add_argument("--lossless", action="store_true")
    ap.add_argument("--sar", default=None, metavar="W:H")
    ap.add_argument("--aud", action="store_true")
    ap.add_argument("--no-info", action="store_true")
    ap.add_argument("--cqmfile", default=None,
                    help="custom quant matrices (HM format)")
    ap.add_argument("--scaling-list", default=None,
                    choices=["off", "default", "custom"])
    ap.add_argument("--hash", default="none",
                    choices=["none", "md5", "checksum"],
                    help="decoded-picture-hash SEI per frame")
    ap.add_argument("--debug", default=None,
                    help="write reconstruction YUV for comparison "
                         "(reference --debug)")
    ap.add_argument("--no-psnr", action="store_true")
    ap.add_argument("--level", default=None,
                    help="force/validate the signalled level, e.g. 4.1")
    ap.add_argument("--high-tier", action="store_true",
                    help="signal high tier (levels 4+)")
    ap.add_argument("--threads", type=int, default=0,
                    help="host CABAC pool size (0 = auto)")
    ap.add_argument("--owf", type=int, default=0,
                    help="frame pipeline depth (0 = auto)")
    ap.add_argument("--stats", action="store_true",
                    help="print per-stage timing at the end")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a JAX device-profiler trace (XPlane) "
                         "under DIR for xprof/TensorBoard")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="set any config option by name (the string-"
                         "keyed parser of the reference's "
                         "kvz_config_parse, src/cfg.c:358); e.g. "
                         "--set intra-max-cu=4 --set sao=1")
    return ap


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
        if args.stats and enc.stats:
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
