"""Times the wavefront kernel's untiled launches on one GPU at the
shapes of PERF.md §6, for this checkout or another one.

    python3 chip_kernel_times.py [--repo DIR] [--tag NAME]

DIR is the root of a checkout of the repository (default: this
script's).  To compare two kernels on one card, unpack the other commit
under build/ (``git archive <commit> | tar -x -C build/parent``) and run
both in one call, in turns: parent, change, change, parent.  Each run
builds its checkout's kernel, then prints one line ``kernel times:``
with a JSON object: the card's name, the tag and the mean time in ms of
20 joint launches (luma + Cb + Cr, CUDA events) for the all-intra
batch of 8 frames at cu 16 and cu 32, one P frame at cu 16 and cu 32,
and the 10-bit all-intra batch at cu 16, all at 832x480 on
``chip_smoke.py``'s seeded clip.  With ``--cells N`` it then times
the headline cell and its 10-bit twin (832x480 QP 22 all-intra, cu 16,
batches of 8) through ``Encoder.encode_stream``: one warm-up batch, then
N runs of ``chip_smoke.py``'s timed batches each, and prints one line
``cell times:`` with each run's fps, host stage seconds
(``Encoder.stats``) and the CPU seconds of the process's threads.  Without a CUDA device it exits nonzero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--tag", default="")
    ap.add_argument("--cells", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_kernel_times: no CUDA device is available",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    import chip_smoke as cs
    from kvazaar_tpu_torch.encoder.frame_encoder import IntraFrameEncoder
    from kvazaar_tpu_torch.encoder.intra_search import search_frame_modes
    from kvazaar_tpu_torch.ops import wavefront
    from kvazaar_tpu_torch.ops.wavefront import wavefront_recon_planes

    wavefront.build()
    w, h = cs.W, cs.H
    frames = cs.synth_clip_natural(cs.FRAMES, w, h, seed=0)
    clip = cs.synth_clip_natural(2, w, h, seed=0)
    cases = {}
    for cu in (16, 32):
        ife = IntraFrameEncoder(cs.headline_config(w, h, cu), device="cuda")
        planes = ife._upload(ife.host_pack_sources(frames))
        modes = torch.stack([search_frame_modes(y, ife.plan,
                                                ife.lambda_satd)[0]
                             for y in planes[0]])
        cases[f"intra cu{cu} 8 frames"] = (
            planes, modes, ife.plan, ife.qp_c, 8, {})
        ifp, (ys, cbs, crs), m, im, mcs = cs.p_frame_inputs(torch, clip, cu,
                                                            "cuda")
        cases[f"inter cu{cu} P frame"] = (
            (ys, cbs, crs), m[None], ifp.plan, ifp.qp_c, 8,
            dict(is_inter=im[None], mc_y=mcs[0][None], mc_cb=mcs[1][None],
                 mc_cr=mcs[2][None]))
    ife = IntraFrameEncoder(cs.tenbit_config(w, h), device="cuda")
    p10 = ife._upload(ife.host_pack_sources(cs.to_10bit(frames, 140)))
    modes = torch.stack([search_frame_modes(y, ife.plan, ife.lambda_satd,
                                            10)[0] for y in p10[0]])
    cases["10-bit intra cu16 8 frames"] = (
        tuple(p.to(torch.int16) for p in p10), modes, ife.plan, ife.qp_c,
        10, {})
    out = {"device": torch.cuda.get_device_name(0), "tag": args.tag}
    for name, (planes, modes, plan, qp_c, bd, kw) in cases.items():
        def launch():
            return wavefront_recon_planes(*planes, modes, plan, cs.QP, qp_c,
                                          bd, **kw)

        launch()
        out[name] = cs.cuda_ms(torch, launch, 20)
    print("kernel times:", json.dumps(out), flush=True)
    if args.cells:
        print("cell times:", json.dumps(cell_times(torch, cs, frames,
                                                   args.cells, args.tag)),
              flush=True)
    return 0


def cell_times(torch, cs, frames, runs, tag):
    """fps, host stage seconds and process CPU seconds of ``runs`` timed
    passes of the headline cell and its 10-bit twin through
    ``Encoder.encode_stream``."""
    import time
    from kvazaar_tpu_torch.api import Encoder
    out = {"device": torch.cuda.get_device_name(0), "tag": tag}
    for name, cfg, clip in (
            ("headline", cs.headline_config(cs.W, cs.H), frames),
            ("intra-10bit", cs.tenbit_config(cs.W, cs.H),
             cs.to_10bit(frames, 140))):
        enc = Encoder(cfg, device="cuda")
        list(enc.encode_stream(clip[:cs.BATCH]))
        torch.cuda.synchronize()
        fps, stages, cpu = [], [], []
        for _ in range(runs):
            c0, t0 = time.process_time(), time.perf_counter()
            n = len(list(enc.encode_stream(clip * cs.TIMED_BATCHES)))
            fps.append(n / (time.perf_counter() - t0))
            cpu.append(time.process_time() - c0)
            stages.append(dict(enc.stats))
        enc.close()
        out[name] = {"fps": fps, "stage_wall_s": stages, "cpu_s": cpu}
    return out


if __name__ == "__main__":
    sys.exit(main())
