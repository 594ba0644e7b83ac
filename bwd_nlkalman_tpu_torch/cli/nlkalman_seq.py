"""nlkalman-seq equivalent: denoise a whole frame sequence.

Mirrors scripts/nlkalman-seq.sh (and with --gt-pattern, the noise+PSNR
harness of nlkalman-seq-gt.sh): reads pattern%first..%last, runs
``NLKalmanDenoiser`` on ``--device`` (default ``cuda``), writes
flt1-/flt2-/smo1-%03d.tif into the output folder plus a `measures` file
when ground truth is given. ``--fscale 0`` (or an ``--opm`` string whose
first field is 0) computes the flow at full resolution. ``--smoother
fsmo|lsmo`` runs the causal smoothers, ``--multiscale`` the multiscale
pipeline (``MultiscaleDenoiser``, ``--pyramid dct|lz3``).

Run as ``python -m bwd_nlkalman_tpu_torch.cli.nlkalman_seq``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ._common import device_arg
from ..io import read_video, write_image
from ..pipeline import (FlowConfig, MultiscaleDenoiser, NLKalmanDenoiser,
                        add_noise_sequence, gt_measures, sequence_psnr)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="nlkalman-seq", description=__doc__)
    ap.add_argument("sequence", help="printf frame pattern, e.g. frames/%%03d.png")
    ap.add_argument("first", type=int)
    ap.add_argument("last", type=int)
    ap.add_argument("sigma", type=float)
    ap.add_argument("output", help="output folder")
    ap.add_argument("--no-smoothing", action="store_true",
                    help='SPM=="no" mode (filtering only)')
    ap.add_argument("--smoother", choices=["rts", "fsmo", "lsmo", "none"],
                    default="rts",
                    help="smoothing variant: rts = full backward pass "
                    "(nlkalman-seq.sh), fsmo = causal forward smoothing "
                    "(nlkalman-fsmo-seq.sh), lsmo = lag-1 smoother "
                    "(nlkalman-lsmo-seq.sh), none = filtering only")
    ap.add_argument("--multiscale", action="store_true",
                    help="msnlkalman multiscale pipeline")
    ap.add_argument("--pyramid", choices=["dct", "lz3"], default="dct",
                    help="multiscale pyramid: dct (msnlkalman-seq.sh) or "
                    "lz3 Lanczos-3 (msnlkalman-lz3-seq.sh)")
    ap.add_argument("--levels", type=int, default=None, help="pyramid levels")
    ap.add_argument("--gt-pattern", default=None,
                    help="clean frame pattern: add noise here, report PSNR")
    ap.add_argument("--png-archive", action="store_true",
                    help="also write png copies of all outputs (the gt "
                    "harness's iion tif->png step, "
                    "scripts/nlkalman-seq-gt.sh:123-129)")
    ap.add_argument("--seed", type=int, default=0, help="noise seed base (with --gt-pattern)")
    ap.add_argument("--fscale", type=int, default=1)
    ap.add_argument("--flow-lambda", type=float, default=0.25)
    ap.add_argument("--occ-threshold", type=float, default=0.75)
    ap.add_argument("--opm", default=None, metavar='"F DW TH [F DW TH]"',
                    help="packed flow-parameter string like the script's "
                    "OPM positional (scripts/nlkalman-seq.sh:12): fscale, "
                    "data weight, occlusion threshold for the filtering "
                    "direction, optionally followed by the smoothing "
                    "direction's triple; overrides the individual flags")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    smoother = "none" if args.no_smoothing else args.smoother
    cfg = FlowConfig(fscale=args.fscale, lambda_=args.flow_lambda,
                     occ_threshold=args.occ_threshold)
    scfg = None
    if args.opm:
        o = args.opm.split()
        if len(o) not in (3, 6):
            ap.error("--opm takes 3 or 6 numbers (fscale dw th [x2])")
        cfg = FlowConfig(fscale=int(o[0]), lambda_=float(o[1]),
                         occ_threshold=float(o[2]))
        if len(o) == 6:
            scfg = FlowConfig(fscale=int(o[3]), lambda_=float(o[4]),
                              occ_threshold=float(o[5]))
    dev = device_arg(args.device)

    os.makedirs(args.output, exist_ok=True)
    t = args.last - args.first + 1
    clean = None
    if args.gt_pattern:
        clean = read_video(args.gt_pattern, args.first, args.last)
        noisy = add_noise_sequence(clean, args.sigma,
                                   seeds=[args.seed + i for i in range(t)])
        for i in range(t):
            write_image(os.path.join(args.output, f"nisy-{args.first+i:03d}.tif"), noisy[i])
    else:
        noisy = read_video(args.sequence, args.first, args.last)

    h, w = noisy.shape[1:3]
    if args.multiscale:
        model = MultiscaleDenoiser(args.sigma, h, w, levels=args.levels,
                                   pyramid=args.pyramid,
                                   smoothing=smoother != "none", device=dev)
    else:
        # fsmo smooths along the filter's flow, so it ignores the
        # smoothing direction's OPM triple, as the JAX command does
        model = NLKalmanDenoiser(args.sigma, h, w, cfg, device=dev,
                                 smooth_flow_cfg=scfg, smoother=smoother)
    flt1, flt2, smo1 = model(torch.from_numpy(noisy).to(dev))

    stacks = {"flt1": flt1.cpu().numpy(), "flt2": flt2.cpu().numpy()}
    if smo1 is not None:
        stacks["smo1"] = smo1.cpu().numpy()
    for name, stack in stacks.items():
        for i in range(t):
            write_image(
                os.path.join(args.output, f"{name}-{args.first+i:03d}.tif"), stack[i]
            )
            if args.png_archive:
                write_image(
                    os.path.join(args.output, f"{name}-{args.first+i:03d}.png"),
                    np.clip(stack[i], 0, 255),
                )

    if clean is not None:
        text = gt_measures(clean, stacks)
        with open(os.path.join(args.output, "measures"), "w") as f:
            f.write(text)
        parts = [f"noisy {sequence_psnr(clean, noisy)['psnr']:.2f}"]
        parts += [f"{k} {sequence_psnr(clean, v)['psnr']:.2f}" for k, v in stacks.items()]
        print("PSNR(dB): " + "  ".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
