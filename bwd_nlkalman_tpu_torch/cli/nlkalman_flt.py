"""nlkalman-flt equivalent: filter ONE frame (two cascaded passes).

Flags mirror src/main-flt.c:71-117, as the JAX package's command has
them; a -1 value means "auto" (resolved from sigma like
nlkalman_default_params), and ``--f1_p 0`` / ``--f2_p 0`` skip a pass.
The previous outputs ``--flt10`` / ``--flt20`` are warped along the
backward flow ``-o`` with the occlusion mask ``-k`` (K4 on the card).
Each pass runs K1 where it takes the pass's parameters and the plain
pass otherwise (``core.nlkalman.k1_supported``, with a warning naming
the reason), plus ``--device`` (default ``cuda``).

Run as ``python -m bwd_nlkalman_tpu_torch.cli.nlkalman_flt -i noisy.tif
-s 20 --flt21 out.tif [...]``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ._common import (add_prms_group, check_size, device_arg, print_verbose_params,
                      prms_from_args)
from ..core import nlkalman_filter_frame
from ..io import read_image, write_image
from ..ops.color import opp2rgb, rgb2opp
from ..ops.warp import warp_bicubic_nan
from ..params import FilterMode, default_params


def main(argv=None):
    ap = argparse.ArgumentParser(prog="nlkalman-flt", description=__doc__)
    io = ap.add_argument_group("Data i/o options")
    io.add_argument("-i", "--nisy", required=True, help="input noisy frame path")
    io.add_argument("-o", "--bflo", default=None, help="input bwd flow path")
    io.add_argument("-k", "--bocc", default=None, help="input bwd occlusion mask path")
    io.add_argument("--flt10", default=None, help="input previous first filtering path")
    io.add_argument("--flt20", default=None, help="input previous second filtering path")
    io.add_argument("--flt11", default=None, help="input/output first filtering path")
    io.add_argument("--flt21", default=None, help="output second filtering path")
    io.add_argument("-s", "--sigma", type=float, required=True, help="noise standard dev")
    add_prms_group(ap, "f1", "First filtering options")
    add_prms_group(ap, "f2", "Second filtering options")
    ap.add_argument("-v", "--verbose", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = device_arg(args.device)

    apply_f1 = args.f1_p != 0
    apply_f2 = args.f2_p != 0
    p1 = default_params(args.sigma, FilterMode.FLT1, prms_from_args(args, "f1"))
    p2 = default_params(args.sigma, FilterMode.FLT2, prms_from_args(args, "f2"))

    if args.verbose:
        io_in = {
            "noise": f"{args.sigma:05.2f}",
            "noisy frames": args.nisy,
            "bwd flows": args.bflo,
            "bwd occlus.": args.bocc,
            "prev filt 1": args.flt10,
            "prev filt 2": args.flt20,
        }
        if not apply_f1:
            io_in["filtering 1"] = args.flt11
        io_out = {}
        if apply_f1:
            io_out["filtering 1"] = args.flt11
        io_out["filtering 2"] = args.flt21
        groups = {}
        if apply_f1:
            groups["first filtering parameters"] = p1
        if apply_f2:
            groups["second filtering parameters"] = p2
        print_verbose_params(io_in, io_out, groups)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    nisy_np = read_image(args.nisy)
    bflo = bocc = None
    if args.bflo:
        bflo_np = read_image(args.bflo)
        check_size("flow", bflo_np, nisy_np, "noisy frame", channels=2)
        bflo = tensor(bflo_np)
    if args.bocc:
        bocc_np = read_image(args.bocc)
        check_size("occlusion mask", bocc_np, nisy_np, "noisy frame",
                   channels="any")
        bocc = tensor(bocc_np[..., 0] if bocc_np.ndim == 3 else bocc_np)
    n_opp = rgb2opp(tensor(nisy_np))

    def load_warp(path):
        if path is None or bflo is None:
            return None, None
        img_np = read_image(path)
        check_size(path, img_np, nisy_np, "noisy frame")
        return warp_bicubic_nan(rgb2opp(tensor(img_np)), bflo, bocc)

    flt11 = None
    if apply_f1:
        w0, v0 = load_warp(args.flt10)
        flt11 = nlkalman_filter_frame(n_opp, w0, v0, None, args.sigma, p1)
    elif args.flt11:
        flt11 = rgb2opp(tensor(read_image(args.flt11)))

    if apply_f2:
        w0, v0 = load_warp(args.flt20)
        flt21 = nlkalman_filter_frame(n_opp, w0, v0, flt11, args.sigma, p2)
        if args.flt21:
            write_image(args.flt21, opp2rgb(flt21).cpu().numpy())

    if apply_f1 and args.flt11:
        write_image(args.flt11, opp2rgb(flt11).cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
