"""nlkalman-smo equivalent: RTS-smooth ONE frame (src/main-smo.c), with
the JAX package's flags plus ``--device`` (default ``cuda``). The
smoothed frame t+1 ``--smo0`` is warped along the forward flow ``-o``
with the occlusion mask ``-k`` (K4 on the card); the pass runs K1 where
it takes the pass's parameters and the plain pass otherwise
(``core.nlkalman.k1_supported``).

Run as ``python -m bwd_nlkalman_tpu_torch.cli.nlkalman_smo --flt1 f.tif
--smo0 s.tif --smo1 out.tif -s 20 [...]``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ._common import (add_prms_group, check_size, device_arg, print_verbose_params,
                      prms_from_args)
from ..core import nlkalman_smooth_frame
from ..io import read_image, write_image
from ..ops.color import opp2rgb, rgb2opp
from ..ops.warp import warp_bicubic_nan
from ..params import FilterMode, default_params


def main(argv=None):
    ap = argparse.ArgumentParser(prog="nlkalman-smo", description=__doc__)
    io = ap.add_argument_group("Data i/o options")
    io.add_argument("--flt1", required=True, help="input filtered frame t")
    io.add_argument("--smo0", required=True, help="input smoothed frame t+1")
    io.add_argument("-o", "--fflo", default=None, help="input fwd flow path")
    io.add_argument("-k", "--focc", default=None, help="input fwd occlusion mask path")
    io.add_argument("--smo1", required=True, help="output smoothed frame t")
    io.add_argument("-s", "--sigma", type=float, required=True, help="noise standard dev")
    add_prms_group(ap, "s1", "Smoothing options")
    ap.add_argument("-v", "--verbose", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    dev = device_arg(args.device)

    ps = default_params(args.sigma, FilterMode.SMO1, prms_from_args(args, "s1"))
    if args.verbose:
        print_verbose_params(
            {
                "noise": f"{args.sigma:05.2f}",
                "filtered t": args.flt1,
                "smoothed t+1": args.smo0,
                "fwd flows": args.fflo,
                "fwd occlus.": args.focc,
            },
            {"smoothed t": args.smo1},
            {"smoothing parameters": ps},
        )

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    flt1_np = read_image(args.flt1)
    smo0_np = read_image(args.smo0)
    check_size("smoothed frame t+1", smo0_np, flt1_np, "filtered frame")
    flt1 = rgb2opp(tensor(flt1_np))
    smo0 = rgb2opp(tensor(smo0_np))
    valid = None
    if args.fflo:
        fflo_np = read_image(args.fflo)
        check_size("flow", fflo_np, flt1_np, "filtered frame", channels=2)
        focc = None
        if args.focc:
            focc_np = read_image(args.focc)
            check_size("occlusion mask", focc_np, flt1_np, "filtered frame",
                       channels="any")
            focc = tensor(focc_np[..., 0] if focc_np.ndim == 3 else focc_np)
        smo0, valid = warp_bicubic_nan(smo0, tensor(fflo_np), focc)
    smo1 = nlkalman_smooth_frame(flt1, smo0, valid, args.sigma, ps)
    write_image(args.smo1, opp2rgb(smo1).cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
