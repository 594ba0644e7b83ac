"""awgn equivalent: add Gaussian noise with the reference's exact Knuth
LCG + Box-Muller generator (lib/imscript-lite/src/awgn.c; SRAND env var
respected like the SMART_PARAMETER pattern). Numpy and io only.

Run as ``python -m bwd_nlkalman_tpu_torch.cli.awgn sigma in.png out.tif``.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..io import read_image, write_image
from ..ops.noise import awgn


def main(argv=None):
    ap = argparse.ArgumentParser(prog="awgn", description=__doc__)
    ap.add_argument("sigma", type=float)
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--seed", type=int, default=None,
                    help="defaults to $SRAND, else 0")
    args = ap.parse_args(argv)
    seed = args.seed if args.seed is not None else int(os.environ.get("SRAND", "0"))
    img = read_image(args.input)
    write_image(args.output, awgn(img, args.sigma, seed=seed))
    return 0


if __name__ == "__main__":
    sys.exit(main())
