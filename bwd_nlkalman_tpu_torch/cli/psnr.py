"""psnr.sh equivalent: RMSE/PSNR between two images (peak 255,
scripts/psnr.sh:9-11). Numpy and io only.

Run as ``python -m bwd_nlkalman_tpu_torch.cli.psnr a.png b.png [--border b]``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..io import read_image


def main(argv=None):
    ap = argparse.ArgumentParser(prog="psnr", description=__doc__)
    ap.add_argument("image1")
    ap.add_argument("image2")
    ap.add_argument("--border", type=int, default=0, help="crop b px per side")
    args = ap.parse_args(argv)
    a = np.asarray(read_image(args.image1), np.float64)
    b = np.asarray(read_image(args.image2), np.float64)
    if args.border:
        s = np.s_[args.border:-args.border, args.border:-args.border]
        a, b = a[s], b[s]
    mse = float(np.mean((a - b) ** 2))
    rmse = float(np.sqrt(mse))
    psnr = 20.0 * np.log10(255.0 / max(rmse, 1e-12))
    print(f"RMSE {rmse:.6f}")
    print(f"PSNR {psnr:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
