"""iion equivalent: image format conversion by extension.

Reference: lib/imscript-lite/src/iion.c:7-24 — read with iio, write with
iio, format decided by the output filename. The gt harness uses it for
tif -> png archival (scripts/nlkalman-seq-gt.sh:123-129). Numpy and io
only.

Run as ``python -m bwd_nlkalman_tpu_torch.cli.iion in.tif out.png``.
"""

from __future__ import annotations

import argparse
import sys

from ..io import read_image, write_image


def main(argv=None):
    ap = argparse.ArgumentParser(prog="iion", description=__doc__)
    ap.add_argument("input", help="input image (format by content)")
    ap.add_argument("output", help="output image (format by extension)")
    args = ap.parse_args(argv)
    write_image(args.output, read_image(args.input))
    return 0


if __name__ == "__main__":
    sys.exit(main())
