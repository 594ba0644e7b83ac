"""decompose equivalent (lib/multiscale/decompose.cpp), the DCT pyramid
of ``ops/pyramid.py`` on the card unless ``--device cpu`` asks otherwise:
usage: decompose input prefix levels suffix [-r ratio] [--device cuda|cpu]

Run as ``python -m bwd_nlkalman_tpu_torch.cli.decompose in.tif lvl 3 .tif``.
"""

from __future__ import annotations

import sys

import torch

from ._common import device_arg, split_device
from ..io import read_image, write_image
from ..ops.pyramid import dct_decompose

USAGE = "Usage: decompose input prefix levels suffix [-r ratio] [--device cuda|cpu]"


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        argv, device = split_device(argv)
    except ValueError as e:
        print(f"error: {e}\n{USAGE}", file=sys.stderr)
        return 1
    ratio = 2.0
    if "-r" in argv:
        i = argv.index("-r")
        ratio = float(argv[i + 1])
        del argv[i: i + 2]
    if len(argv) != 4:
        print(USAGE, file=sys.stderr)
        return 1
    inp, prefix, levels, suffix = argv[0], argv[1], int(argv[2]), argv[3]
    dev = device_arg(device)
    img = torch.from_numpy(read_image(inp)).to(dev)
    for i, lv in enumerate(dct_decompose(img, levels, ratio)):
        write_image(f"{prefix}{i}{suffix}", lv.cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
