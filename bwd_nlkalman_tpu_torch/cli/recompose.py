"""recompose equivalent (lib/multiscale/recompose.cpp), the DCT pyramid
of ``ops/pyramid.py`` on the card unless ``--device cpu`` asks otherwise:
usage: recompose prefix levels suffix output [-c factor] [--device cuda|cpu]

Run as ``python -m bwd_nlkalman_tpu_torch.cli.recompose lvl 3 .tif out.tif``.
"""

from __future__ import annotations

import sys

import torch

from ._common import device_arg, split_device
from ..io import read_image, write_image
from ..ops.pyramid import dct_recompose

USAGE = "Usage: recompose prefix levels suffix output [-c factor] [--device cuda|cpu]"


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        argv, device = split_device(argv)
    except ValueError as e:
        print(f"error: {e}\n{USAGE}", file=sys.stderr)
        return 1
    factor = 0.8
    if "-c" in argv:
        i = argv.index("-c")
        factor = float(argv[i + 1])
        del argv[i: i + 2]
    if len(argv) != 4:
        print(USAGE, file=sys.stderr)
        return 1
    prefix, levels, suffix, outp = argv[0], int(argv[1]), argv[2], argv[3]
    dev = device_arg(device)
    lvls = [torch.from_numpy(read_image(f"{prefix}{i}{suffix}")).to(dev)
            for i in range(levels)]
    write_image(outp, dct_recompose(lvls, factor).cpu().numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
