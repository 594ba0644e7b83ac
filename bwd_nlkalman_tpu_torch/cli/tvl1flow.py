"""tvl1flow equivalent — positional args exactly like lib/tvl1flow/main.c:
I0 I1 [out nproc tau lambda theta nscales fscale zfactor nwarps epsilon
verbose], with the same invalid-value fallbacks (main.c:101-141), plus
``--device`` (default ``cuda``). nproc is accepted and ignored. The
default fscale=0 solves the full-resolution level: at 1080p that level
runs the tiled solver (K3). Writes a Middlebury ``.flo``.

Run as ``python -m bwd_nlkalman_tpu_torch.cli.tvl1flow I0 I1 [...]``.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ._common import device_arg, split_device
from ..flow import tvl1_flow
from ..io import read_image, write_flo

DEFAULTS = dict(out="flow.flo", nproc=0, tau=0.25, lambda_=0.15, theta=0.3,
                nscales=100, fscale=0, zfactor=0.5, nwarps=5, epsilon=0.01,
                verbose=0)
USAGE = ("Usage: tvl1flow I0 I1 [out nproc tau lambda theta nscales fscale "
         "zfactor nwarps epsilon verbose] [--device cuda|cpu]")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        argv, device = split_device(argv)
    except ValueError as e:
        print(f"error: {e}\n{USAGE}", file=sys.stderr)
        return 1
    if len(argv) < 2:
        print(USAGE, file=sys.stderr)
        return 1
    d = DEFAULTS
    g = lambda i, cast, dv: cast(argv[i]) if len(argv) > i else dv
    i0p, i1p = argv[0], argv[1]
    out = g(2, str, d["out"])
    _nproc = g(3, int, d["nproc"])
    tau = g(4, float, d["tau"])
    lam = g(5, float, d["lambda_"])
    theta = g(6, float, d["theta"])
    nscales = g(7, int, d["nscales"])
    fscale = g(8, int, d["fscale"])
    zfactor = g(9, float, d["zfactor"])
    nwarps = g(10, int, d["nwarps"])
    epsilon = g(11, float, d["epsilon"])
    _verbose = g(12, int, d["verbose"])

    # reference fallback rules (main.c:101-141)
    if tau <= 0 or tau > 0.25:
        tau = d["tau"]
    if lam <= 0:
        lam = d["lambda_"]
    if theta <= 0:
        theta = d["theta"]
    if nscales <= 0:
        nscales = d["nscales"]
    if zfactor <= 0 or zfactor >= 1:
        zfactor = d["zfactor"]
    if nwarps <= 0:
        nwarps = d["nwarps"]
    if epsilon <= 0:
        epsilon = d["epsilon"]

    dev = device_arg(device)
    i0 = torch.from_numpy(read_image(i0p)).to(dev)
    i1 = torch.from_numpy(read_image(i1p)).to(dev)
    u = tvl1_flow(i0, i1, tau=tau, lambda_=lam, theta=theta, nscales=nscales,
                  fscale=fscale, zfactor=zfactor, nwarps=nwarps, epsilon=epsilon)
    write_flo(out, np.asarray(u.cpu()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
