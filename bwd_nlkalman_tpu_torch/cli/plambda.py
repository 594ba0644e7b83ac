"""plambda CLI: RPN per-pixel expression evaluator.

Mirrors the reference binary's two forms
(lib/imscript-lite/src/plambda.c), as the JAX package's command does:

    plambda img1 [img2 ...] "EXPR" [-o out]   # per-pixel over images
    plambda -c "EXPR"                          # calculator, prints result

Covers the pipeline-used language subset (see utils/plambda docstring).
Numpy and io only; run as ``python -m bwd_nlkalman_tpu_torch.cli.plambda``.
"""

from __future__ import annotations

import argparse
import sys

from ..utils.plambda import plambda, plambda_calc


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["-c"]:
        print(f"{plambda_calc(' '.join(argv[1:])):g}")
        return 0
    ap = argparse.ArgumentParser(prog="plambda", description=__doc__)
    ap.add_argument("args", nargs="+", help="input images then the expression")
    ap.add_argument("-o", "--output", default=None, help="output image path")
    ns = ap.parse_args(argv)
    *paths, expr = ns.args
    from ..io import read_image, write_image

    imgs = [read_image(p) for p in paths]
    out = plambda(expr, *imgs)
    if ns.output:
        write_image(ns.output, out)
    else:
        from ..utils.imprintf import imprintf

        print(imprintf("%v %i %a", out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
