"""``python -m bwd_nlkalman_tpu_torch``: environment and capability report.

Prints the package version, torch and its CUDA build, the card (or that
there is none), whether ``build/torch_kernels/`` holds built kernels,
whether K1 takes the default passes at common frame sizes with float32
and bfloat16 bands (``core.nlkalman.k1_supported``), the native io
library (built or not, and its codecs: those compiled in, or those whose
headers the compiler finds), and the command-line tools: a quick check of
a new install. Builds and launches nothing.
"""

from __future__ import annotations

import sys


def native_io_line() -> str:
    """The report's native io line (JAX __main__.py:38-44)."""
    import shutil

    from . import native

    if shutil.which("g++") is None and not native.built():
        return "native IO: not available (no g++ to build it); the pure-numpy codecs serve"
    if native.built():
        return (f"native IO: built at {native.lib_path()}; codecs compiled in: "
                + ", ".join(native.codecs() + ("pfm", "flo")))
    return ("native IO: builds at first use (g++) into build/native_io/; headers found: "
            + (", ".join(native.found_codecs()) or "none") + " (pfm and flo need none)")


def main(argv=None) -> int:
    import torch

    from . import __version__
    from ._build import BUILD_ROOT, LIB_NAME, source_hash
    from .cli import COMMANDS
    from .core.nlkalman import k1_refusal
    from .params import FilterMode, default_params

    print(f"bwd_nlkalman_tpu_torch {__version__} (the PyTorch/CUDA port of bwd_nlkalman_tpu)")
    print(f"torch {torch.__version__}  CUDA build {torch.version.cuda or 'none'}")
    if torch.cuda.is_available():
        print(f"cards: {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    else:
        print("cards: none (entry points need device='cpu' / --device cpu)")
    built = sorted(p.parent.name for p in BUILD_ROOT.glob(f"*/{LIB_NAME}"))
    cur = source_hash()
    print(f"kernels: {BUILD_ROOT} holds {len(built)} build(s); these sources "
          f"({cur}) {'are built' if cur in built else 'build at first use (nvcc)'}")
    passes = ((FilterMode.FLT1, "filter"), (FilterMode.FLT2, "filter"),
              (FilterMode.SMO1, "smooth"))
    for h, w, ch in ((540, 960, 1), (1080, 1920, 1), (1080, 1920, 3)):
        for wdt in ("float32", "bfloat16"):
            why = [r for fm, mode in passes
                   if (r := k1_refusal(h, w, ch, default_params(20.0, fm), mode, wdt))]
            verdict = "K1 takes every default pass" if not why else "plain pass: " + "; ".join(why)
            print(f"  {h}x{w}x{ch} {wdt} bands: {verdict}")
    print(native_io_line())
    print("CLI tools: " + ", ".join(c.replace("_", "-") for c in COMMANDS)
          + "  (python -m bwd_nlkalman_tpu_torch.cli.<name> --help)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
