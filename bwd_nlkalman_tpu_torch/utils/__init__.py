"""Utility subsystems of the port: pixel-expression evaluation (plambda)
and image statistics (imprintf), numpy only. The JAX package's profiling
helpers are not ported: ``chip_smoke.py`` and ``tools/*_bench.py`` time
the card."""

from .imprintf import imprintf  # noqa: F401
from .plambda import plambda  # noqa: F401
