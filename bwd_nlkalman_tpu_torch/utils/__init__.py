"""Utility subsystems of the port: pixel-expression evaluation (plambda)
and image statistics (imprintf), numpy only, and profiling/tracing
(a per-stage timer that waits for the card, a torch.profiler trace, and
the layer spans the pipeline records under it)."""

from .imprintf import imprintf  # noqa: F401
from .plambda import plambda  # noqa: F401
from .profiling import StageTimer, last_request, span, trace  # noqa: F401
