"""Gaussian aggregation window (port of ``bwd_nlkalman_tpu.ops.windows``).

Only the window the filter kernels use (src/nlkalman.c:542) is ported.
Built in numpy; the 1-D helper is a copy of the JAX package's gaussian
branch, so this module imports no JAX.
"""

from __future__ import annotations

import numpy as np


def _window_1d(n: int) -> np.ndarray:
    nn = float(n)
    n2 = (nn - 1.0) / 2.0
    x = np.arange(n, dtype=np.float64)
    s = 0.4  # scale parameter (reference src/nlkalman.c:404)
    xx = (x - n2) / n2 / s
    return np.exp(-0.5 * xx * xx).astype(np.float32)


def window_np(n: int) -> np.ndarray:
    """2-D separable Gaussian window w[i, j] = w1[i] * w1[j] (float32)."""
    w1 = _window_1d(n)
    return np.outer(w1, w1)
