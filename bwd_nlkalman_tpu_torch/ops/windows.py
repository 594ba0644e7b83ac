"""Separable aggregation window functions (port of
``bwd_nlkalman_tpu.ops.windows``; reference window_function,
src/nlkalman.c:365-419).

The filter kernels use the "gaussian" window (src/nlkalman.c:542),
``window_np``. Built in numpy; the 1-D helper is a copy of the JAX
package's, so this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _window_1d(kind: str, n: int) -> np.ndarray:
    nn = float(n)
    n2 = (nn - 1.0) / 2.0
    x = np.arange(n, dtype=np.float64)
    if kind == "parzen":
        nc = x - n2
        w = np.where(
            np.abs(nc) <= nn / 4.0,
            1.0 - 24.0 * nc * nc / nn / nn * (1.0 - 2.0 / nn * np.abs(nc)),
            2.0 * (1.0 - 2.0 / nn * np.abs(nc)) ** 3,
        )
    elif kind == "welch":
        nc = (x - n2) / n2
        w = 1.0 - nc * nc
    elif kind == "sine":
        w = np.sin(np.pi * x / (nn - 1))
    elif kind == "hanning":
        w = np.sin(np.pi * x / (nn - 1)) ** 2
    elif kind == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * x / (nn - 1))
    elif kind == "blackman":
        w = (0.42 - 0.5 * np.cos(2 * np.pi * x / (nn - 1))
             + 0.08 * np.cos(4 * np.pi * x / (nn - 1)))
    elif kind == "gaussian":
        s = 0.4  # scale parameter (reference src/nlkalman.c:404)
        xx = (x - n2) / n2 / s
        w = np.exp(-0.5 * xx * xx)
    else:  # constant / flat
        w = np.ones(n)
    return w.astype(np.float32)


def window_np(n: int) -> np.ndarray:
    """2-D separable Gaussian window w[i, j] = w1[i] * w1[j] (float32)."""
    w1 = _window_1d("gaussian", n)
    return np.outer(w1, w1)


def window_function(kind: str, n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """2-D separable window w[i, j] = w1[i] * w1[j] of ``kind`` ("parzen",
    "welch", "sine", "hanning", "hamming", "blackman", "gaussian"; any
    other is flat), as an (n, n) tensor on ``device`` (the CPU by
    default)."""
    w1 = _window_1d(kind, n)
    return torch.as_tensor(np.outer(w1, w1), dtype=dtype, device=device)
