"""The reference's AWGN (lib/imscript-lite/src/awgn.c): a Knuth LCG
through the Box-Muller cosine branch, in numpy, bit for bit."""

from __future__ import annotations

import numpy as np

_A = np.uint64(6364136223846793005)
_C = np.uint64(1442695040888963407)
_UINT_MAX = 4294967295.0


def _lcg_states(seed: int, n: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        out = np.empty(n, dtype=np.uint64)
        out[0] = _A * np.uint64(seed) + _C
        filled, am, cm = 1, _A, _C
        while filled < n:
            take = min(filled, n - filled)
            out[filled: filled + take] = am * out[:take] + cm
            filled += take
            cm = am * cm + cm
            am = am * am
        return out


def awgn(img: np.ndarray, sigma: float, seed: int) -> np.ndarray:
    """``img`` plus N(0, sigma^2) noise as ``awgn`` adds it with SRAND=seed."""
    flat = np.asarray(img, dtype=np.float32).reshape(-1)
    u = (_lcg_states(seed, 2 * flat.size) >> np.uint64(32)).astype(np.float64) / _UINT_MAX
    with np.errstate(divide="ignore", invalid="ignore"):
        noise = np.sqrt(-2.0 * np.log(u[0::2])) * np.cos(2.0 * np.pi * u[1::2])
    return (flat.astype(np.float64) + sigma * noise).astype(np.float32).reshape(
        np.asarray(img).shape)
