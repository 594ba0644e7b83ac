"""Bit-exact reproduction of the reference's AWGN noise generator (the
port's copy of ``bwd_nlkalman_tpu.ops.noise``, numpy only).

The reference adds noise with ``awgn`` (lib/imscript-lite/src/awgn.c), which
draws from a Knuth LCG (random.c:19-31, multiplier 6364136223846793005,
increment 1442695040888963407, output = state >> 32) pushed through a
Box-Muller cosine transform (random_normal, random.c:68-75).  Reproducing it
bit-for-bit lets our test fixtures and PSNR numbers line up with the C
pipeline's (same SRAND => same noisy frames, up to float rounding).

The LCG recurrence is vectorized with binary lifting: an affine step
s' = a*s + c composes into jumps of power-of-two length, so the whole state
array is produced in O(n log n) numpy ops instead of a Python loop.
"""

from __future__ import annotations

import numpy as np

_A = np.uint64(6364136223846793005)
_C = np.uint64(1442695040888963407)
_UINT_MAX = 4294967295.0  # UINT_MAX as used by random_uniform (random.c:52)


def lcg_knuth_states(seed: int, n: int) -> np.ndarray:
    """First ``n`` post-step states of the Knuth LCG seeded with ``seed``.

    state_{k+1} = a * state_k + c (mod 2^64); returns states 1..n, matching
    n successive lcg_knuth_rand() calls after lcg_knuth_srand(seed).
    """
    if n == 0:
        return np.empty(0, dtype=np.uint64)
    with np.errstate(over="ignore"):
        out = np.empty(n, dtype=np.uint64)
        out[0] = _A * np.uint64(seed) + _C
        filled = 1
        # jump coefficients for stride = filled: s_{k+m} = am * s_k + cm
        am, cm = _A, _C
        while filled < n:
            take = min(filled, n - filled)
            out[filled : filled + take] = am * out[:take] + cm
            filled += take
            cm = am * cm + cm
            am = am * am
        return out


def lcg_knuth_uniforms(seed: int, n: int) -> np.ndarray:
    """n successive random_uniform() draws (float64 in [0, 1])."""
    states = lcg_knuth_states(seed, n)
    return (states >> np.uint64(32)).astype(np.float64) / _UINT_MAX


def lcg_knuth_normals(seed: int, n: int) -> np.ndarray:
    """n successive random_normal() draws (Box-Muller cosine branch)."""
    u = lcg_knuth_uniforms(seed, 2 * n)
    x1 = u[0::2]
    x2 = u[1::2]
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(-2.0 * np.log(x1)) * np.cos(2.0 * np.pi * x2)


def awgn(img: np.ndarray, sigma: float, seed: int = 0) -> np.ndarray:
    """Add N(0, sigma^2) noise exactly like ``awgn`` with SRAND=seed.

    img: float array; noise is added in C (row-major, interleaved-channel)
    element order, i.e. over img.reshape(-1) of an (H, W, C) array.
    """
    flat = np.asarray(img, dtype=np.float32).reshape(-1)
    noise = lcg_knuth_normals(seed, flat.size)
    out = flat.astype(np.float64) + sigma * noise
    return out.astype(np.float32).reshape(np.asarray(img).shape)
