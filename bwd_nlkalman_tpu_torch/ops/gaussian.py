"""Separable Gaussian blur of the TV-L1 reference (lib/tvl1flow/mask.c).

Port of ``bwd_nlkalman_tpu.ops.gaussian``: the blur is a pair of dense
axis matrices built in numpy (copied from the JAX package, which imports
JAX), applied as full-fp32 matrix products.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .bases import basis


@functools.lru_cache(maxsize=None)
def _kernel_np(sigma: float) -> np.ndarray:
    size = int(5 * sigma) + 1
    i = np.arange(size, dtype=np.float64)
    b = np.exp(-i * i / (2.0 * sigma * sigma)) / (sigma * np.sqrt(2.0 * np.pi))
    b /= 2.0 * b.sum() - b[0]
    return np.concatenate([b[:0:-1], b]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def blur_matrix_np(n: int, sigma: float) -> np.ndarray:
    """The 1-D blur as an (n, n) matrix, out = B @ in, with the reference's
    asymmetric reflecting boundary (mask.c:268-270)."""
    size = int(5 * sigma) + 1
    kern = _kernel_np(sigma).astype(np.float64)
    b = np.zeros((n, n), np.float64)
    for i in range(n):
        for j in range(2 * size - 1):
            m = j + 1 + i
            if m < size:
                k = size - m
            elif m < size + n:
                k = m - size
            else:
                k = n - 1 - (m - size - n)
            b[i, np.clip(k, 0, n - 1)] += kern[j]
    return b.astype(np.float32)


def apply_sep(im: torch.Tensor, ay: torch.Tensor, ax: torch.Tensor) -> torch.Tensor:
    """ay @ im @ ax^T in fp32 (rows first, like the reference)."""
    return ay @ (im @ ax.T)


def gaussian_blur(img: torch.Tensor, sigma: float, bases=None) -> torch.Tensor:
    """Separable blur of a (H, W) image."""
    h, w = img.shape
    by = basis(bases, ("blur", h, float(sigma)), blur_matrix_np, img.device)
    bx = basis(bases, ("blur", w, float(sigma)), blur_matrix_np, img.device)
    return apply_sep(img, by, bx)
