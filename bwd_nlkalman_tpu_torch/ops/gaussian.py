"""Separable Gaussian blur of the TV-L1 reference (lib/tvl1flow/mask.c).

Port of ``bwd_nlkalman_tpu.ops.gaussian``: the blur is a pair of dense
axis matrices built in numpy (copied from the JAX package, which imports
JAX). :func:`sep_product` applies such a pair, the zooms' too: on CUDA
tensors G (``ops/band_cuda.py``) on their band forms, else the full-fp32
dense products of :func:`apply_sep` (the same sums, rounded in another
order).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._dispatch import use_kernel
from .band_cuda import band_build, band_key, band_plan, band_sep_cuda
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


def sep_product(x: torch.Tensor, key_y: tuple, key_x: tuple, build, bases=None,
                engine: str = "auto", planes_last: bool = False,
                scale: float | None = None) -> torch.Tensor:
    """ay @ plane @ ax^T for every plane of x, times ``scale`` if given; ay
    and ax the matrices of ``key_y`` and ``key_x`` (``ops.bases`` keys whose
    matrices ``build`` makes). x is (H, W), (P, H, W) or, with
    ``planes_last``, (H, W, P), and the result is laid out alike. On a CUDA
    tensor with ``engine="auto"`` one launch of G on the band forms (the
    ``bases`` keys ``band_cuda.band_key``); else :func:`apply_sep` plane by
    plane."""
    dev = x.device
    if use_kernel(x, engine):
        by = basis(bases, band_key(key_y), band_build(build), dev)
        bx = basis(bases, band_key(key_x), band_build(build), dev)
        return band_sep_cuda(x, by, bx, band_plan(build, key_y, key_x), planes_last,
                             1.0 if scale is None else scale)
    ay, ax = basis(bases, key_y, build, dev), basis(bases, key_x, build, dev)
    if x.ndim == 2:
        out = apply_sep(x, ay, ax)
    else:
        d = -1 if planes_last else 0
        out = torch.stack([apply_sep(p, ay, ax) for p in x.unbind(d)], dim=d)
    return out if scale is None else out * scale


def plane_shape(x: torch.Tensor, planes_last: bool = False) -> tuple[int, int]:
    """(H, W) of the planes of x, laid out as :func:`sep_product` takes them."""
    return tuple(x.shape[:2] if planes_last else x.shape[-2:])


def gaussian_blur(img: torch.Tensor, sigma: float, bases=None, engine: str = "auto",
                  planes_last: bool = False) -> torch.Tensor:
    """Separable blur of a (H, W) image, or of each plane of a stack
    (:func:`sep_product`'s layouts)."""
    h, w = plane_shape(img, planes_last)
    return sep_product(img, ("blur", h, float(sigma)), ("blur", w, float(sigma)),
                       blur_matrix_np, bases, engine, planes_last)
