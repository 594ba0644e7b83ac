"""Pyramid zoom operators, TV-L1 flavor (lib/tvl1flow/zoom.c).

Port of ``bwd_nlkalman_tpu.ops.zoom``: both zooms are separable with
fixed sample positions, so each axis is a dense numpy-built matrix and
the zoom is their separable product (``gaussian.sep_product``: G on CUDA
tensors, two full-fp32 matrix products else). The matrix-building
functions are copies of the JAX package's.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .gaussian import blur_matrix_np, plane_shape, sep_product

ZOOM_SIGMA_ZERO = 0.6


def zoom_size(nx: int, ny: int, factor: float) -> tuple[int, int]:
    """Static size computation (zoom.c:24-36)."""
    return int(nx * factor + 0.5), int(ny * factor + 0.5)


@functools.lru_cache(maxsize=None)
def _resample_matrix_np(n_out: int, n_in: int, inv_scale: float) -> np.ndarray:
    """(n_out, n_in) Catmull-Rom sampling matrix at positions i*inv_scale,
    taps clamped into [0, n_in-1] (per-tap Neumann), border_out=false."""
    m = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        pos = i * inv_scale
        x0 = math.floor(pos)
        fx = pos - x0
        w = (
            0.5 * (-fx + 2 * fx * fx - fx ** 3),
            1.0 - 2.5 * fx * fx + 1.5 * fx ** 3,
            0.5 * (fx + 4 * fx * fx - 3 * fx ** 3),
            0.5 * (-fx * fx + fx ** 3),
        )
        for l in range(4):
            k = min(max(x0 - 1 + l, 0), n_in - 1)
            m[i, k] += w[l]
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _zoom_out_matrix_np(n_out: int, n_in: int, factor: float) -> np.ndarray:
    """Combined presmooth + resample axis matrix for zoom_out."""
    sigma = ZOOM_SIGMA_ZERO * math.sqrt(1.0 / (factor * factor) - 1.0)
    r = _resample_matrix_np(n_out, n_in, 1.0 / factor).astype(np.float64)
    b = blur_matrix_np(n_in, sigma).astype(np.float64)
    return (r @ b).astype(np.float32)


def zoom_out_keys(h: int, w: int, factor: float) -> list[tuple]:
    nxx, nyy = zoom_size(w, h, factor)
    return [("zoomout", nyy, h, float(factor)), ("zoomout", nxx, w, float(factor))]


def zoom_in_keys(h: int, w: int, nxx: int, nyy: int) -> list[tuple]:
    return [("resample", nyy, h, h / nyy), ("resample", nxx, w, w / nxx)]


def zoom_out(im: torch.Tensor, factor: float, bases=None,
             engine: str = "auto") -> torch.Tensor:
    """Downsample a (H, W) image, or each plane of a (P, H, W) stack, by
    ``factor`` in (0, 1)."""
    ky, kx = zoom_out_keys(*plane_shape(im), factor)
    return sep_product(im, ky, kx, _zoom_out_matrix_np, bases, engine)


def zoom_in(im: torch.Tensor, nxx: int, nyy: int, bases=None, engine: str = "auto",
            planes_last: bool = False, scale: float | None = None) -> torch.Tensor:
    """Upsample a (H, W) image, or each plane of a stack
    (``gaussian.sep_product``'s layouts), to (nyy, nxx) (zoom.c:87-111),
    times ``scale`` if given."""
    ky, kx = zoom_in_keys(*plane_shape(im, planes_last), nxx, nyy)
    return sep_product(im, ky, kx, _resample_matrix_np, bases, engine, planes_last, scale)
