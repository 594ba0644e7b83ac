"""Orthonormal patch DCTs, the plain all-patch DCT and the whole-image
DCT of the multiscale pyramid.

Port of ``bwd_nlkalman_tpu.ops.dct``. The numpy bases are copies of the
JAX package's (that module imports JAX). Every product runs at full
float32 precision, as the JAX package's ``precision="highest"`` einsums
do; the JAX package's ``dct_image_all_patches_matmul`` (default MXU
precision, for its bf16 band path on the TPU) is not ported: the port's
K1 computes its bands itself.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .bases import basis


@functools.lru_cache(maxsize=None)
def _ortho_basis_np(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis: D[k, i] = s_k sqrt(2/n) cos(pi (2i+1) k / 2n)."""
    k = np.arange(n)[:, None].astype(np.float64)
    i = np.arange(n)[None, :].astype(np.float64)
    d = math.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    d[0] *= 1.0 / math.sqrt(2.0)
    return d.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _ortho_basis_kron_np(psz: int) -> np.ndarray:
    """Flattened 2-D basis (psz^2, psz^2); row = ky*psz+kx, col = dy*psz+dx."""
    d = _ortho_basis_np(psz).astype(np.float64)
    return np.kron(d, d).astype(np.float32)


def patch_dct_matrix(psz: int, device=None) -> torch.Tensor:
    """Orthonormal 1-D DCT-II basis (psz, psz) on ``device`` (the CPU by
    default)."""
    return torch.as_tensor(_ortho_basis_np(psz), device=device)


def patch_dct_matrix_2d(psz: int, device=None) -> torch.Tensor:
    """Flattened orthonormal 2-D DCT-II basis (psz^2, psz^2): y = B @ vec(p)."""
    return torch.as_tensor(_ortho_basis_kron_np(psz), device=device)


def _ortho(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(_ortho_basis_np(n), dtype=like.dtype, device=like.device)


def dct2_patches(p: torch.Tensor) -> torch.Tensor:
    """Orthonormal 2-D DCT-II of patches shaped (..., psz, psz): D p D^T."""
    d = _ortho(p.shape[-1], p)
    return torch.matmul(torch.matmul(d, p), d.T)


def idct2_patches(p: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`dct2_patches` (orthonormal, so D^T p D)."""
    d = _ortho(p.shape[-1], p)
    return torch.matmul(torch.matmul(d.T, p), d)


def dct2_flat(x: torch.Tensor, psz: int) -> torch.Tensor:
    """Orthonormal 2-D DCT-II on flattened patches (..., psz*psz) -> same."""
    b = torch.as_tensor(_ortho_basis_kron_np(psz), dtype=x.dtype, device=x.device)
    return torch.matmul(x, b.T)


def idct2_flat(x: torch.Tensor, psz: int) -> torch.Tensor:
    """Inverse of :func:`dct2_flat`."""
    b = torch.as_tensor(_ortho_basis_kron_np(psz), dtype=x.dtype, device=x.device)
    return torch.matmul(x, b)


def dct_image_all_patches(img: torch.Tensor, psz: int) -> torch.Tensor:
    """Orthonormal 2-D DCT of every overlapping psz x psz patch.

    img: (H, W, C) -> (H-psz+1, W-psz+1, C*psz*psz), last axis
    channel-major (c*psz^2 + ky*psz + kx). Same separable shifted-FMA
    order as the JAX package: rows first (sum over i), then columns.
    """
    h, w, c = img.shape
    hh, ww = h - psz + 1, w - psz + 1
    d = _ortho_basis_np(psz)
    outs = []
    for ci in range(c):
        im = img[..., ci]
        rows = []
        for k in range(psz):
            acc = None
            for i in range(psz):
                t = float(d[k, i]) * im[i: i + hh, :]
                acc = t if acc is None else acc + t
            rows.append(acc)
        for k in range(psz):
            for l in range(psz):
                acc = None
                for j in range(psz):
                    t = float(d[l, j]) * rows[k][:, j: j + ww]
                    acc = t if acc is None else acc + t
                outs.append(acc)
    return torch.stack(outs, dim=-1)


# ---------------------------------------------------------------------------
# whole-image DCT (multiscale pyramid convention)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _unnorm_dct2_basis_np(n: int) -> np.ndarray:
    """Unnormalized FFTW REDFT10 matrix U[k, i] = 2 cos(pi (2i+1) k / 2n)."""
    k = np.arange(n)[:, None].astype(np.float64)
    i = np.arange(n)[None, :].astype(np.float64)
    return (2.0 * np.cos(np.pi * (2 * i + 1) * k / (2 * n))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _unnorm_dct3_basis_np(n: int) -> np.ndarray:
    """Unnormalized FFTW REDFT01 matrix V with V @ U = 2n I."""
    v = _unnorm_dct2_basis_np(n).T.astype(np.float64).copy()
    v[:, 0] *= 0.5
    return v.astype(np.float32)


def image_dct_keys(n: int) -> dict:
    """The constants of whole-image transforms along an axis of n samples:
    key -> build function."""
    return {("dct2", n): _unnorm_dct2_basis_np, ("dct3", n): _unnorm_dct3_basis_np}


def _sep(mh: torch.Tensor, img: torch.Tensor, mw: torch.Tensor) -> torch.Tensor:
    """mh @ img @ mw^T per channel of an (H, W, C) image: two full-float32
    matrix products (at 1080x1920, 12.5 GFLOP a channel)."""
    planes = img.permute(2, 0, 1)
    return torch.matmul(torch.matmul(mh, planes), mw.T).permute(1, 2, 0)


def dct2_image(img: torch.Tensor, bases=None) -> torch.Tensor:
    """Whole-image 2-D DCT-II of an (H, W, C) image with the multiscaler
    normalisation: FFTW REDFT10 x REDFT10 of each channel over 4 H W
    (lib/multiscale/multiscaler.cpp:20-62, non-ISOMETRIC build)."""
    h, w = img.shape[0], img.shape[1]
    uh = basis(bases, ("dct2", h), _unnorm_dct2_basis_np, img.device)
    uw = basis(bases, ("dct2", w), _unnorm_dct2_basis_np, img.device)
    return _sep(uh, img, uw) / (4.0 * h * w)


def idct2_image(coef: torch.Tensor, bases=None) -> torch.Tensor:
    """Whole-image 2-D DCT-III (unnormalized REDFT01), inverse of
    :func:`dct2_image`."""
    h, w = coef.shape[0], coef.shape[1]
    vh = basis(bases, ("dct3", h), _unnorm_dct3_basis_np, coef.device)
    vw = basis(bases, ("dct3", w), _unnorm_dct3_basis_np, coef.device)
    return _sep(vh, coef, vw)
