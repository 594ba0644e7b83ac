"""Orthonormal patch DCT bases and the plain all-patch DCT.

Port of the parts of ``bwd_nlkalman_tpu.ops.dct`` the NLK pass uses. The
numpy bases are copies of the JAX package's (that module imports JAX).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


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
