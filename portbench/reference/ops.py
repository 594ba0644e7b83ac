"""Plain image operators of the reference: colour, luma, gradients, the
presmoothing blur and pyramid zooms as dense axis matrices, the
occlusion mask and the bicubic warp with its validity mask."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

PRESMOOTHING_SIGMA = 0.8      # tvl1flow_lib.c:25
ZOOM_SIGMA_ZERO = 0.6         # zoom.c

_A = 1.0 / math.sqrt(3.0)
_B = 1.0 / math.sqrt(2.0)
_C = 2.0 * _A * math.sqrt(2.0)
_CI = _A / _B
_FWD = [[_A, _A, _A], [_B, 0.0, -_B], [0.25 * _C, -0.5 * _C, 0.25 * _C]]
_INV = [[_A, _B, 0.5 * _CI], [_A, 0.0, -_CI], [_A, -_B, 0.5 * _CI]]


def _mix(im, rows):
    return torch.einsum("...c,kc->...k", im, torch.tensor(rows, dtype=im.dtype,
                                                          device=im.device))


def rgb2opp(im):
    """Opponent colour (src/nlkalman.c:92-130); the identity unless C == 3."""
    return im if im.shape[-1] != 3 else _mix(im, _FWD)


def opp2rgb(im):
    return im if im.shape[-1] != 3 else _mix(im, _INV)


def luma(img):
    """Rec.601 luma of (H, W, C) or (H, W) -> (H, W)."""
    if img.ndim == 2:
        return img
    if img.shape[-1] == 1:
        return img[..., 0]
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype, device=img.device)
    return img[..., :3] @ w


def centered_gradient(f):
    """0.5 (f[i+1] - f[i-1]) on an edge-replicated pad (mask.c:172-208)."""
    fp = F.pad(f[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    return 0.5 * (fp[1:-1, 2:] - fp[1:-1, :-2]), 0.5 * (fp[2:, 1:-1] - fp[:-2, 1:-1])


@functools.lru_cache(maxsize=None)
def _gauss_kernel(sigma: float) -> np.ndarray:
    size = int(5 * sigma) + 1
    i = np.arange(size, dtype=np.float64)
    b = np.exp(-i * i / (2.0 * sigma * sigma)) / (sigma * np.sqrt(2.0 * np.pi))
    b /= 2.0 * b.sum() - b[0]
    return np.concatenate([b[:0:-1], b]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def blur_matrix(n: int, sigma: float) -> np.ndarray:
    """The 1-D blur as an (n, n) matrix with the reference's asymmetric
    reflecting boundary (mask.c:268-270)."""
    size = int(5 * sigma) + 1
    kern = _gauss_kernel(sigma).astype(np.float64)
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


def zoom_size(nx: int, ny: int, factor: float) -> tuple[int, int]:
    return int(nx * factor + 0.5), int(ny * factor + 0.5)


@functools.lru_cache(maxsize=None)
def resample_matrix(n_out: int, n_in: int, inv_scale: float) -> np.ndarray:
    """(n_out, n_in) Catmull-Rom sampling at i * inv_scale, taps clamped."""
    m = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        pos = i * inv_scale
        x0 = math.floor(pos)
        fx = pos - x0
        w = (0.5 * (-fx + 2 * fx * fx - fx ** 3), 1.0 - 2.5 * fx * fx + 1.5 * fx ** 3,
             0.5 * (fx + 4 * fx * fx - 3 * fx ** 3), 0.5 * (-fx * fx + fx ** 3))
        for tap in range(4):
            m[i, min(max(x0 - 1 + tap, 0), n_in - 1)] += w[tap]
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def zoom_out_matrix(n_out: int, n_in: int, factor: float) -> np.ndarray:
    """Presmooth + resample along one axis (zoom.c:40-85)."""
    sigma = ZOOM_SIGMA_ZERO * math.sqrt(1.0 / (factor * factor) - 1.0)
    r = resample_matrix(n_out, n_in, 1.0 / factor).astype(np.float64)
    return (r @ blur_matrix(n_in, sigma).astype(np.float64)).astype(np.float32)


class Consts:
    """The reference's own constant matrices on one device, built once."""

    def __init__(self, device):
        self.device = device
        self._cache: dict = {}

    def get(self, build, *args) -> torch.Tensor:
        key = (build.__name__, *args)
        if key not in self._cache:
            self._cache[key] = torch.as_tensor(build(*args), device=self.device)
        return self._cache[key]


def apply_sep(im, ay, ax):
    """ay @ im @ ax^T in float32 (rows first)."""
    return ay @ (im @ ax.T)


def zoom_out(im, factor: float, consts: Consts):
    """Downsample (..., H, W) by ``factor``."""
    h, w = im.shape[-2:]
    nxx, nyy = zoom_size(w, h, factor)
    return apply_sep(im, consts.get(zoom_out_matrix, nyy, h, float(factor)),
                     consts.get(zoom_out_matrix, nxx, w, float(factor)))


def zoom_in(im, nxx: int, nyy: int, consts: Consts):
    """Upsample (..., H, W) to (..., nyy, nxx) (zoom.c:87-111)."""
    h, w = im.shape[-2:]
    return apply_sep(im, consts.get(resample_matrix, nyy, h, h / nyy),
                     consts.get(resample_matrix, nxx, w, w / nxx))


def occlusion_mask(flow, threshold: float):
    """255 where the backward-difference divergence of the flow exceeds
    the threshold (scripts/nlkalman-seq.sh:69-72), else 0."""
    u, v = flow[..., 0], flow[..., 1]
    du = torch.cat([torch.zeros_like(u[:, :1]), u[:, 1:] - u[:, :-1]], dim=1)
    dv = torch.cat([torch.zeros_like(v[:1]), v[1:] - v[:-1]], dim=0)
    return torch.where((du + dv).abs() > threshold, 255.0, 0.0).to(flow.dtype)


def _cubic(v0, v1, v2, v3, x):
    """Catmull-Rom (src/nlkalman.c:36)."""
    return v1 + 0.5 * x * (
        v2 - v0 + x * (2.0 * v0 - 5.0 * v1 + 4.0 * v2 - v3 + x * (3.0 * (v1 - v2) + v3 - v0)))


def bicubic_warp(im, flow, occl=None):
    """Warp (..., H, W, C) along (..., H, W, 2) (a batch of frames or one):
    taps from floor(c) - 1, valid where the 4x4 footprint lies in the frame
    and the pixel is not occluded; zero where invalid. Returns (out,
    valid)."""
    h, w, c = im.shape[-3:]
    lead = im.shape[:-3]
    n = h * w
    yy, xx = torch.meshgrid(torch.arange(h, dtype=flow.dtype, device=flow.device),
                            torch.arange(w, dtype=flow.dtype, device=flow.device),
                            indexing="ij")
    cx, cy = xx + flow[..., 0], yy + flow[..., 1]
    flx, fly = torch.floor(cx), torch.floor(cy)
    fx, fy = (cx - flx)[..., None], (cy - fly)[..., None]
    valid = (flx - 1 >= 0) & (flx + 2 <= w - 1) & (fly - 1 >= 0) & (fly + 2 <= h - 1)
    bx = torch.where(valid, flx - 1, 0).long()
    by = torch.where(valid, fly - 1, 0).long()
    frame = torch.arange(valid[..., 0, 0].numel(), device=im.device).reshape(lead)
    base = (frame * n)[..., None, None]
    flat = im.reshape(-1, c)
    cols = []
    for i in range(4):
        rows = [flat[(base + torch.clamp((by + k) * w + bx + i, max=n - 1)).reshape(-1)]
                .reshape(im.shape) for k in range(4)]
        cols.append(_cubic(rows[0], rows[1], rows[2], rows[3], fy))
    out = _cubic(cols[0], cols[1], cols[2], cols[3], fx)
    if occl is not None:
        valid = valid & (occl == 0)
    return torch.where(valid[..., None], out, 0.0), valid


@functools.lru_cache(maxsize=None)
def dct_basis(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis D[k, i]."""
    k = np.arange(n)[:, None].astype(np.float64)
    i = np.arange(n)[None, :].astype(np.float64)
    d = math.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    d[0] *= 1.0 / math.sqrt(2.0)
    return d.astype(np.float32)


@functools.lru_cache(maxsize=None)
def dct_basis_kron(psz: int) -> np.ndarray:
    d = dct_basis(psz).astype(np.float64)
    return np.kron(d, d).astype(np.float32)


@functools.lru_cache(maxsize=None)
def gaussian_window(n: int) -> np.ndarray:
    """2-D separable Gaussian aggregation window (src/nlkalman.c:365-419, s = 0.4)."""
    x = np.arange(n, dtype=np.float64)
    n2 = (n - 1.0) / 2.0
    xx = (x - n2) / n2 / 0.4
    w1 = np.exp(-0.5 * xx * xx).astype(np.float32)
    return np.outer(w1, w1)


def dct_all_patches(img, psz: int):
    """Orthonormal 2-D DCT of every psz x psz patch of (H, W, C) ->
    (H-psz+1, W-psz+1, C psz^2), channel-major, rows first."""
    h, w, c = img.shape
    hh, ww = h - psz + 1, w - psz + 1
    d = dct_basis(psz)
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


def patch_validity(valid_pix, psz: int):
    """(H, W) bool -> (H-psz+1, W-psz+1): every pixel of the patch valid."""
    v = valid_pix.to(torch.float32)
    h, w = v.shape
    hh, ww = h - psz + 1, w - psz + 1
    rows = torch.stack([v[i: i + hh] for i in range(psz)], 0).amin(0)
    return torch.stack([rows[:, j: j + ww] for j in range(psz)], 0).amin(0) > 0.5
