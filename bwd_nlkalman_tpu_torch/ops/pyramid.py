"""DCT pyramid (the multiscaler decompose/recompose pair) and the
Lanczos-3 pyramid.

Port of ``bwd_nlkalman_tpu.ops.pyramid``. DCT pyramid
(lib/multiscale/decompose.cpp:31-56, recompose.cpp:29-53):

- decompose: one whole-image DCT with 1/(4 h w) normalisation; level i is
  the unnormalized inverse DCT of the top-left (h_i, w_i) coefficient
  block, h_i = int(h_{i-1} / ratio);
- recompose: DCT of level 0; for each coarser level, overwrite the lowest
  int(h_i c) x int(w_i c) coefficients with that level's DCT (conservative
  factor c); a final unnormalized inverse DCT.

Lanczos-3 pyramid (lib/ms-lanczos3): half-phase Lanczos-3 downsampling,
+-0.25-phase upsampling, and the Laplacian-style recompose
ret = yH + up(gblur(yL - down(yH))) applied coarse to fine.

Every function takes the ``bases`` mapping of ``ops.bases`` for its
numpy-built matrices (whole-image DCT bases, blur matrices); the
Lanczos-3 taps are a handful of float32 constants, applied as scalars.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .dct import dct2_image, idct2_image, image_dct_keys
from .gaussian import blur_matrix_np, gaussian_blur


def pyramid_sizes(h: int, w: int, levels: int, ratio: float = 2.0):
    """Level sizes per decompose.cpp:52-54 (integer truncation each level)."""
    sizes = []
    for _ in range(levels):
        sizes.append((h, w))
        h = int(h / ratio)
        w = int(w / ratio)
    return sizes


def lanczos3_sizes(h: int, w: int, levels: int):
    """Level sizes of the Lanczos-3 pyramid: each x2 downscale keeps
    ceil(n / 2) samples (every other one from the first)."""
    sizes = [(h, w)]
    for _ in range(levels - 1):
        h, w = sizes[-1]
        sizes.append(((h + 1) // 2, (w + 1) // 2))
    return sizes


def dct_pyramid_keys(h: int, w: int, levels: int, ratio: float = 2.0) -> dict:
    """The constants of the DCT pyramid of an (h, w) image: key -> build."""
    out = {}
    for lh, lw in pyramid_sizes(h, w, levels, ratio):
        out.update(image_dct_keys(lh))
        out.update(image_dct_keys(lw))
    return out


def lanczos3_pyramid_keys(h: int, w: int, levels: int, sigma_blur: float) -> dict:
    """The constants of :func:`lanczos3_recompose` over the Lanczos-3
    pyramid of an (h, w) image: the blur of each coarser level."""
    out = {}
    if sigma_blur > 0:
        for lh, lw in lanczos3_sizes(h, w, levels)[1:]:
            out[("blur", lh, float(sigma_blur))] = blur_matrix_np
            out[("blur", lw, float(sigma_blur))] = blur_matrix_np
    return out


def dct_decompose(img: torch.Tensor, levels: int, ratio: float = 2.0, bases=None):
    """(H, W, C) -> list of ``levels`` images, level 0 = full size."""
    coef = dct2_image(img, bases)
    return [idct2_image(coef[:h_i, :w_i], bases)
            for h_i, w_i in pyramid_sizes(img.shape[0], img.shape[1], levels, ratio)]


def _merge(coef: torch.Tensor, level_coef: torch.Tensor, h_c: int, w_c: int):
    out = coef.clone()
    out[:h_c, :w_c] = level_coef[:h_c, :w_c]
    return out


def dct_recompose(levels_imgs, factor: float = 0.8, bases=None) -> torch.Tensor:
    """Inverse of :func:`dct_decompose` with conservative factor (recompose -c)."""
    coef = dct2_image(levels_imgs[0], bases)
    for img in levels_imgs[1:]:
        coef = _merge(coef, dct2_image(img, bases), int(img.shape[0] * factor),
                      int(img.shape[1] * factor))
    return idct2_image(coef, bases)


def merge_coarse(fine: torch.Tensor, coarse: torch.Tensor, factor: float = 0.8,
                 bases=None) -> torch.Tensor:
    """Two-image recompose (lib/multiscale/merge_coarse.cpp:11-49): the
    lowest int(h_c factor) x int(w_c factor) DCT coefficients of ``fine``
    replaced by ``coarse``'s, then the inverse DCT."""
    cf = _merge(dct2_image(fine, bases), dct2_image(coarse, bases),
                int(coarse.shape[0] * factor), int(coarse.shape[1] * factor))
    return idct2_image(cf, bases)


def auto_pyramid_levels(h: int, w: int) -> int:
    """Level count from pixel count (scripts/msnlkalman-seq.sh:30-40)."""
    n = h * w
    if n < 500_000:
        return 1
    if n < 2_000_000:
        return 2
    if n < 8_000_000:
        return 3
    return 4


# ---------------------------------------------------------------------------
# Lanczos-3 pyramid (lib/ms-lanczos3, Octave reference)
# ---------------------------------------------------------------------------


def _lanczos3_kernel(x: np.ndarray) -> np.ndarray:
    """lanczos3_kernel.m:5-6: sinc(x) sinc(x/3) on |x| < 3."""
    f = np.sinc(x) * np.sinc(x / 3.0)
    return np.where(np.abs(x) < 3.0, f, 0.0)


@functools.lru_cache(maxsize=None)
def _down_taps() -> tuple[float, ...]:
    """Half-phase taps at offsets +-0.5, +-1.5, +-2.5, the kernel scaled
    by the downsampling factor 2, normalised, as float32 values."""
    x = np.arange(-2.5, 3.0, 1.0)
    k = _lanczos3_kernel(x / 2.0)
    return tuple(float(v) for v in (k / k.sum()).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _up_taps(phase: float) -> tuple[float, ...]:
    """Quarter-phase taps at offsets -2..3 from the source grid, normalised."""
    x = np.arange(-2, 4, 1.0) - phase
    k = _lanczos3_kernel(x)
    return tuple(float(v) for v in (k / k.sum()).astype(np.float32))


def _conv_axis(img: torch.Tensor, taps, axis: int, stride: int = 1,
               origin: int = 0) -> torch.Tensor:
    """Taps along ``axis`` at samples origin, origin + stride, ...: the
    axis padded by len(taps) mirrored samples on each side, edges
    included, and tap j read at idx0 + j + pad - k // 2 of the padded axis
    (JAX ops/pyramid.py:99-116, the same index arithmetic and order)."""
    n = img.shape[axis]
    k = len(taps)
    pad = k
    dev = img.device
    img_p = torch.cat([torch.flip(img.narrow(axis, 0, pad), (axis,)), img,
                       torch.flip(img.narrow(axis, n - pad, pad), (axis,))], dim=axis)
    idx0 = np.arange(origin, n, stride)
    acc = None
    for j in range(k):
        sl = torch.index_select(img_p, axis,
                                torch.as_tensor(idx0 + j + pad - k // 2, device=dev))
        acc = sl * taps[j] if acc is None else acc + sl * taps[j]
    return acc


def lanczos3_down(img: torch.Tensor) -> torch.Tensor:
    """Downscale x2 with the normalised half-phase Lanczos-3 kernel."""
    taps = _down_taps()
    out = _conv_axis(img, taps, axis=0, stride=2, origin=0)
    return _conv_axis(out, taps, axis=1, stride=2, origin=0)


def lanczos3_up(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Upscale x2 with +-0.25-phase Lanczos-3 kernels (lanczos3_up.m:25-48):
    the two phases interleaved along each axis, cut to the output size."""
    tm, tp = _up_taps(-0.25), _up_taps(+0.25)

    def up_axis(x, axis, out_n):
        a = _conv_axis(x, tm, axis=axis)
        b = _conv_axis(x, tp, axis=axis)
        shp = list(x.shape)
        shp[axis] = 2 * x.shape[axis]
        inter = torch.stack([a, b], dim=axis + 1).reshape(shp)
        return inter.narrow(axis, 0, out_n)

    return up_axis(up_axis(img, 0, out_h), 1, out_w)


def lanczos3_decompose(img: torch.Tensor, levels: int):
    """Successive x2 Lanczos-3 downscales (lanczos3_decompose.m:20-31)."""
    out = [img]
    for _ in range(levels - 1):
        out.append(lanczos3_down(out[-1]))
    return out


def lanczos3_recompose(levels_imgs, sigma_blur: float = 1.0,
                       bases=None, engine: str = "auto") -> torch.Tensor:
    """Laplacian-style merge, coarse to fine: ret = yH + up(gblur(yL -
    down(yH))) (lib/ms-lanczos3/recompose.m:26), the blur per channel."""
    out = levels_imgs[-1]
    for i in range(len(levels_imgs) - 2, -1, -1):
        y_h = levels_imgs[i]
        diff = out - lanczos3_down(y_h)
        if sigma_blur > 0:
            diff = gaussian_blur(diff, sigma_blur, bases, engine,
                                 planes_last=diff.ndim == 3)
        out = y_h + lanczos3_up(diff, y_h.shape[0], y_h.shape[1])
    return out
