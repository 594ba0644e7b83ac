"""Bicubic warps with explicit validity masks.

Port of ``bwd_nlkalman_tpu.ops.warp``. One sampler serves all three
warps: Catmull-Rom at absolute coordinates (x + u, y + v), tap base
floor(c) - 1, valid where the whole 4x4 footprint lies in the frame, and
every output zeroed where it is not valid. That base equals the denoiser
warp's floor(x + u - 1) (ops/warp.py:199-201 vs :215-216), and since no
invalid sample is ever read, the pad mode never matters.

The JAX package's choice between a shift-select Pallas warp and a gather
(``_use_pallas_warp``, ``_flow_rough``, ``_hybrid_warp``) worked around
the TPU's slow gathers and is not ported: on CUDA tensors the warp is the
hand-written gather kernel K4 (``warp_cuda.py``), on CPU tensors the
plain version below.
"""

from __future__ import annotations

import torch

from .._dispatch import use_kernel
from .warp_cuda import bicubic_warp_cuda


def _cubic(v0, v1, v2, v3, x):
    """Catmull-Rom cubic (reference cubic_interpolation, src/nlkalman.c:36)."""
    return v1 + 0.5 * x * (
        v2 - v0 + x * (2.0 * v0 - 5.0 * v1 + 4.0 * v2 - v3 + x * (3.0 * (v1 - v2) + v3 - v0))
    )


def bicubic_warp_plain(im: torch.Tensor, flow: torch.Tensor,
                       occl: torch.Tensor | None = None, y0: int = 0):
    """Plain version of K4. im (H, W, C), flow (hb, W, 2), occl (hb, W) or
    None (nonzero = occluded), for the frame's rows y0 .. y0 + hb - 1 (the
    whole frame by default: hb = H). Returns (out (hb, W, C) zeroed where
    invalid, valid (hb, W) bool)."""
    h, w, c = im.shape
    hb = flow.shape[0]
    yy, xx = torch.meshgrid(
        torch.arange(y0, y0 + hb, dtype=flow.dtype, device=flow.device),
        torch.arange(w, dtype=flow.dtype, device=flow.device), indexing="ij")
    cx = xx + flow[..., 0]
    cy = yy + flow[..., 1]
    flx, fly = torch.floor(cx), torch.floor(cy)
    fx = (cx - flx)[..., None]
    fy = (cy - fly)[..., None]
    valid = (flx - 1 >= 0) & (flx + 2 <= w - 1) & (fly - 1 >= 0) & (fly + 2 <= h - 1)
    # clamped taps: values outside the frame are never used (a frame under
    # 4 px has no valid pixel, and its taps stay inside the frame too)
    bx = torch.where(valid, flx - 1, 0).long()
    by = torch.where(valid, fly - 1, 0).long()
    flat = im.reshape(h * w, c)
    cols = []
    for i in range(4):
        rows = [flat[torch.clamp((by + k) * w + bx + i, max=h * w - 1).reshape(-1)]
                .reshape(hb, w, c) for k in range(4)]
        cols.append(_cubic(rows[0], rows[1], rows[2], rows[3], fy))
    out = _cubic(cols[0], cols[1], cols[2], cols[3], fx)
    if occl is not None:
        valid = valid & (occl == 0)
    return torch.where(valid[..., None], out, 0.0), valid


def bicubic_sample(im: torch.Tensor, uu: torch.Tensor, vv: torch.Tensor,
                   border_out: bool) -> torch.Tensor:
    """Sample the (H, W) image ``im`` at float coordinates (uu, vv) at the
    reference's semantics (bicubic_interpolation_at,
    lib/tvl1flow/bicubic_interpolation.c:138-234; JAX ops/warp.py:242):
    taps clamped to the frame's edge, and with ``border_out`` 0 wherever
    any tap of the 4x4 footprint falls outside it. Plain PyTorch on either
    device (the JAX package computes it with XLA, never with its Pallas
    warp)."""
    h, w = im.shape[:2]
    x0, y0 = torch.floor(uu), torch.floor(vv)
    fx, fy = uu - x0, vv - y0
    bx, by = x0.long() - 1, y0.long() - 1
    out = (bx < 0) | (bx + 3 >= w) | (by < 0) | (by + 3 >= h)
    flat = im.reshape(-1)
    cols = []
    for i in range(4):
        xi = torch.clamp(bx + i, 0, w - 1)
        rows = [flat[torch.clamp(by + k, 0, h - 1) * w + xi] for k in range(4)]
        cols.append(_cubic(rows[0], rows[1], rows[2], rows[3], fy))
    res = _cubic(cols[0], cols[1], cols[2], cols[3], fx)
    return torch.where(out, 0.0, res) if border_out else res


def bicubic_warp(im, flow, occl=None, engine: str = "auto", y0: int = 0):
    """K4 on CUDA tensors, its plain version on CPU tensors, at any channel
    count (K4 covers every channel in one launch, in channel groups past
    9); given ``y0``, the rows y0 .. y0 + hb - 1 of the frame that
    ``flow`` (hb, W, 2) covers.

    ``engine="plain"`` runs the plain version on any device."""
    if use_kernel(im, engine):
        return bicubic_warp_cuda(im, flow, occl, y0)
    return bicubic_warp_plain(im, flow, occl, y0)


def warp_bicubic_nan(im: torch.Tensor, flow: torch.Tensor,
                     occl: torch.Tensor | None = None, engine: str = "auto"):
    """Warp the (H, W, C) or (H, W) frame ``im``, of any channel count,
    along ``flow``; (warped, valid), one mask for every channel.

    valid is False where the reference would produce NaN: occluded
    pixels, or any of the 4x4 taps outside the frame (src/nlkalman.c:29-34).
    """
    im3 = im if im.ndim == 3 else im[..., None]
    out, valid = bicubic_warp(im3.contiguous(), flow.contiguous(),
                              None if occl is None else occl.contiguous(),
                              engine)
    return (out if im.ndim == 3 else out[..., 0]), valid


def warp_bicubic_zero_multi(ims: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                            engine: str = "auto") -> torch.Tensor:
    """TV-L1 warp of C stacked (H, W, C) images along one flow; zero where
    any tap leaves the frame (lib/tvl1flow/bicubic_interpolation.c:242-264)."""
    out, _ = bicubic_warp(ims.contiguous(), torch.stack([u, v], dim=-1), None,
                          engine)
    return out


def warp_bicubic_zero(im: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                      engine: str = "auto") -> torch.Tensor:
    """warp_bicubic_zero_multi of one (H, W) image."""
    return warp_bicubic_zero_multi(im[..., None], u, v, engine)[..., 0]
