"""Multiscale TV-L1 optical flow (port of ``bwd_nlkalman_tpu.flow.tvl1``).

Coarse-to-fine pyramid with zoom 0.5, flow upscaling by 1/zfactor and the
``fscale`` early stop (tvl1flow_lib.c:345-474), plus the warm-started
streaming variant with its residual gate. Every solved level goes to the
whole-level solver at K2's semantics (``tvl1_fused.py``), as the JAX
package dispatches on the TPU; a level beyond K2's plan would need the
tiled kernel K3, which is not ported yet, and raises on every device.
"""

from __future__ import annotations

import math

import torch

from ..ops.gaussian import blur_matrix_np, gaussian_blur
from ..ops.warp import bicubic_warp
from ..ops.zoom import (_resample_matrix_np, _zoom_out_matrix_np, zoom_in,
                        zoom_in_keys, zoom_out, zoom_out_keys, zoom_size)
from .tvl1_fused import fused_level_supported, tvl1_single_scale_fused

MAX_ITERATIONS = 300          # tvl1flow_lib.c:24
PRESMOOTHING_SIGMA = 0.8      # tvl1flow_lib.c:25


def luma(img: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma (lib/iio/iio.c:1029-1060): (H, W, C) or (H, W) -> (H, W)."""
    if img.ndim == 2:
        return img
    if img.shape[-1] == 1:
        return img[..., 0]
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype, device=img.device)
    return img[..., :3] @ w


def _normalize_pair(i0, i1):
    """Joint [0,255] normalization (image_normalization, tvl1flow_lib.c:303-337)."""
    mx = torch.maximum(i0.max(), i1.max())
    mn = torch.minimum(i0.min(), i1.min())
    den = mx - mn
    scale = torch.where(den > 0, 255.0 / torch.clamp(den, min=1e-30), 1.0)
    off = torch.where(den > 0, mn, 0.0)
    return (i0 - off) * scale, (i1 - off) * scale


def _prep_pair(i0, i1, bases=None):
    """Luma + joint normalization + presmooth (tvl1flow_lib.c:382-386)."""
    i0n, i1n = _normalize_pair(luma(i0.float()), luma(i1.float()))
    return (gaussian_blur(i0n, PRESMOOTHING_SIGMA, bases),
            gaussian_blur(i1n, PRESMOOTHING_SIGMA, bases))


def num_scales(w: int, h: int, nscales: int, zfactor: float) -> int:
    """Auto scale count so the coarsest level is >= 16 px (main.c:159-163)."""
    n = int(1 + math.log(math.hypot(w, h) / 16.0) / math.log(1.0 / zfactor))
    return max(1, min(nscales, n))


def _pyramid_sizes(w: int, h: int, ns: int, zfactor: float) -> list[tuple[int, int]]:
    sizes = [(w, h)]
    for _ in range(1, ns):
        sizes.append(zoom_size(*sizes[-1], zfactor))
    return sizes


def flow_bases(h: int, w: int, nscales: int = 100, zfactor: float = 0.5):
    """Every numpy-built matrix a flow on (h, w) frames uses: key -> build function."""
    out = {("blur", h, PRESMOOTHING_SIGMA): blur_matrix_np,
           ("blur", w, PRESMOOTHING_SIGMA): blur_matrix_np}
    sizes = _pyramid_sizes(w, h, num_scales(w, h, nscales, zfactor), zfactor)
    for (pw, ph), (nw, nh) in zip(sizes, sizes[1:]):
        for k in zoom_out_keys(ph, pw, zfactor):
            out[k] = _zoom_out_matrix_np
        for k in zoom_in_keys(nh, nw, pw, ph):
            out[k] = _resample_matrix_np
    return out


def _k_check(npx: int) -> int:
    """Iterations per convergence check: coarse levels check less often
    (flow/tvl1.py:211-215)."""
    return 8 if npx > 200_000 else 24


def _solve_level(a, b, u, *, tau, lambda_, theta, nwarps, epsilon, max_iters,
                 engine="auto"):
    """Single-scale solve dispatch, as the JAX package's (flow/tvl1.py:203)."""
    h, w = a.shape
    if not fused_level_supported(h, w):
        raise NotImplementedError(
            f"TV-L1 level {h}x{w} exceeds the whole-level solver's plan; it "
            "needs the tiled level kernel K3 (flow/tvl1_pallas.py), which is "
            "not ported yet")
    return tvl1_single_scale_fused(
        a, b, u, tau=tau, lambda_=lambda_, theta=theta, nwarps=nwarps,
        epsilon=epsilon, k_check=_k_check(h * w), max_iters=max_iters,
        engine=engine)


def _zoom_flow(u, nw, nh, zfactor, bases):
    return torch.stack([zoom_in(u[..., 0], nw, nh, bases),
                        zoom_in(u[..., 1], nw, nh, bases)], dim=-1) * (1.0 / zfactor)


def _upsample_chain(u, sizes, s_from, zfactor, bases=None):
    """Zoom the flow from level s_from up to level 0 (tvl1flow_lib.c:427-455)."""
    for s in range(s_from, 0, -1):
        u = _zoom_flow(u, *sizes[s - 1], zfactor, bases)
    return u


def _coarse_to_fine(pyr, sizes, solve, zfactor, bases):
    """Solve every level of ``pyr`` from the coarsest, zero-initialised."""
    cw, ch_ = sizes[len(pyr) - 1]
    u = torch.zeros((ch_, cw, 2), dtype=torch.float32, device=pyr[0][0].device)
    for s in range(len(pyr) - 1, -1, -1):
        u = solve(*pyr[s], u)
        if s == 0:
            break
        u = _zoom_flow(u, *sizes[s - 1], zfactor, bases)
    return u


def tvl1_flow(i0, i1, tau=0.25, lambda_=0.15, theta=0.3, nscales=100,
              fscale=0, zfactor=0.5, nwarps=5, epsilon=0.01,
              max_iters: int | None = None, return_carry: bool = False,
              bases=None, engine: str = "auto"):
    """Multiscale TV-L1 flow from i0 to i1 ((H, W) or (H, W, C)).

    Returns (H, W, 2) float32; with return_carry=True also the
    level-``fscale`` flow (the warm-start carry for tvl1_flow_warm).
    """
    max_iters = MAX_ITERATIONS if max_iters is None else max_iters
    i0n, i1n = _prep_pair(i0, i1, bases)
    h, w = i0n.shape
    ns = num_scales(w, h, nscales, zfactor)
    fs = min(fscale, ns)
    sizes = _pyramid_sizes(w, h, ns, zfactor)
    pyr = [(i0n, i1n)]
    for _ in range(1, ns):
        a, b = pyr[-1]
        pyr.append((zoom_out(a, zfactor, bases), zoom_out(b, zfactor, bases)))

    def solve(a, b, u):
        return _solve_level(a, b, u, tau=tau, lambda_=lambda_, theta=theta,
                            nwarps=nwarps, epsilon=epsilon,
                            max_iters=max_iters, engine=engine)

    # levels below fscale are never solved, only upsampled through
    u_fs = _coarse_to_fine(pyr[fs:], sizes[fs:], solve, zfactor, bases)
    u = _upsample_chain(u_fs, sizes, fs, zfactor, bases)
    return (u, u_fs) if return_carry else u


def warm_gate_ok(a, b, u0, engine: str = "auto") -> bool:
    """Residual gate of the warm-start carry (flow/tvl1.py:333).

    Mean L1 residual of b warped by the carry against the zero-flow
    residual, both over the in-frame footprint of the warp (the warp's
    own validity mask). One host sync: the branch is taken in Python.
    """
    hh, ww = a.shape
    bw, valid = bicubic_warp(b[..., None].contiguous(), u0.contiguous(), None, engine)
    v = valid.to(torch.float32)
    vs = v.sum()
    n = torch.clamp(vs, min=1.0)
    r_warm = torch.sum(torch.abs(a - bw[..., 0]) * v) / n
    r_zero = torch.sum(torch.abs(a - b) * v) / n
    return bool((r_warm <= r_zero) & (vs >= 0.5 * hh * ww))


def tvl1_flow_warm(i0, i1, u_carry, tau=0.25, lambda_=0.15, theta=0.3,
                   nscales=100, fscale=0, zfactor=0.5, nwarps=5, epsilon=0.01,
                   max_iters: int | None = None,
                   warm_nwarps: int | None = None,
                   warm_max_iters: int | None = None, bases=None,
                   engine: str = "auto"):
    """Warm-started streaming TV-L1: solve only the level-``fscale`` scale,
    initialised from the previous step's level-``fscale`` flow; a carry
    that aligns worse than zero flow (the residual gate) falls back to the
    full cold pyramid. Returns (flow (H, W, 2), u_fs_new)."""
    max_iters = MAX_ITERATIONS if max_iters is None else max_iters
    a, b = _prep_pair(i0, i1, bases)
    h, w = a.shape
    ns = num_scales(w, h, nscales, zfactor)
    fs = min(fscale, ns)
    sizes = _pyramid_sizes(w, h, ns, zfactor)
    for _ in range(fs):
        a, b = zoom_out(a, zfactor, bases), zoom_out(b, zfactor, bases)

    def solve(a, b, u, nwarps=nwarps, max_iters=max_iters):
        return _solve_level(a, b, u, tau=tau, lambda_=lambda_, theta=theta,
                            nwarps=nwarps, epsilon=epsilon,
                            max_iters=max_iters, engine=engine)

    u0 = u_carry.to(torch.float32)
    if warm_gate_ok(a, b, u0, engine):
        # the warm branch may run at reduced effort (tvl1.py:428-437)
        u_fs = solve(a, b, u0,
                     nwarps=nwarps if warm_nwarps is None else warm_nwarps,
                     max_iters=max_iters if warm_max_iters is None
                     else warm_max_iters)
    else:
        pyr = [(a, b)]
        for _ in range(fs + 1, ns):
            pa, pb = pyr[-1]
            pyr.append((zoom_out(pa, zfactor, bases), zoom_out(pb, zfactor, bases)))
        u_fs = _coarse_to_fine(pyr, sizes[fs:], solve, zfactor, bases)
    return _upsample_chain(u_fs, sizes, fs, zfactor, bases), u_fs
