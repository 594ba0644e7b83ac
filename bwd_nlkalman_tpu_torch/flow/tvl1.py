"""Multiscale TV-L1 optical flow (port of ``bwd_nlkalman_tpu.flow.tvl1``).

Coarse-to-fine pyramid with zoom 0.5, flow upscaling by 1/zfactor and the
``fscale`` early stop (tvl1flow_lib.c:345-474), plus the warm-started
streaming variant with its residual gate. A solved level goes, as the
JAX package dispatches on the TPU, to the whole-level solver at K2's
semantics (``tvl1_fused.py``) when it fits K2's plan, else to the tiled
solver at K3's semantics (``tvl1_tiled.py``): at 1080p the 1080x1920
level of a full-resolution (fscale=0) flow. ``state_dtype="bfloat16"``
holds K2's dual planes in bfloat16 (the JAX package's
``BNLK_TVL1_STATE_DTYPE``, here an argument); levels on the tiled path
ignore it, as the JAX package's do.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._dispatch import check_state_dtype
from ..ops.gaussian import blur_matrix_np, gaussian_blur
from ..ops.grad import centered_gradient, divergence, forward_gradient
from ..ops.warp import bicubic_warp, bicubic_warp_plain, warp_bicubic_zero
from ..ops.zoom import (_resample_matrix_np, _zoom_out_matrix_np, zoom_in,
                        zoom_in_keys, zoom_out, zoom_out_keys, zoom_size)
from .tvl1_fused import fused_level_supported, tvl1_single_scale_fused
from .tvl1_tiled import tvl1_single_scale_tiled

MAX_ITERATIONS = 300          # tvl1flow_lib.c:24
PRESMOOTHING_SIGMA = 0.8      # tvl1flow_lib.c:25
GRAD_IS_ZERO = 1e-10          # tvl1flow_lib.c:26


def luma(img: torch.Tensor) -> torch.Tensor:
    """Rec.601 luma (lib/iio/iio.c:1029-1060): (H, W, C) or (H, W) -> (H, W)."""
    if img.ndim == 2:
        return img
    if img.shape[-1] == 1:
        return img[..., 0]
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype, device=img.device)
    return img[..., :3] @ w


def tvl1_flow_single_scale(i0, i1, u_init, tau=0.25, lambda_=0.15, theta=0.3, nwarps=5,
                           epsilon=0.01, check_every=10, max_iters=MAX_ITERATIONS):
    """One-scale TV-L1 at the reference's semantics (Dual_TVL1_optic_flow,
    tvl1flow_lib.c:93-275; JAX flow/tvl1.py:58-154, its XLA level).

    i0, i1: (H, W) float32; u_init: (H, W, 2). Returns (H, W, 2). The
    three-branch threshold step, the divergence with the reference's
    borders, the dual step divided by 1 + taut |grad u|; the mean squared
    update measured on every iteration and tested every ``check_every``,
    so a solve runs whole groups of ``check_every`` iterations. Plain
    PyTorch on either device: the JAX package runs it outside any Pallas
    kernel. The pyramid (:func:`tvl1_flow`) solves its levels with K2's
    and K3's rules instead, as the JAX package does on the TPU."""
    h, w = i0.shape
    size = h * w
    l_t = float(np.float32(lambda_) * np.float32(theta))
    taut = tau / theta
    eps2 = float(np.float32(epsilon * epsilon))
    i1x, i1y = centered_gradient(i1)
    i1s = torch.stack([i1, i1x, i1y], dim=-1).contiguous()
    u1, u2 = u_init[..., 0].float(), u_init[..., 1].float()
    p = i0.new_zeros((4, h, w))     # p11, p12, p21, p22
    for _ in range(nwarps):
        wrp, _ = bicubic_warp_plain(i1s, torch.stack([u1, u2], dim=-1))
        i1w, i1wx, i1wy = wrp.unbind(-1)
        grad = i1wx * i1wx + i1wy * i1wy
        rho_c = i1w - i1wx * u1 - i1wy * u2 - i0
        err, n = float("inf"), 0
        while err > eps2 and n < max_iters:
            for _ in range(check_every):
                rho = rho_c + i1wx * u1 + i1wy * u2
                fi = torch.where(grad < GRAD_IS_ZERO, 0.0,
                                 -rho / torch.clamp(grad, min=GRAD_IS_ZERO))
                lo, hi = rho < -l_t * grad, rho > l_t * grad
                v1 = u1 + torch.where(lo, l_t * i1wx, torch.where(hi, -l_t * i1wx, fi * i1wx))
                v2 = u2 + torch.where(lo, l_t * i1wy, torch.where(hi, -l_t * i1wy, fi * i1wy))
                u1n = v1 + theta * divergence(p[0], p[1])
                u2n = v2 + theta * divergence(p[2], p[3])
                err_t = (torch.sum((u1n - u1) ** 2) + torch.sum((u2n - u2) ** 2)) / size
                u1x, u1y = forward_gradient(u1n)
                u2x, u2y = forward_gradient(u2n)
                ng1 = 1.0 + taut * torch.hypot(u1x, u1y)
                ng2 = 1.0 + taut * torch.hypot(u2x, u2y)
                p = torch.stack([(p[0] + taut * u1x) / ng1, (p[1] + taut * u1y) / ng1,
                                 (p[2] + taut * u2x) / ng2, (p[3] + taut * u2y) / ng2])
                u1, u2 = u1n, u2n
            err = float(err_t)
            n += check_every
    return torch.stack([u1, u2], dim=-1)


def _normalize_pair(i0, i1):
    """Joint [0,255] normalization (image_normalization, tvl1flow_lib.c:303-337),
    as one (2, H, W) stack."""
    mx = torch.maximum(i0.max(), i1.max())
    mn = torch.minimum(i0.min(), i1.min())
    den = mx - mn
    scale = torch.where(den > 0, 255.0 / torch.clamp(den, min=1e-30), 1.0)
    off = torch.where(den > 0, mn, 0.0)
    return (torch.stack([i0, i1]) - off) * scale


def _prep_pair(i0, i1, bases=None, engine: str = "auto"):
    """Luma + joint normalization + presmooth (tvl1flow_lib.c:382-386): the
    pair as one (2, H, W) stack, blurred in one product."""
    ab = _normalize_pair(luma(i0.float()), luma(i1.float()))
    return gaussian_blur(ab, PRESMOOTHING_SIGMA, bases, engine)


def num_scales(w: int, h: int, nscales: int, zfactor: float) -> int:
    """Auto scale count so the coarsest level is >= 16 px (main.c:159-163)."""
    n = int(1 + math.log(math.hypot(w, h) / 16.0) / math.log(1.0 / zfactor))
    return max(1, min(nscales, n))


def _pyramid_sizes(w: int, h: int, ns: int, zfactor: float) -> list[tuple[int, int]]:
    sizes = [(w, h)]
    for _ in range(1, ns):
        sizes.append(zoom_size(*sizes[-1], zfactor))
    return sizes


def flow_carry_shape(h: int, w: int, nscales: int = 100, fscale: int = 0,
                     zfactor: float = 0.5) -> tuple[int, int, int]:
    """Shape of the level-``fscale`` flow that warm-started streaming
    carries, (h_fs, w_fs, 2): that of ``tvl1_flow(..., return_carry=True)``'s
    carry (JAX flow/tvl1.py:252-261)."""
    ns = num_scales(w, h, nscales, zfactor)
    cw, ch_ = w, h
    for _ in range(min(fscale, ns)):
        cw, ch_ = zoom_size(cw, ch_, zfactor)
    return (ch_, cw, 2)


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
                 state_dtype="float32", engine="auto"):
    """Single-scale solve dispatch, as the JAX package's (flow/tvl1.py:196-235):
    ``state_dtype`` reaches K2's levels only."""
    h, w = a.shape
    if not fused_level_supported(h, w):
        return tvl1_single_scale_tiled(
            a, b, u, tau=tau, lambda_=lambda_, theta=theta, nwarps=nwarps,
            epsilon=epsilon, max_iters=max_iters, engine=engine)
    return tvl1_single_scale_fused(
        a, b, u, tau=tau, lambda_=lambda_, theta=theta, nwarps=nwarps,
        epsilon=epsilon, k_check=_k_check(h * w), max_iters=max_iters,
        state_dtype=state_dtype, engine=engine)


def _zoom_flow(u, nw, nh, zfactor, bases, engine="auto"):
    """Both components of the (h, w, 2) flow u zoomed to (nh, nw, 2) in one
    product, times 1 / zfactor."""
    return zoom_in(u, nw, nh, bases, engine, planes_last=True, scale=1.0 / zfactor)


class FlowOps:
    """The steps of a flow on whole frames: the image preparation, the
    pyramid's zoom, the flow's upscaling, a level's solve and the warm
    gate. The pair of images of a level is one (2, H, W) stack, prepared
    and zoomed in one product. ``parallel.flow`` runs the same pyramid with
    their row-sharded forms."""

    def __init__(self, zfactor, bases, engine, tau, lambda_, theta, epsilon,
                 state_dtype="float32"):
        check_state_dtype(state_dtype)
        self.zfactor, self.bases, self.engine = zfactor, bases, engine
        self.state_dtype = state_dtype
        self.kw = dict(tau=tau, lambda_=lambda_, theta=theta, epsilon=epsilon)

    def prep(self, i0, i1):
        return _prep_pair(i0, i1, self.bases, self.engine)

    def zoom_out(self, ab):
        return zoom_out(ab, self.zfactor, self.bases, self.engine)

    def zoom_flow(self, u, nw, nh):
        return _zoom_flow(u, nw, nh, self.zfactor, self.bases, self.engine)

    def solve(self, a, b, u, nwarps, max_iters):
        return _solve_level(a, b, u, nwarps=nwarps, max_iters=max_iters,
                            state_dtype=self.state_dtype, engine=self.engine, **self.kw)

    def gate(self, a, b, u0) -> bool:
        return warm_gate_ok(a, b, u0, self.engine)


def _upsample_chain(u, sizes, s_from, ops):
    """Zoom the flow from level s_from up to level 0 (tvl1flow_lib.c:427-455)."""
    for s in range(s_from, 0, -1):
        u = ops.zoom_flow(u, *sizes[s - 1])
    return u


def _coarse_to_fine(pyr, sizes, solve, ops):
    """Solve every level of ``pyr`` from the coarsest, zero-initialised."""
    cw, ch_ = sizes[len(pyr) - 1]
    u = torch.zeros((ch_, cw, 2), dtype=torch.float32, device=pyr[0][0].device)
    for s in range(len(pyr) - 1, -1, -1):
        u = solve(*pyr[s], u)
        if s == 0:
            break
        u = ops.zoom_flow(u, *sizes[s - 1])
    return u


def flow_pyramid(i0, i1, ops: FlowOps, nscales=100, fscale=0, zfactor=0.5, nwarps=5,
                 max_iters: int | None = None, return_carry: bool = False):
    """:func:`tvl1_flow` with its steps taken by ``ops``."""
    max_iters = MAX_ITERATIONS if max_iters is None else max_iters
    ab = ops.prep(i0, i1)
    h, w = ab.shape[1:]
    ns = num_scales(w, h, nscales, zfactor)
    fs = min(fscale, ns)
    sizes = _pyramid_sizes(w, h, ns, zfactor)
    pyr = [ab]
    for _ in range(1, ns):
        pyr.append(ops.zoom_out(pyr[-1]))

    def solve(a, b, u):
        return ops.solve(a, b, u, nwarps, max_iters)

    # levels below fscale are never solved, only upsampled through; with
    # fscale at or past the coarsest level none is, and the flow stays zero
    # (the JAX package's loop, flow/tvl1.py:310-323)
    if fs < ns:
        u_fs = _coarse_to_fine(pyr[fs:], sizes[fs:], solve, ops)
        u = _upsample_chain(u_fs, sizes, fs, ops)
    else:
        cw, ch_ = sizes[-1]
        u_fs = ab.new_zeros((ch_, cw, 2))
        u = ab.new_zeros((h, w, 2))
    return (u, u_fs) if return_carry else u


def tvl1_flow(i0, i1, tau=0.25, lambda_=0.15, theta=0.3, nscales=100,
              fscale=0, zfactor=0.5, nwarps=5, epsilon=0.01,
              max_iters: int | None = None, return_carry: bool = False,
              bases=None, engine: str = "auto", state_dtype: str = "float32"):
    """Multiscale TV-L1 flow from i0 to i1 ((H, W) or (H, W, C)).

    Returns (H, W, 2) float32; with return_carry=True also the
    level-``fscale`` flow (the warm-start carry for tvl1_flow_warm).
    ``state_dtype``: K2's dual planes, "float32" or "bfloat16".
    """
    ops = FlowOps(zfactor, bases, engine, tau, lambda_, theta, epsilon, state_dtype)
    return flow_pyramid(i0, i1, ops, nscales, fscale, zfactor, nwarps, max_iters,
                        return_carry)


def warm_gate(a, b, u0, engine: str = "auto"):
    """Residual gate of the warm-start carry (flow/tvl1.py:333) as tensors:
    (ok, r_warm, r_zero).

    Mean L1 residual of b warped by the carry against the zero-flow
    residual, both over the in-frame footprint of the warp (the warp's
    own validity mask); a carry that evicts most of the frame fails.
    """
    hh, ww = a.shape
    bw, valid = bicubic_warp(b[..., None].contiguous(), u0.contiguous(), None, engine)
    v = valid.to(torch.float32)
    vs = v.sum()
    n = torch.clamp(vs, min=1.0)
    r_warm = torch.sum(torch.abs(a - bw[..., 0]) * v) / n
    r_zero = torch.sum(torch.abs(a - b) * v) / n
    return (r_warm <= r_zero) & (vs >= 0.5 * hh * ww), r_warm, r_zero


def warm_gate_ok(a, b, u0, engine: str = "auto") -> bool:
    """:func:`warm_gate`'s verdict. One host sync: the branch is taken in
    Python."""
    return bool(warm_gate(a, b, u0, engine)[0])


def flow_pyramid_warm(i0, i1, u_carry, ops: FlowOps, nscales=100, fscale=0,
                      zfactor=0.5, nwarps=5, max_iters: int | None = None,
                      warm_nwarps: int | None = None,
                      warm_max_iters: int | None = None):
    """:func:`tvl1_flow_warm` with its steps taken by ``ops``."""
    max_iters = MAX_ITERATIONS if max_iters is None else max_iters
    ab = ops.prep(i0, i1)
    h, w = ab.shape[1:]
    ns = num_scales(w, h, nscales, zfactor)
    fs = min(fscale, ns)
    # the level-fscale size, past the coarsest level where fscale is
    sizes = _pyramid_sizes(w, h, max(ns, fs + 1), zfactor)
    for _ in range(fs):
        ab = ops.zoom_out(ab)
    a, b = ab

    def solve(a, b, u, nwarps=nwarps, max_iters=max_iters):
        return ops.solve(a, b, u, nwarps, max_iters)

    u0 = u_carry.to(torch.float32)
    if ops.gate(a, b, u0):
        # the warm branch may run at reduced effort (tvl1.py:428-437)
        u_fs = solve(a, b, u0,
                     nwarps=nwarps if warm_nwarps is None else warm_nwarps,
                     max_iters=max_iters if warm_max_iters is None
                     else warm_max_iters)
    else:
        pyr = [ab]
        for _ in range(fs + 1, ns):
            pyr.append(ops.zoom_out(pyr[-1]))
        u_fs = _coarse_to_fine(pyr, sizes[fs:], solve, ops)
    return _upsample_chain(u_fs, sizes, fs, ops), u_fs


def tvl1_flow_warm(i0, i1, u_carry, tau=0.25, lambda_=0.15, theta=0.3,
                   nscales=100, fscale=0, zfactor=0.5, nwarps=5, epsilon=0.01,
                   max_iters: int | None = None,
                   warm_nwarps: int | None = None,
                   warm_max_iters: int | None = None, bases=None,
                   engine: str = "auto", state_dtype: str = "float32"):
    """Warm-started streaming TV-L1: solve only the level-``fscale`` scale,
    initialised from the previous step's level-``fscale`` flow; a carry
    that aligns worse than zero flow (the residual gate) falls back to the
    full cold pyramid. Returns (flow (H, W, 2), u_fs_new)."""
    ops = FlowOps(zfactor, bases, engine, tau, lambda_, theta, epsilon, state_dtype)
    return flow_pyramid_warm(i0, i1, u_carry, ops, nscales, fscale, zfactor, nwarps,
                             max_iters, warm_nwarps, warm_max_iters)


def warm_gate_probe(i0, i1, u_carry, fscale: int = 0, zfactor: float = 0.5,
                    nscales: int = 100, bases=None, engine: str = "auto"):
    """The residual gate :func:`tvl1_flow_warm` applies, on its own (JAX
    flow/tvl1.py:474): the warm path's image preparation (joint
    normalisation, presmoothing, the zoom chain to the fscale level), then
    (ok, r_warm, r_zero) of :func:`warm_gate` for the carry, so that a
    caller can check which branch a warm step took."""
    ab = _prep_pair(i0, i1, bases, engine)
    h, w = ab.shape[1:]
    ns = num_scales(w, h, nscales, zfactor)
    for _ in range(min(fscale, ns)):
        ab = zoom_out(ab, zfactor, bases, engine)
    return warm_gate(ab[0], ab[1], u_carry.to(torch.float32), engine)


def flow_energy(i0, i1, flow, lambda_: float = 0.15,
                engine: str = "auto") -> torch.Tensor:
    """TV-L1 energy (energy_optic_flow, tvl1flow_lib.c:43-85; JAX
    flow/tvl1.py:496), a test oracle: the mean of the full TV of both flow
    components plus lambda times |I1 warped - I0| (the reference sums the
    first component's gradients only; the JAX package, and this copy, keep
    the full TV)."""
    i0, i1 = luma(i0.float()), luma(i1.float())
    u1, u2 = flow[..., 0], flow[..., 1]
    i1w = warp_bicubic_zero(i1, u1, u2, engine)
    diff = torch.abs(i1w - i0)
    u1x, u1y = forward_gradient(u1)
    u2x, u2y = forward_gradient(u2)
    tv = torch.abs(u1x) + torch.abs(u1y) + torch.abs(u2x) + torch.abs(u2y)
    return torch.mean(tv + lambda_ * diff)
