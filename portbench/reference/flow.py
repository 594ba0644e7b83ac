"""Multiscale TV-L1 optical flow, plain, over a batch of frame pairs.

The pyramid of tvl1flow_lib.c:345-474 (joint normalisation, presmoothing,
zoom 0.5, flow upscaling, the ``fscale`` early stop) and each solved
level at the semantics of the program's whole-level solver (K2): the
clamp form of the threshold step, dual planes zero at the last column and
row, and the mean squared update measured on the last iteration of each
round of ``k_check`` iterations, tested after the round. Every pair of
the batch keeps its own stopping decision: a pair that has stopped keeps
its state while the others run on. Each pair gets what a solve of it
alone gives, bit for bit: the matrix products and the sums that decide a
level's stop are taken pair by pair (:func:`_alone`), since on the card
their rounding depends on how many pairs they hold, and where a flow is
ill-conditioned (white-noise texture jumping back 7 px) a stop taken one
round apart gives another flow. Only levels that K2's plan takes are solved here; a level
the program hands to its tiled solver (K3) is refused.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ops import (PRESMOOTHING_SIGMA, Consts, apply_sep, bicubic_warp, blur_matrix,
                  centered_gradient, zoom_in, zoom_out, zoom_size)

MAX_ITERATIONS = 300   # tvl1flow_lib.c:24
GRAD_IS_ZERO = 1e-10   # tvl1flow_lib.c:26


def k2_takes(h: int, w: int, budget: int = 90 * 1024 * 1024) -> bool:
    """The program's rule between its whole-level and tiled solvers."""
    hp = max(-(-h // 8) * 8, 8)
    ln = max(-(-(w + 2 * 4 + 3) // 128) * 128, 128)
    return (10 + 1 + 2 + 2) * hp * ln * 4 + 3 * (hp + 11) * ln * 4 < budget


def num_scales(w: int, h: int, nscales: int, zfactor: float) -> int:
    """Scales so that the coarsest level is at least 16 px (main.c:159-163)."""
    n = int(1 + math.log(math.hypot(w, h) / 16.0) / math.log(1.0 / zfactor))
    return max(1, min(nscales, n))


def _alone(x, f):
    """``f`` on each pair of the batch ``x`` as a fresh batch of one,
    concatenated: the rounding of a solve of that pair alone."""
    return torch.cat([f(x[j:j + 1].clone()) for j in range(x.shape[0])])


def _prep(i0, i1, consts):
    """Joint [0, 255] normalisation of each pair, then the presmoothing blur."""
    dims = (1, 2)
    mx = torch.maximum(i0.amax(dims), i1.amax(dims))[:, None, None]
    mn = torch.minimum(i0.amin(dims), i1.amin(dims))[:, None, None]
    den = mx - mn
    scale = torch.where(den > 0, 255.0 / torch.clamp(den, min=1e-30), 1.0)
    off = torch.where(den > 0, mn, 0.0)
    h, w = i0.shape[1:]
    by = consts.get(blur_matrix, h, PRESMOOTHING_SIGMA)
    bx = consts.get(blur_matrix, w, PRESMOOTHING_SIGMA)
    return tuple(_alone((i - off) * scale, lambda x: apply_sep(x, by, bx)) for i in (i0, i1))


def _one_iter(U, PA, PB, IG, nig, rho_c, l_t, theta, taut):
    t = IG * U
    rho = rho_c + t[:, 0] + t[:, 1]
    fi = torch.clamp(rho * nig, -l_t, l_t)[:, None]
    V = U + fi * IG
    zc = torch.zeros_like(PA[..., :1])
    zr = torch.zeros_like(PB[:, :, :1])
    DIV = (PA - torch.cat([zc, PA[..., :-1]], dim=-1)) \
        + (PB - torch.cat([zr, PB[:, :, :-1]], dim=2))
    Un = V + theta * DIV
    UX = torch.cat([Un[..., 1:] - Un[..., :-1], zc], dim=-1)
    UY = torch.cat([Un[:, :, 1:] - Un[:, :, :-1], zr], dim=2)
    R = 1.0 / (1.0 + taut * torch.sqrt(UX * UX + UY * UY))
    return Un, (PA + taut * UX) * R, (PB + taut * UY) * R


def _stage_consts(i1s, U, i0):
    """The warped I1 and its gradients along U (i1s (B, H, W, 3)), nig =
    -1/|grad|^2 (0 below 1e-10) and rho_c, as (IG (B, 2, H, W), nig,
    rho_c)."""
    u1, u2 = U[:, 0], U[:, 1]
    wrp, _ = bicubic_warp(i1s, torch.stack([u1, u2], dim=-1))
    i1w, i1wx, i1wy = wrp.unbind(-1)
    grad = i1wx * i1wx + i1wy * i1wy
    nig = torch.where(grad < GRAD_IS_ZERO, 0.0, -1.0 / torch.clamp(grad, min=GRAD_IS_ZERO))
    return torch.stack([i1wx, i1wy], dim=1), nig, i1w - i1wx * u1 - i1wy * u2 - i0


def solve_level(i0, i1, u_init, tau, lambda_, theta, nwarps, epsilon, max_iters,
                duals="float32"):
    """One level for a batch: i0, i1 (B, H, W); u_init (B, H, W, 2).
    ``duals="bfloat16"`` rounds the dual planes to bfloat16 as each
    iteration stores them: the lower precision that the control runs."""
    b, h, w = i0.shape
    if not k2_takes(h, w):
        raise ValueError(f"a {h}x{w} level is the tiled solver's; the reference "
                         "solves whole levels only")
    k_check = 8 if h * w > 200_000 else 24
    i1s = torch.stack([torch.stack([i1[j], *centered_gradient(i1[j])], dim=-1)
                       for j in range(b)])
    l_t = float(np.float32(lambda_) * np.float32(theta))
    taut = tau / theta
    eps2 = float(np.float32(epsilon * epsilon))
    U = u_init.permute(0, 3, 1, 2).to(torch.float32)
    PA = torch.zeros_like(U)
    PB = torch.zeros_like(U)
    for _ in range(nwarps):
        IG, nig, rho_c = _stage_consts(i1s, U, i0)
        err = torch.full((b,), math.inf, dtype=torch.float64)
        n = torch.zeros(b, dtype=torch.long)
        active = torch.ones(b, dtype=torch.bool)
        while bool(active.any()):
            Uc, PAc, PBc = U, PA, PB
            for _ in range(k_check):
                Up = Uc
                Uc, PAc, PBc = _one_iter(Uc, PAc, PBc, IG, nig, rho_c, l_t, theta, taut)
                if duals == "bfloat16":
                    PAc = PAc.to(torch.bfloat16).float()
                    PBc = PBc.to(torch.bfloat16).float()
            dU = Uc - Up
            e = (_alone(dU, lambda d: torch.sum(d * d, dim=(1, 2, 3))) / (h * w)).double().cpu()
            sel = active.to(U.device)[:, None, None, None]
            U = torch.where(sel, Uc, U)
            PA = torch.where(sel, PAc, PA)
            PB = torch.where(sel, PBc, PB)
            err = torch.where(active, e, err)
            n = torch.where(active, n + k_check, n)
            active = (err > eps2) & (n < max_iters)
    return U.permute(0, 2, 3, 1).contiguous()


def _zoom_flow(u, nw, nh, zfactor, consts):
    return _alone(u, lambda v: torch.stack([zoom_in(v[..., 0], nw, nh, consts),
                                            zoom_in(v[..., 1], nw, nh, consts)],
                                           dim=-1) * (1.0 / zfactor))


def tvl1_flows(i0, i1, consts: Consts, tau=0.25, lambda_=0.15, theta=0.3, nscales=100,
               fscale=0, zfactor=0.5, nwarps=5, epsilon=0.01, max_iters=None,
               duals="float32"):
    """Flow from each i0[b] to i1[b] ((B, H, W) luma) -> (B, H, W, 2)."""
    max_iters = MAX_ITERATIONS if max_iters is None else max_iters
    a, b = _prep(i0.float(), i1.float(), consts)
    h, w = a.shape[1:]
    ns = num_scales(w, h, nscales, zfactor)
    fs = min(fscale, ns)
    sizes = [(w, h)]
    for _ in range(1, ns):
        sizes.append(zoom_size(*sizes[-1], zfactor))
    pyr = [(a, b)]
    for _ in range(1, ns):
        pa, pb = pyr[-1]
        pyr.append(tuple(_alone(p, lambda x: zoom_out(x, zfactor, consts)) for p in (pa, pb)))
    if fs >= ns:
        return a.new_zeros(a.shape + (2,))
    cw, ch = sizes[-1]
    u = a.new_zeros((a.shape[0], ch, cw, 2))
    for s in range(ns - 1, fs - 1, -1):
        u = solve_level(*pyr[s], u, tau, lambda_, theta, nwarps, epsilon, max_iters,
                        duals)
        if s > fs:
            u = _zoom_flow(u, *sizes[s - 1], zfactor, consts)
    for s in range(fs, 0, -1):
        u = _zoom_flow(u, *sizes[s - 1], zfactor, consts)
    return u
