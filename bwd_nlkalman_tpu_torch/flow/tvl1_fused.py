"""Whole-level TV-L1 solver at the semantics of the JAX fused kernel (K2).

Port of ``bwd_nlkalman_tpu.flow.tvl1_fused``. On CUDA tensors a level is
solved by the hand-written kernel K2 (``tvl1_cuda.py``); on CPU tensors
by :func:`tvl1_level_plain`, the same algorithm in plain PyTorch:

- the clamp form of the threshold step, fi = clip(rho * nig, -l_t, l_t)
  with nig = -1/|grad I1w|^2 guarded at 1e-10 (tvl1_fused.py:200-209,
  236-242);
- dual planes zero at the last column / row, and the divergence that
  follows from that (:89-103, 243-253);
- the mean squared update over in-frame pixels, measured on the last
  iteration of each round of ``k_check`` iterations only (:268-285), so
  the iteration count rises in whole rounds.
"""

from __future__ import annotations

import numpy as np
import torch

from .._dispatch import use_kernel
from ..ops.grad import centered_gradient
from ..ops.warp import warp_bicubic_zero_multi
from .tvl1_cuda import tvl1_level_cuda

GRAD_IS_ZERO = 1e-10  # tvl1flow_lib.c:26
_G = 4                # warp pad width of the TPU kernel's plan


def _plan(h: int, w: int) -> tuple[int, int, int]:
    """The JAX kernel's VMEM plan (tvl1_fused.py:302-307), kept as the
    dispatch rule between K2 and the tiled K3 so both packages solve the
    same levels with the same kernel."""
    hp = max(-(-h // 8) * 8, 8)
    ln = max(-(-(w + 2 * _G + 3) // 128) * 128, 128)
    vmem = (10 + 1 + 2 + 2) * hp * ln * 4 + 3 * (hp + 11) * ln * 4
    return hp, ln, vmem


def fused_level_supported(h: int, w: int, budget: int = 90 * 1024 * 1024) -> bool:
    return _plan(h, w)[2] < budget


def _one_iter(U, PA, PB, IG, nig, rho_c, l_t, theta, taut):
    t = IG * U
    rho = rho_c + t[0] + t[1]
    fi = torch.clamp(rho * nig, -l_t, l_t)[None]
    V = U + fi * IG
    zc = torch.zeros_like(PA[..., :1])
    zr = torch.zeros_like(PB[:, :1])
    DIV = (PA - torch.cat([zc, PA[..., :-1]], dim=-1)) \
        + (PB - torch.cat([zr, PB[:, :-1]], dim=1))
    Un = V + theta * DIV
    UX = torch.cat([Un[..., 1:] - Un[..., :-1], zc], dim=-1)
    UY = torch.cat([Un[:, 1:] - Un[:, :-1], zr], dim=1)
    G = torch.sqrt(UX * UX + UY * UY)
    R = 1.0 / (1.0 + taut * G)
    return Un, (PA + taut * UX) * R, (PB + taut * UY) * R


def tvl1_level_plain(i0, i1, u_init, tau=0.25, lambda_=0.15, theta=0.3,
                     nwarps=5, epsilon=0.01, k_check=8, max_iters=300):
    """Plain version of K2. i0, i1: (H, W) float32; u_init: (H, W, 2)."""
    h, w = i0.shape
    i1x, i1y = centered_gradient(i1)
    i1s = torch.stack([i1, i1x, i1y], dim=-1)
    l_t = float(np.float32(lambda_) * np.float32(theta))
    taut = tau / theta
    eps2 = float(np.float32(epsilon * epsilon))
    U = u_init.permute(2, 0, 1).to(torch.float32)      # (2, H, W)
    PA = torch.zeros_like(U)   # (p11, p21): x-difference duals
    PB = torch.zeros_like(U)   # (p12, p22): y-difference duals
    for _ in range(nwarps):
        wrp = warp_bicubic_zero_multi(i1s, U[0], U[1], engine="plain")
        i1w, i1wx, i1wy = wrp[..., 0], wrp[..., 1], wrp[..., 2]
        grad = i1wx * i1wx + i1wy * i1wy
        nig = torch.where(grad < GRAD_IS_ZERO, 0.0,
                          -1.0 / torch.clamp(grad, min=GRAD_IS_ZERO))
        rho_c = i1w - i1wx * U[0] - i1wy * U[1] - i0
        IG = torch.stack([i1wx, i1wy])
        err, n = float("inf"), 0
        while err > eps2 and n < max_iters:
            for _ in range(k_check):
                Up = U
                U, PA, PB = _one_iter(U, PA, PB, IG, nig, rho_c, l_t, theta, taut)
            dU = U - Up
            err = float(torch.sum(dU * dU) / (h * w))
            n += k_check
    return U.permute(1, 2, 0).contiguous()


def tvl1_single_scale_fused(i0, i1, u_init, tau=0.25, lambda_=0.15, theta=0.3,
                            nwarps=5, epsilon=0.01, k_check=8, max_iters=300,
                            engine: str = "auto"):
    """One TV-L1 level: K2 on CUDA tensors, its plain version on CPU tensors.

    ``engine="plain"`` runs the plain version on any device."""
    kw = dict(tau=tau, lambda_=lambda_, theta=theta, nwarps=nwarps,
              epsilon=epsilon, k_check=k_check, max_iters=max_iters)
    if use_kernel(i0, engine):
        return tvl1_level_cuda(i0, i1, u_init, **kw)
    return tvl1_level_plain(i0, i1, u_init, **kw)
