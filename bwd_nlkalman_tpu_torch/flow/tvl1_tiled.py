"""TV-L1 level solver at the semantics of the JAX tiled kernel (K3).

Port of ``bwd_nlkalman_tpu.flow.tvl1_pallas``: the solver the JAX package
takes for a level beyond K2's plan (``fused_level_supported``), such as
the 1080x1920 level of a full-resolution (fscale=0) flow. The warp and
the constants run outside the kernel, once per warp stage
(tvl1_pallas.py:269-285): (I1, I1x, I1y) warped along u, then grad =
|grad I1w|^2 and rho_c, :func:`tvl1_stage_consts`; on CUDA tensors that is
one launch of K4's TV-L1 entry, which reads u from the state and writes
the four constant planes. The iterations run in blocks of
``K_ITERS``: on CUDA tensors a warp stage's blocks, stopping rule
included, are one launch of the hand-written kernel K3
(``tvl1_block_cuda.py``), with no host read; on CPU tensors
:func:`tvl1_stage_plain` loops over :func:`tvl1_block_plain`, the same
arithmetic in plain PyTorch:

- the where form of the threshold step with the lo/hi masks and
  fi = -rho / max(grad, 1e-10) (tvl1_pallas.py:101-110);
- l_t = lambda * theta as a Python-float product (:64);
- the divergence with the reference's border rules (:112-121);
- the mean squared update of a block's last iteration over the frame,
  divided by h*w (:156-159, 237).

The stopping rule is the TPU solver's (:287-301): blocks of K_ITERS
whatever the level size, tested with ``n < max_iters`` and
``n += K_ITERS``, so a level may run 312 iterations for a cap of 300.
The dual planes start at zero for each level and carry across its warp
stages (:267, 310).

The shard form (``parallel/flow.py``) runs a level on row blocks, one
block of iterations at a time: :func:`tvl1_stage_round` (K3's round entry
on CUDA tensors, :func:`tvl1_stage_round_plain` on CPU tensors), with the
constants of each block's rows from :func:`tvl1_stage_consts` given the
block's first row.
"""

from __future__ import annotations

import numpy as np
import torch

from .._dispatch import use_kernel
from ..ops.grad import centered_gradient, divergence, forward_gradient
from ..ops.warp_cuda import warp_tvl1_consts_cuda
from .tvl1_block_cuda import tvl1_block_cuda, tvl1_stage_cuda, tvl1_stage_round_cuda
from .tvl1_fused import check_round, edge_rows, padded, tvl1_stage_consts_plain

GRAD_IS_ZERO = 1e-10  # tvl1flow_lib.c:26
K_ITERS = 24          # iterations per block (tvl1_pallas.py:32)


def _one_iter(st, cs, l_t, theta, taut):
    u1, u2, p11, p12, p21, p22 = st
    i1wx, i1wy, grad, rho_c = cs
    rho = rho_c + i1wx * u1 + i1wy * u2
    fi = torch.where(grad < GRAD_IS_ZERO, 0.0,
                     -rho / torch.clamp(grad, min=GRAD_IS_ZERO))
    lo = rho < -l_t * grad
    hi = rho > l_t * grad
    d1 = torch.where(lo, l_t * i1wx, torch.where(hi, -l_t * i1wx, fi * i1wx))
    d2 = torch.where(lo, l_t * i1wy, torch.where(hi, -l_t * i1wy, fi * i1wy))
    u1n = (u1 + d1) + theta * divergence(p11, p12)
    u2n = (u2 + d2) + theta * divergence(p21, p22)
    u1x, u1y = forward_gradient(u1n)
    u2x, u2y = forward_gradient(u2n)
    ng1 = 1.0 + taut * torch.sqrt(u1x * u1x + u1y * u1y)
    ng2 = 1.0 + taut * torch.sqrt(u2x * u2x + u2y * u2y)
    return torch.stack([u1n, u2n, (p11 + taut * u1x) / ng1,
                        (p12 + taut * u1y) / ng1, (p21 + taut * u2x) / ng2,
                        (p22 + taut * u2y) / ng2])


def _iterate(state, consts, k_iters, tau, lambda_, theta):
    """(state after ``k_iters`` iterations, the state before the last)."""
    # the TPU kernel's scalars: Python floats, rounded to f32 where used
    l_t = float(np.float32(lambda_ * theta))
    taut = float(np.float32(tau / theta))
    theta = float(np.float32(theta))
    for _ in range(k_iters):
        prev = state
        state = _one_iter(state, consts, l_t, theta, taut)
    return state, prev


def _sq_update(state, prev):
    du = state[:2] - prev[:2]
    return torch.sum(du[0] * du[0]) + torch.sum(du[1] * du[1])


def tvl1_block_plain(state, consts, k_iters, tau=0.25, lambda_=0.15, theta=0.3):
    """Plain version of K3: ``k_iters`` iterations of the (6, H, W) state
    {u1, u2, p11, p12, p21, p22} against the (4, H, W) constants {i1wx,
    i1wy, grad, rho_c}. Returns (new state, mean squared update of the
    last iteration as a 0-d tensor)."""
    _, h, w = state.shape
    state, prev = _iterate(state, consts, k_iters, tau, lambda_, theta)
    return state, _sq_update(state, prev) / (h * w)


def tvl1_stage_round_plain(state, consts, k, y0, h, halo, tau=0.25, lambda_=0.15,
                           theta=0.3):
    """Plain version of K3's round entry: a block of ``k`` iterations of
    :func:`tvl1_block_plain` on the (6, hb, W) state block of the level's
    rows y0 .. y0 + hb - 1 (h rows in all), the border rules at the level's
    edges only, whose ``halo`` = (top, bottom) rows are a neighbour's (as
    ``tvl1_level_round_plain``). Returns (new block, the sum of the squared
    update of the last iteration over its own rows, 0-d)."""
    check_round(state, k, y0, h, halo)
    pad = edge_rows(y0, state.shape[1], h)
    state, prev = _iterate(padded(state, pad), padded(consts, pad), k, tau, lambda_, theta)
    own = slice(pad[0] + halo[0], state.shape[1] - pad[1] - halo[1])
    return (state[:, pad[0]:state.shape[1] - pad[1]].contiguous(),
            _sq_update(state[:, own], prev[:, own]))


def tvl1_stage_round(state, consts, k, y0, h, halo, ctl, slot, r, count=False, tau=0.25,
                     lambda_=0.15, theta=0.3, engine: str = "auto"):
    """Round ``r`` of K3's rule on shard ``slot``'s block under ``ctl``'s
    stop-or-go (``tvl1_tile.RoundCtl``): K3's round entry on CUDA tensors
    (updates ``state`` in place), its plain version on CPU tensors. Returns
    the block; its owned sum is in ``ctl.sums``."""
    kw = dict(tau=tau, lambda_=lambda_, theta=theta)
    if use_kernel(state, engine):
        return tvl1_stage_round_cuda(state, consts, k, y0, h, halo, ctl, slot, r, count, **kw)
    return ctl.run_plain(tvl1_stage_round_plain, state, consts, k, y0, h, halo, slot, r, **kw)


def tvl1_block(state, consts, k_iters, tau=0.25, lambda_=0.15, theta=0.3,
               engine: str = "auto"):
    """K3 on CUDA tensors, its plain version on CPU tensors.

    ``engine="plain"`` runs the plain version on any device."""
    if use_kernel(state, engine):
        return tvl1_block_cuda(state, consts, k_iters, tau, lambda_, theta)
    return tvl1_block_plain(state, consts, k_iters, tau, lambda_, theta)


def tvl1_stage_plain(state, consts, k_iters, max_iters, epsilon, tau=0.25,
                     lambda_=0.15, theta=0.3):
    """Plain version of K3's stage entry: blocks of ``k_iters`` iterations
    while the last block's mean squared update exceeds epsilon^2 and fewer
    than ``max_iters`` iterations ran (tvl1_pallas.py:287-301). One host
    read per block. Returns (new state, blocks run)."""
    eps2 = float(np.float32(epsilon * epsilon))
    err, n, blocks = float("inf"), 0, 0
    while err > eps2 and n < max_iters:
        state, err_t = tvl1_block(state, consts, k_iters, tau, lambda_, theta,
                                  engine="plain")
        err = float(err_t)
        n += k_iters
        blocks += 1
    return state, blocks


def tvl1_stage_consts(i1s, state, i0, engine: str = "auto", y0: int = 0,
                      nig: bool = False, state_dtype: str = "float32"):
    """K4's TV-L1 entry on CUDA tensors, its plain version on CPU tensors;
    ``y0`` and ``nig`` as :func:`tvl1_stage_consts_plain`'s. With ``nig``,
    ``state_dtype`` is that of the K2 rule the constants are for: the
    kernel's bfloat16 form rounds each operation on its own, as the plain
    version does in either.

    ``engine="plain"`` runs the plain version on any device."""
    if use_kernel(i0, engine):
        return warp_tvl1_consts_cuda(i1s, state, i0, y0, nig, state_dtype)
    return tvl1_stage_consts_plain(i1s, state, i0, y0, nig)


def tvl1_single_scale_tiled(i0, i1, u_init, tau=0.25, lambda_=0.15, theta=0.3,
                            nwarps=5, epsilon=0.01, max_iters=300,
                            engine: str = "auto"):
    """One TV-L1 level (tvl1_single_scale_pallas, tvl1_pallas.py:240).

    i0, i1: (H, W) float32; u_init: (H, W, 2). Returns (H, W, 2). On CUDA
    tensors no host sync: each warp stage is two launches, K4's TV-L1
    entry (the warp and the constants) and K3."""
    h, w = i0.shape
    i1x, i1y = centered_gradient(i1)
    i1s = torch.stack([i1, i1x, i1y], dim=-1)
    kernel = use_kernel(i0, engine)
    state = torch.cat([u_init.permute(2, 0, 1).to(torch.float32),
                       i0.new_zeros((4, h, w))])
    for _ in range(nwarps):
        consts = tvl1_stage_consts(i1s, state, i0, engine)
        stage = tvl1_stage_cuda if kernel else tvl1_stage_plain
        state = stage(state, consts, K_ITERS, max_iters, epsilon, tau, lambda_,
                      theta)[0]
    return state[:2].permute(1, 2, 0).contiguous()


def tvl1_level_tiled_plain(i0, i1, u_init, **kw):
    """The plain version of the whole level: plain warps and plain blocks."""
    return tvl1_single_scale_tiled(i0, i1, u_init, engine="plain", **kw)
