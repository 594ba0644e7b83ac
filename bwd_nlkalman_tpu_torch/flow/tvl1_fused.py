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
  the iteration count rises in whole rounds;
- ``state_dtype``: with "bfloat16" the four dual planes are rounded to
  bfloat16 after every iteration, the last of a round included (the JAX
  kernel's ``sdt``, :276, 285), while u, the warp constants and all the
  arithmetic stay float32. Nothing reads the JAX package's
  ``BNLK_TVL1_STATE_DTYPE``: the caller passes the type.

The shard form (``parallel/flow.py``) runs a level on row blocks, one
round at a time: :func:`tvl1_level_round` (K2's round entry on CUDA
tensors, :func:`tvl1_level_round_plain` on CPU tensors).
"""

from __future__ import annotations

import numpy as np
import torch

from .._dispatch import check_state_dtype, use_kernel
from ..ops.grad import centered_gradient
from ..ops.warp import bicubic_warp
from .tvl1_cuda import tvl1_level_cuda, tvl1_level_round_cuda

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


def _store_duals(PA, PB, state_dtype: str):
    """The dual planes as an iteration stores them: rounded to bfloat16 and
    widened back where ``state_dtype`` is "bfloat16" (tvl1_fused.py:276)."""
    if state_dtype == "bfloat16":
        return PA.to(torch.bfloat16).float(), PB.to(torch.bfloat16).float()
    return PA, PB


def tvl1_stage_consts_plain(i1s, state, i0, y0: int = 0, nig: bool = False):
    """Plain version of K4's TV-L1 entry: the (4, hb, W) constants {i1wx,
    i1wy, grad, rho_c} of a warp stage (tvl1_pallas.py:272-275) from i1s
    (H, W, 3) = (I1, I1x, I1y), the state whose first planes are u1 and u2
    (hb rows), and i0 (hb, W), for the frame's rows y0 .. y0 + hb - 1 (the
    whole frame by default). Where a tap leaves the frame the three
    samples are 0, so there rho_c = -i0. With ``nig``, K2's form: the third
    plane is nig = -1 / grad, zero where grad < 1e-10 (:200-209), as
    :func:`tvl1_level_plain` takes it. K3's path (``tvl1_tiled.py``) takes
    the grad form."""
    u1, u2 = state[0], state[1]
    wrp, _ = bicubic_warp(i1s.contiguous(), torch.stack([u1, u2], dim=-1), None,
                          "plain", y0)
    i1w, i1wx, i1wy = wrp.unbind(-1)
    grad = i1wx * i1wx + i1wy * i1wy
    if nig:
        grad = torch.where(grad < GRAD_IS_ZERO, 0.0, -1.0 / torch.clamp(grad, min=GRAD_IS_ZERO))
    return torch.stack([i1wx, i1wy, grad, i1w - i1wx * u1 - i1wy * u2 - i0])


def tvl1_level_plain(i0, i1, u_init, tau=0.25, lambda_=0.15, theta=0.3,
                     nwarps=5, epsilon=0.01, k_check=8, max_iters=300,
                     state_dtype: str = "float32"):
    """Plain version of K2. i0, i1: (H, W) float32; u_init: (H, W, 2)."""
    check_state_dtype(state_dtype)
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
        cs = tvl1_stage_consts_plain(i1s, U, i0, nig=True)
        IG, nig, rho_c = cs[:2], cs[2], cs[3]
        err, n = float("inf"), 0
        while err > eps2 and n < max_iters:
            for _ in range(k_check):
                Up = U
                U, PA, PB = _one_iter(U, PA, PB, IG, nig, rho_c, l_t, theta, taut)
                PA, PB = _store_duals(PA, PB, state_dtype)
            dU = U - Up
            err = float(torch.sum(dU * dU) / (h * w))
            n += k_check
    return U.permute(1, 2, 0).contiguous()


def tvl1_single_scale_fused(i0, i1, u_init, tau=0.25, lambda_=0.15, theta=0.3,
                            nwarps=5, epsilon=0.01, k_check=8, max_iters=300,
                            state_dtype: str = "float32", engine: str = "auto"):
    """One TV-L1 level: K2 on CUDA tensors, its plain version on CPU tensors.

    ``engine="plain"`` runs the plain version on any device."""
    kw = dict(tau=tau, lambda_=lambda_, theta=theta, nwarps=nwarps,
              epsilon=epsilon, k_check=k_check, max_iters=max_iters,
              state_dtype=state_dtype)
    if use_kernel(i0, engine):
        return tvl1_level_cuda(i0, i1, u_init, **kw)
    return tvl1_level_plain(i0, i1, u_init, **kw)


def check_round(state, k, y0, h, halo) -> None:
    """Raise unless the (6, hb, W) block of rows y0 .. y0 + hb - 1 of an
    h-row level keeps k rows of halo wherever an edge of its own rows is
    not an edge of the level: the reach of a round of k iterations."""
    hb = state.shape[1]
    top, bot = halo
    if k < 1 or y0 < 0 or y0 + hb > h or top + bot >= hb \
            or (top < k and y0 != 0) or (bot < k and y0 + hb != h):
        raise ValueError(f"a round of {k} iterations on rows {y0}..{y0 + hb - 1} "
                         f"(halo {halo}) of a {h}-row level")


def edge_rows(y0: int, hb: int, h: int) -> tuple[int, int]:
    """The zero rows a round pads a block of rows y0 .. y0 + hb - 1 with,
    above and below, where its edge is not the level's: there the level's
    border rules must not apply, and the rows beyond read zeros, as the
    kernels' tiles do (csrc/tvl1_tile.cuh)."""
    return int(y0 > 0), int(y0 + hb < h)


def padded(x, pad):
    """x (planes, hb, W) with pad = (above, below) zero rows."""
    z = x.new_zeros((x.shape[0], 1, x.shape[2]))
    return torch.cat([z] * pad[0] + [x] + [z] * pad[1], dim=1)


def tvl1_level_round_plain(state, consts, k, y0, h, halo, tau=0.25, lambda_=0.15,
                           theta=0.3, state_dtype: str = "float32"):
    """Plain version of K2's round entry: ``k`` iterations of
    :func:`tvl1_level_plain` on the (6, hb, W) state block {u1, u2, p11,
    p12, p21, p22} of the level's rows y0 .. y0 + hb - 1 (h rows in all),
    with the (4, hb, W) constants {i1wx, i1wy, nig, rho_c}. The border
    rules apply at the level's edges only (:func:`edge_rows`). Its
    ``halo`` = (top, bottom) rows are a neighbour's, k of them where the
    block's edge is not the level's: the zeros read past that edge reach
    one row further each iteration, so they stay in the halo
    (:func:`check_round`). Returns (new block, the sum of the squared
    update of the last iteration over its own rows, 0-d): the level's error
    is the sum over every shard, divided by its pixels. ``state_dtype`` as
    :func:`tvl1_level_plain`'s: the rounding is pointwise, so a block's own
    rows still equal the whole level's."""
    check_state_dtype(state_dtype)
    check_round(state, k, y0, h, halo)
    pad = edge_rows(y0, state.shape[1], h)
    st, cs = padded(state, pad), padded(consts, pad)
    l_t = float(np.float32(lambda_) * np.float32(theta))
    taut = tau / theta
    U, PA, PB = st[:2], st[2::2], st[3::2]
    IG, nig, rho_c = cs[:2], cs[2], cs[3]
    for _ in range(k):
        Up = U
        U, PA, PB = _one_iter(U, PA, PB, IG, nig, rho_c, l_t, theta, taut)
        PA, PB = _store_duals(PA, PB, state_dtype)
    rows = slice(pad[0], st.shape[1] - pad[1])
    dU = (U - Up)[:, pad[0] + halo[0]:st.shape[1] - pad[1] - halo[1]]
    return (torch.stack([U[0], U[1], PA[0], PB[0], PA[1], PB[1]])[:, rows].contiguous(),
            torch.sum(dU * dU))


def tvl1_level_round(state, consts, k, y0, h, halo, ctl, slot, r, count=False, tau=0.25,
                     lambda_=0.15, theta=0.3, state_dtype: str = "float32",
                     engine: str = "auto"):
    """Round ``r`` of K2's rule on shard ``slot``'s block under ``ctl``'s
    stop-or-go (``tvl1_tile.RoundCtl``): K2's round entry on CUDA tensors
    (updates ``state`` in place), its plain version on CPU tensors. Returns
    the block; its owned sum is in ``ctl.sums``."""
    kw = dict(tau=tau, lambda_=lambda_, theta=theta, state_dtype=state_dtype)
    if use_kernel(state, engine):
        return tvl1_level_round_cuda(state, consts, k, y0, h, halo, ctl, slot, r, count, **kw)
    return ctl.run_plain(tvl1_level_round_plain, state, consts, k, y0, h, halo, slot, r, **kw)
