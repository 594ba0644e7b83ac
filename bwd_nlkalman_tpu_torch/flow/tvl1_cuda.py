"""Wrapper of K2, the hand-written CUDA TV-L1 level solver (csrc/tvl1_level.cu).

Replaces the Pallas kernel ``bwd_nlkalman_tpu/flow/tvl1_fused.py:65``.
Its plain PyTorch version is
:func:`bwd_nlkalman_tpu_torch.flow.tvl1_fused.tvl1_level_plain`. One call
is one cooperative launch that runs the whole level, its stopping rule
included; it reads nothing back to the host.

The shard form, :func:`tvl1_level_round_cuda` (plain version
:func:`~bwd_nlkalman_tpu_torch.flow.tvl1_fused.tvl1_level_round_plain`),
runs one round of k iterations on a shard's row block and takes the
round's stop-or-go on the device (``tvl1_tile.RoundCtl``,
``parallel/flow.py``).

Both take ``state_dtype``: with "bfloat16" the kernel's other instance
rounds the dual planes to bfloat16 as each iteration stores them (the
JAX kernel's ``sdt``), and every operation on its own as the plain
version does, so that it gives the plain version's bits; there is no
plain fallback on a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import call, stream_ptr
from .._dispatch import LaunchCounter, check_state_dtype, check_tensor
from . import tvl1_tile

LAUNCHES = LaunchCounter()
ITERATIONS = LaunchCounter()   # primal-dual iterations run, all warp stages (on the device)


def tvl1_level_cuda(i0, i1, u_init, tau=0.25, lambda_=0.15, theta=0.3,
                    nwarps=5, epsilon=0.01, k_check=8, max_iters=300,
                    state_dtype: str = "float32"):
    """Kernel version of ``tvl1_level_plain``: (H, W, 2) flow of one level."""
    h, w = i0.shape
    dev = i0.device
    if dev.type != "cuda":
        raise ValueError("tvl1_level_cuda takes CUDA tensors")
    check_state_dtype(state_dtype)
    check_tensor(i0, "i0", (h, w), torch.float32, dev)
    check_tensor(i1, "i1", (h, w), torch.float32, dev)
    check_tensor(u_init, "u_init", (h, w, 2), torch.float32, dev)
    plan = tvl1_tile.tile_plan(
        h, w, sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    u = torch.empty_like(u_init)
    scratch = torch.empty(19 * h * w + 2 * plan.n_tiles, dtype=torch.float32, device=dev)
    call("bnlk_tvl1_level", i0.data_ptr(), i1.data_ptr(), u_init.data_ptr(), u.data_ptr(),
         scratch.data_ptr(), h, w, int(nwarps), float(tau), float(lambda_),
         float(theta), float(epsilon), int(k_check), int(max_iters), plan.kt,
         plan.rows, *plan.tiles, ITERATIONS.slot(dev).data_ptr(),
         int(state_dtype == "bfloat16"), ctypes.c_void_p(stream_ptr(dev)))
    LAUNCHES.add()
    return u


def round_cuda(entry: str, counter, state, consts, k, y0, h, halo, ctl, slot, r, count,
               scalars, bf16_duals: bool | None = None):
    """One launch of a round entry (K2's ``bnlk_tvl1_level_round`` or K3's
    ``bnlk_tvl1_stage_round``): round ``r`` of a warp stage on the (6, hb,
    W) row block ``state`` of an h-row level starting at row y0, which
    owns all but its ``halo`` = (top, bottom) rows, as shard ``slot`` of
    ``ctl`` (a ``tvl1_tile.RoundCtl`` on the state's device: the kernel
    takes the stop-or-go, and writes the owned rows' sum to
    ``ctl.sums[r % 2, slot]``); ``counter`` (a LaunchCounter) takes the
    device count where ``count``. Updates ``state`` in place; its scratch
    is allocated once a level, in ``ctl.buffers``. ``bf16_duals``: K2's
    instance flag; None for K3's entry, which takes none."""
    _, hb, w = state.shape
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"{entry} takes CUDA tensors")
    check_tensor(state, "state", (6, hb, w), torch.float32, dev)
    check_tensor(consts, "consts", (4, hb, w), torch.float32, dev)
    check_tensor(ctl.flag, "flag", (1,), torch.int32, dev)
    check_tensor(ctl.sums, "sums", (2, ctl.n), torch.float32, dev)
    top, bot = halo
    if k < 1 or y0 < 0 or y0 + hb > h or top < 0 or bot < 0 or top + bot >= hb \
            or not 0 <= slot < ctl.n or r < 0 or (ctl.h, ctl.w) != (h, w):
        raise ValueError(f"{entry}: bad round of {k} on rows {y0}..{y0 + hb - 1} "
                         f"(halo {halo}) of a {h}-row level")
    plan = tvl1_tile.tile_plan(
        hb, w, sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    bufs = ctl.buffers.get(slot)
    if bufs is None or bufs[0].shape != state.shape:
        bufs = ctl.buffers[slot] = (torch.empty_like(state),
                                    torch.empty(plan.n_tiles, dtype=torch.float32, device=dev))
    call(entry, state.data_ptr(), consts.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
         ctl.sums.data_ptr(), ctl.flag.data_ptr(),
         counter.slot(dev).data_ptr() if count else None, h, w, hb, int(y0), top, hb - bot,
         int(k), int(slot), ctl.n, int(r), ctl.epsilon, *scalars, plan.kt, plan.rows,
         *plan.tiles, *(() if bf16_duals is None else (int(bf16_duals),)),
         ctypes.c_void_p(stream_ptr(dev)))
    return state


def tvl1_level_round_cuda(state, consts, k, y0, h, halo, ctl, slot=0, r=0, count=False,
                          tau=0.25, lambda_=0.15, theta=0.3, state_dtype: str = "float32"):
    """Kernel version of ``tvl1_level_round_plain`` (K2's rule; consts =
    i1wx, i1wy, nig, rho_c) under ``ctl``'s stop-or-go (``round_cuda``):
    one launch, counted in ``LAUNCHES``; where ``count``, the iterations
    run go to ``ITERATIONS``. Returns ``state``."""
    check_state_dtype(state_dtype)
    out = round_cuda("bnlk_tvl1_level_round", ITERATIONS, state, consts, k, y0, h, halo,
                     ctl, slot, r, count, (float(tau), float(lambda_), float(theta)),
                     bf16_duals=state_dtype == "bfloat16")
    LAUNCHES.add()
    return out
