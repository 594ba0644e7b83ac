"""Wrapper of K3, the hand-written CUDA TV-L1 stage solver (csrc/tvl1_block.cu).

Replaces the Pallas kernel ``bwd_nlkalman_tpu/flow/tvl1_pallas.py:52``
(``_tvl1_block_kernel``, driven by ``tvl1_iter_block`` in a device
``while_loop``). Its plain PyTorch versions are
:func:`bwd_nlkalman_tpu_torch.flow.tvl1_tiled.tvl1_stage_plain` (a warp
stage's blocks with the stopping rule) and
:func:`~bwd_nlkalman_tpu_torch.flow.tvl1_tiled.tvl1_block_plain` (one
block). One call is one cooperative launch that runs a warp stage's
blocks of ``k_iters`` iterations until the stopping rule holds, and reads
nothing back to the host; ``LAUNCHES`` counts the blocks run, on the
device.

The shard form, :func:`tvl1_stage_round_cuda` (plain version
:func:`~bwd_nlkalman_tpu_torch.flow.tvl1_tiled.tvl1_stage_round_plain`),
runs one block of k iterations on a shard's row block and takes its
stop-or-go on the device (``tvl1_tile.RoundCtl``, ``parallel/flow.py``).
"""

from __future__ import annotations

import ctypes

import torch

from .._build import call, stream_ptr
from .._dispatch import LaunchCounter, check_tensor
from . import tvl1_tile
from .tvl1_cuda import round_cuda

LAUNCHES = LaunchCounter()     # blocks of k_iters iterations run (on the device)


def tvl1_stage_cuda(state, consts, k_iters, max_iters, epsilon, tau=0.25,
                    lambda_=0.15, theta=0.3):
    """Kernel version of ``tvl1_stage_plain``. Updates ``state`` (6, H, W)
    in place; returns (state, blocks run as a 1-element int32 tensor on the
    card, mean squared update of the last block as a 0-d tensor on the
    card)."""
    _, h, w = state.shape
    dev = state.device
    if dev.type != "cuda":
        raise ValueError("tvl1_stage_cuda takes CUDA tensors")
    check_tensor(state, "state", (6, h, w), torch.float32, dev)
    check_tensor(consts, "consts", (4, h, w), torch.float32, dev)
    if k_iters < 1 or h < 2 or w < 2:
        raise ValueError(f"K3 needs k_iters >= 1 and a level of at least 2x2, "
                         f"got {k_iters} on {h}x{w}")
    plan = tvl1_tile.tile_plan(
        h, w, sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    tmp = torch.empty_like(state)
    partials = torch.empty(2 * plan.n_tiles, dtype=torch.float32, device=dev)
    err = torch.empty((), dtype=torch.float32, device=dev)
    blocks = torch.empty(1, dtype=torch.int32, device=dev)
    call("bnlk_tvl1_stage", state.data_ptr(), consts.data_ptr(), tmp.data_ptr(),
         partials.data_ptr(), err.data_ptr(), blocks.data_ptr(),
         LAUNCHES.slot(dev).data_ptr(), h, w, int(k_iters), int(max_iters),
         float(tau), float(lambda_), float(theta), float(epsilon), plan.kt,
         plan.rows, *plan.tiles, ctypes.c_void_p(stream_ptr(dev)))
    return state, blocks, err


def tvl1_block_cuda(state, consts, k_iters, tau=0.25, lambda_=0.15, theta=0.3):
    """Kernel version of ``tvl1_block_plain``: one block of ``k_iters``
    iterations, the stage entry with ``max_iters = k_iters``. Returns (new
    state, mean squared update of the last iteration)."""
    out, _, err = tvl1_stage_cuda(state.clone(), consts, k_iters, k_iters, 0.0, tau,
                                  lambda_, theta)
    return out, err


def tvl1_stage_round_cuda(state, consts, k, y0, h, halo, ctl, slot=0, r=0, count=False,
                          tau=0.25, lambda_=0.15, theta=0.3):
    """Kernel version of ``tvl1_stage_round_plain`` (K3's rule; consts =
    i1wx, i1wy, grad, rho_c) under ``ctl``'s stop-or-go
    (``tvl1_cuda.round_cuda``): one launch; where ``count``, the block run
    is added to ``LAUNCHES`` on the device. Returns ``state``."""
    return round_cuda("bnlk_tvl1_stage_round", LAUNCHES, state, consts, k, y0, h, halo,
                      ctl, slot, r, count, (float(tau), float(lambda_), float(theta)))
