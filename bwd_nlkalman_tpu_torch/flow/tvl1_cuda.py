"""Wrapper of K2, the hand-written CUDA TV-L1 level solver (csrc/tvl1_level.cu).

Replaces the Pallas kernel ``bwd_nlkalman_tpu/flow/tvl1_fused.py:65``.
Its plain PyTorch version is
:func:`bwd_nlkalman_tpu_torch.flow.tvl1_fused.tvl1_level_plain`. One call
is one cooperative launch that runs the whole level, its stopping rule
included; it reads nothing back to the host.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import call, stream_ptr
from .._dispatch import LaunchCounter, check_tensor
from . import tvl1_tile

LAUNCHES = LaunchCounter()
ITERATIONS = LaunchCounter()   # primal-dual iterations run, all warp stages (on the device)


def tvl1_level_cuda(i0, i1, u_init, tau=0.25, lambda_=0.15, theta=0.3,
                    nwarps=5, epsilon=0.01, k_check=8, max_iters=300):
    """Kernel version of ``tvl1_level_plain``: (H, W, 2) flow of one level."""
    h, w = i0.shape
    dev = i0.device
    if dev.type != "cuda":
        raise ValueError("tvl1_level_cuda takes CUDA tensors")
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
         ctypes.c_void_p(stream_ptr(dev)))
    LAUNCHES.add()
    return u
