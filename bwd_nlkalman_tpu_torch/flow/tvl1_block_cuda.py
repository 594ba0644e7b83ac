"""Wrapper of K3, the hand-written CUDA TV-L1 iteration block (csrc/tvl1_block.cu).

Replaces the Pallas kernel ``bwd_nlkalman_tpu/flow/tvl1_pallas.py:52``
(``_tvl1_block_kernel``, driven by ``tvl1_iter_block``). Its plain
PyTorch version is
:func:`bwd_nlkalman_tpu_torch.flow.tvl1_tiled.tvl1_block_plain`. One call
runs ``k_iters`` iterations (one launch each) and the error sum, and
counts as one launch of K3.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import call, stream_ptr
from .._dispatch import LaunchCounter, check_tensor

LAUNCHES = LaunchCounter()


def tvl1_block_cuda(state, consts, k_iters, tau=0.25, lambda_=0.15, theta=0.3):
    """Kernel version of ``tvl1_block_plain``: (new state (6, H, W), err)."""
    _, h, w = state.shape
    dev = state.device
    if dev.type != "cuda":
        raise ValueError("tvl1_block_cuda takes CUDA tensors")
    check_tensor(state, "state", (6, h, w), torch.float32, dev)
    check_tensor(consts, "consts", (4, h, w), torch.float32, dev)
    if k_iters < 1 or h < 2 or w < 2:
        raise ValueError(f"K3 needs k_iters >= 1 and a level of at least 2x2, "
                         f"got {k_iters} on {h}x{w}")
    out = torch.empty_like(state)
    tmp = torch.empty_like(state)
    partials = torch.empty(-(-w // 32) * -(-h // 8), dtype=torch.float32, device=dev)
    err = torch.empty((), dtype=torch.float32, device=dev)
    call("bnlk_tvl1_block", state.data_ptr(), consts.data_ptr(), out.data_ptr(),
         tmp.data_ptr(), partials.data_ptr(), err.data_ptr(), h, w, int(k_iters),
         float(tau), float(lambda_), float(theta), ctypes.c_void_p(stream_ptr(dev)))
    LAUNCHES.add()
    return out, err
