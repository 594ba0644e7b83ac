"""Wrapper of K2, the hand-written CUDA TV-L1 level solver (csrc/tvl1_level.cu).

Replaces the Pallas kernel ``bwd_nlkalman_tpu/flow/tvl1_fused.py:65``.
Its plain PyTorch version is
:func:`bwd_nlkalman_tpu_torch.flow.tvl1_fused.tvl1_level_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import call, stream_ptr
from .._dispatch import LaunchCounter, check_tensor
from ..ops.grad import centered_gradient

LAUNCHES = LaunchCounter()
ITERATIONS = LaunchCounter()   # primal-dual iterations run, all warp stages


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
    i1x, i1y = centered_gradient(i1)
    i1s = torch.stack([i1, i1x, i1y], dim=-1).contiguous()
    u = u_init.permute(2, 0, 1).contiguous()
    n_part = -(-w // 32) * -(-h // 8)
    scratch = torch.empty(16 * h * w + n_part + 1, dtype=torch.float32, device=dev)
    iters = ctypes.c_int(0)
    call("bnlk_tvl1_level", i0.data_ptr(), i1s.data_ptr(), u.data_ptr(),
         scratch.data_ptr(), h, w, int(nwarps), float(tau), float(lambda_),
         float(theta), float(epsilon), int(k_check), int(max_iters),
         ctypes.addressof(iters), ctypes.c_void_p(stream_ptr(dev)))
    LAUNCHES.add()
    ITERATIONS.add(iters.value)
    return u.permute(1, 2, 0).contiguous()
