"""Wrapper of K4, the hand-written CUDA bicubic warp (csrc/warp.cu).

Replaces the Pallas kernel ``bwd_nlkalman_tpu/ops/warp_pallas.py:59``.
Its plain PyTorch version is :func:`bwd_nlkalman_tpu_torch.ops.warp.bicubic_warp_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import call, stream_ptr
from .._dispatch import LaunchCounter, check_tensor

LAUNCHES = LaunchCounter()


def bicubic_warp_cuda(im: torch.Tensor, flow: torch.Tensor,
                      occl: torch.Tensor | None = None):
    """Kernel version of ``bicubic_warp_plain``: (out (H, W, C), valid (H, W))."""
    h, w, c = im.shape
    dev = im.device
    if dev.type != "cuda":
        raise ValueError("bicubic_warp_cuda takes CUDA tensors")
    check_tensor(im, "im", (h, w, c), torch.float32, dev)
    check_tensor(flow, "flow", (h, w, 2), torch.float32, dev)
    if occl is not None:
        check_tensor(occl, "occl", (h, w), torch.float32, dev)
    if not 1 <= c <= 8:
        raise ValueError(f"K4 supports 1..8 channels, got {c}")
    out = torch.empty((h, w, c), dtype=torch.float32, device=dev)
    valid = torch.empty((h, w), dtype=torch.uint8, device=dev)
    call("bnlk_warp", im.data_ptr(), flow.data_ptr(),
         None if occl is None else occl.data_ptr(), out.data_ptr(),
         valid.data_ptr(), h, w, c, ctypes.c_void_p(stream_ptr(dev)))
    LAUNCHES.add()
    return out, valid.bool()
