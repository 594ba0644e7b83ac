"""Wrapper of K4, the hand-written CUDA bicubic warp (csrc/warp.cu).

Replaces the Pallas kernel ``bwd_nlkalman_tpu/ops/warp_pallas.py:59``.
Its plain PyTorch versions are
:func:`bwd_nlkalman_tpu_torch.ops.warp.bicubic_warp_plain` (the warp) and
:func:`bwd_nlkalman_tpu_torch.flow.tvl1_tiled.tvl1_stage_consts_plain`
(the TV-L1 entry: a warp stage's constants, from the same launch).
"""

from __future__ import annotations

import ctypes

import torch

from .._build import call, stream_ptr
from .._dispatch import LaunchCounter, check_tensor

MAX_C = 9          # channels the kernel takes (kK4MaxC, csrc/warp_tap.cuh)

LAUNCHES = LaunchCounter()     # wrapper calls, both entries
LAUNCHES_C9 = LaunchCounter()  # of those, warps of 9 channels (fsmo on RGB)


def _check_frame(h: int, w: int, c: int) -> None:
    if h < 1 or w < 1:
        raise ValueError(f"empty frame {h}x{w}")
    if not 1 <= c <= MAX_C:
        raise ValueError(f"K4 supports 1..{MAX_C} channels, got {c}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data is not 8-byte aligned: the kernel
    reads a pixel's flow, and a tap of an even channel count, as float2."""
    return t if t.data_ptr() % 8 == 0 else t.clone()


def bicubic_warp_cuda(im: torch.Tensor, flow: torch.Tensor,
                      occl: torch.Tensor | None = None):
    """Kernel version of ``bicubic_warp_plain``: (out (H, W, C), valid (H, W))."""
    h, w, c = im.shape
    _check_frame(h, w, c)
    dev = im.device
    if dev.type != "cuda":
        raise ValueError("bicubic_warp_cuda takes CUDA tensors")
    check_tensor(im, "im", (h, w, c), torch.float32, dev)
    check_tensor(flow, "flow", (h, w, 2), torch.float32, dev)
    if occl is not None:
        check_tensor(occl, "occl", (h, w), torch.float32, dev)
    im, flow = _aligned(im), _aligned(flow)
    out = torch.empty((h, w, c), dtype=torch.float32, device=dev)
    valid = torch.empty((h, w), dtype=torch.bool, device=dev)
    call("bnlk_warp", im.data_ptr(), flow.data_ptr(),
         None if occl is None else occl.data_ptr(), out.data_ptr(),
         valid.data_ptr(), h, w, c, ctypes.c_void_p(stream_ptr(dev)))
    LAUNCHES.add()
    if c == 9:
        LAUNCHES_C9.add()
    return out, valid


def warp_tvl1_consts_cuda(i1s: torch.Tensor, state: torch.Tensor,
                          i0: torch.Tensor) -> torch.Tensor:
    """Kernel version of ``tvl1_stage_consts_plain``: i1s (H, W, 3) = (I1,
    I1x, I1y) warped along u1 = state[0], u2 = state[1] of the (6, H, W)
    TV-L1 state, and i0 (H, W), to the (4, H, W) constants {i1wx, i1wy,
    i1wx^2 + i1wy^2, i1w - i1wx u1 - i1wy u2 - i0}, in one launch."""
    h, w = i0.shape
    _check_frame(h, w, 3)
    dev = i0.device
    if dev.type != "cuda":
        raise ValueError("warp_tvl1_consts_cuda takes CUDA tensors")
    check_tensor(i1s, "i1s", (h, w, 3), torch.float32, dev)
    check_tensor(state, "state", (6, h, w), torch.float32, dev)
    check_tensor(i0, "i0", (h, w), torch.float32, dev)
    i1s, state = _aligned(i1s), _aligned(state)
    consts = torch.empty((4, h, w), dtype=torch.float32, device=dev)
    call("bnlk_warp_tvl1_consts", i1s.data_ptr(), state.data_ptr(), i0.data_ptr(),
         consts.data_ptr(), h, w, ctypes.c_void_p(stream_ptr(dev)))
    LAUNCHES.add()
    return consts
