"""Wrapper of K4, the hand-written CUDA bicubic warp (csrc/warp.cu).

Replaces the Pallas kernel ``bwd_nlkalman_tpu/ops/warp_pallas.py:59``.
Its plain PyTorch versions are
:func:`bwd_nlkalman_tpu_torch.ops.warp.bicubic_warp_plain` (the warp) and
:func:`bwd_nlkalman_tpu_torch.flow.tvl1_tiled.tvl1_stage_consts_plain`
(the TV-L1 entry: a warp stage's constants, from the same launch).

The warp takes any channel count in one launch. Up to 9 channels are one
group, each count its instance of the kernel (1, 2, 3, 6 and 9 their own,
the rest the generic one); past 9 the launch covers the channels in
groups of 8, one grid plane a group, all computing the same validity
mask, written once (:func:`channel_groups` is the plan the launch
takes). ``LAUNCHES_C9`` and ``LAUNCHES_GROUPED`` count the 9-channel and
the grouped launches among ``LAUNCHES``.

Both entries have a shard form (``parallel/flow.py``): given ``y0``, the
flow (or state), occlusion, i0 and outputs hold rows ``y0 .. y0 + hb - 1``
of the frame, and the source image holds the whole frame.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import call, stream_ptr
from .._dispatch import LaunchCounter, check_state_dtype, check_tensor

ONE_GROUP_C = 9    # the most channels one group covers (kK4OneGroupC, csrc/warp_tap.cuh)
GROUP_C = 8        # the channels of each group past that (kK4GenericC)

LAUNCHES = LaunchCounter()          # wrapper calls, both entries
LAUNCHES_C9 = LaunchCounter()       # of those, warps of 9 channels (fsmo on RGB)
LAUNCHES_GROUPED = LaunchCounter()  # and warps in more than one channel group


def channel_groups(c: int) -> list[tuple[int, int]]:
    """(first channel, count) of each channel group of a K4 warp of ``c``
    channels, in launch order: one group up to ``ONE_GROUP_C``, groups of
    ``GROUP_C`` past it, the last holding the rest."""
    if c < 1:
        raise ValueError(f"K4 takes 1 or more channels, got {c}")
    width = c if c <= ONE_GROUP_C else GROUP_C
    return [(c0, min(width, c - c0)) for c0 in range(0, c, width)]


def _check_frame(h: int, w: int) -> None:
    if h < 1 or w < 1:
        raise ValueError(f"empty frame {h}x{w}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data is not 8-byte aligned: the kernel
    reads a pixel's flow, and a tap of an even channel count, as float2."""
    return t if t.data_ptr() % 8 == 0 else t.clone()


def _check_rows(y0: int, hb: int, h: int) -> None:
    if y0 < 0 or hb < 1 or y0 + hb > h:
        raise ValueError(f"rows {y0}..{y0 + hb - 1} are not rows of a {h}-row frame")


def bicubic_warp_cuda(im: torch.Tensor, flow: torch.Tensor,
                      occl: torch.Tensor | None = None, y0: int = 0):
    """Kernel version of ``bicubic_warp_plain``: (out (hb, W, C), valid (hb,
    W)) for the frame's rows y0 .. y0 + hb - 1, where flow is (hb, W, 2)
    (the whole frame by default), in one launch of the channel groups
    ``channel_groups(C)``."""
    h, w, c = im.shape
    _check_frame(h, w)
    groups = channel_groups(c)
    hb = flow.shape[0]
    _check_rows(y0, hb, h)
    dev = im.device
    if dev.type != "cuda":
        raise ValueError("bicubic_warp_cuda takes CUDA tensors")
    check_tensor(im, "im", (h, w, c), torch.float32, dev)
    check_tensor(flow, "flow", (hb, w, 2), torch.float32, dev)
    if occl is not None:
        check_tensor(occl, "occl", (hb, w), torch.float32, dev)
    im, flow = _aligned(im), _aligned(flow)
    out = torch.empty((hb, w, c), dtype=torch.float32, device=dev)
    valid = torch.empty((hb, w), dtype=torch.bool, device=dev)
    call("bnlk_warp", im.data_ptr(), flow.data_ptr(),
         None if occl is None else occl.data_ptr(), out.data_ptr(),
         valid.data_ptr(), h, w, c, int(y0), hb, ctypes.c_void_p(stream_ptr(dev)))
    LAUNCHES.add()
    if c == 9:
        LAUNCHES_C9.add()
    if len(groups) > 1:
        LAUNCHES_GROUPED.add()
    return out, valid


def warp_tvl1_consts_cuda(i1s: torch.Tensor, state: torch.Tensor,
                          i0: torch.Tensor, y0: int = 0, nig: bool = False,
                          state_dtype: str = "float32") -> torch.Tensor:
    """Kernel version of ``tvl1_stage_consts_plain``: i1s (H, W, 3) = (I1,
    I1x, I1y) warped along u1 = state[0], u2 = state[1] of the (6, hb, W)
    TV-L1 state, and i0 (hb, W), to the (4, hb, W) constants {i1wx, i1wy,
    i1wx^2 + i1wy^2, i1w - i1wx u1 - i1wy u2 - i0}, in one launch, for the
    frame's rows y0 .. y0 + hb - 1 (the whole frame by default). With
    ``nig`` the third plane is K2's nig = -1 / (i1wx^2 + i1wy^2), zero
    where that is below 1e-10; with ``nig`` and ``state_dtype="bfloat16"``
    the constants of K2's bfloat16 rule, each operation rounded on its own
    as the plain version's (csrc/bicubic.cuh)."""
    check_state_dtype(state_dtype)
    h, w = i1s.shape[:2]
    hb = i0.shape[0]
    _check_frame(h, w)
    _check_rows(y0, hb, h)
    dev = i0.device
    if dev.type != "cuda":
        raise ValueError("warp_tvl1_consts_cuda takes CUDA tensors")
    check_tensor(i1s, "i1s", (h, w, 3), torch.float32, dev)
    check_tensor(state, "state", (6, hb, w), torch.float32, dev)
    check_tensor(i0, "i0", (hb, w), torch.float32, dev)
    i1s, state = _aligned(i1s), _aligned(state)
    consts = torch.empty((4, hb, w), dtype=torch.float32, device=dev)
    call("bnlk_warp_tvl1_consts", i1s.data_ptr(), state.data_ptr(), i0.data_ptr(),
         consts.data_ptr(), h, w, int(y0), hb,
         (2 if state_dtype == "bfloat16" else 1) if nig else 0,
         ctypes.c_void_p(stream_ptr(dev)))
    LAUNCHES.add()
    return consts
