"""Device dispatch shared by every kernel wrapper.

A wrapper launches its hand-written CUDA kernel for tensors on a CUDA
device and takes its plain PyTorch version for tensors on the CPU. Any
other device raises. There is no fallback from a failed kernel to the
plain version.
"""

from __future__ import annotations

import torch


ENGINES = ("auto", "plain")


def check_engine(engine: str) -> None:
    """Raise unless ``engine`` is "auto" (kernels on CUDA tensors) or "plain"."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be 'auto' or 'plain', got {engine!r}")


def use_kernel(x: torch.Tensor, engine: str) -> bool:
    """True where a wrapper launches its kernel: ``engine="auto"`` and a CUDA
    tensor. False for a CPU tensor or ``engine="plain"``. Raises for an
    unknown engine or a device other than cpu or cuda."""
    check_engine(engine)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}; expected cpu or cuda")
    return engine == "auto" and x.device.type == "cuda"


def check_tensor(t: torch.Tensor, name: str, shape: tuple, dtype: torch.dtype,
                 device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a kernel wrapper may hand to its kernel as a pointer."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {'' if t.is_contiguous() else 'non-contiguous '}{t.dtype} "
            f"{tuple(t.shape)} on {t.device}")


class LaunchCounter:
    """Plain integer count of a kernel's launches (one per wrapper call)."""

    def __init__(self):
        self.count = 0

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0
