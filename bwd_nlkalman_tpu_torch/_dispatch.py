"""Device dispatch shared by every kernel wrapper.

A wrapper launches its hand-written CUDA kernel for tensors on a CUDA
device and takes its plain PyTorch version for tensors on the CPU. Any
other device raises. There is no fallback from a failed kernel to the
plain version.
"""

from __future__ import annotations

import torch


ENGINES = ("auto", "plain")
WINDOW_DTYPES = ("float32", "bfloat16")
STATE_DTYPES = ("float32", "bfloat16")


def check_engine(engine: str) -> None:
    """Raise unless ``engine`` is "auto" (kernels on CUDA tensors) or "plain"."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be 'auto' or 'plain', got {engine!r}")


def check_window_dtype(window_dtype: str) -> None:
    """Raise unless ``window_dtype`` is "float32" or "bfloat16": the type
    the NLK pass holds its DCT bands in."""
    if window_dtype not in WINDOW_DTYPES:
        raise ValueError(f"window_dtype must be one of {WINDOW_DTYPES}, "
                         f"got {window_dtype!r}")


def check_state_dtype(state_dtype: str) -> None:
    """Raise unless ``state_dtype`` is "float32" or "bfloat16": the type
    K2 holds its TV-L1 dual planes in."""
    if state_dtype not in STATE_DTYPES:
        raise ValueError(f"state_dtype must be one of {STATE_DTYPES}, "
                         f"got {state_dtype!r}")


def entry_device(device, who: str) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU. A card that is not there raises; nothing falls back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to run "
                           "on the CPU")
    return device


def runs_kernels(device: torch.device, engine: str) -> bool:
    """True where an entry point on ``device`` launches the kernels."""
    check_engine(engine)
    return engine == "auto" and device.type == "cuda"


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
    """Count of a kernel's launches (one per wrapper call), or of the work
    they did. A kernel that decides its own work on the device adds it to
    a device int (:meth:`slot`) instead, so that the host reads nothing
    while the kernel runs; :attr:`count` reads those ints, one host read
    per device."""

    def __init__(self):
        self._host = 0
        self._slots: dict[torch.device, torch.Tensor] = {}

    def add(self, n: int = 1) -> None:
        self._host += n

    def slot(self, device: torch.device) -> torch.Tensor:
        """The int32 tensor on ``device`` that kernels add their counts to."""
        if device not in self._slots:
            self._slots[device] = torch.zeros(1, dtype=torch.int32, device=device)
        return self._slots[device]

    @property
    def count(self) -> int:
        return self._host + sum(int(s) for s in self._slots.values())

    def snapshot(self) -> tuple:
        """The count as it stands, read without a host read: the host int
        and a device-side copy of each device's int (one 4-byte copy
        each, enqueued on the current stream). :func:`counted` resolves
        two snapshots."""
        return self._host, {d: s.clone() for d, s in self._slots.items()}

    def reset(self) -> None:
        self._host = 0
        for s in self._slots.values():
            s.zero_()


def counted(before: tuple, after: tuple) -> int:
    """What a :class:`LaunchCounter` counted between two of its snapshots
    (reads the device copies: call once their stream has finished)."""
    (h0, d0), (h1, d1) = before, after
    return h1 - h0 + sum((int(s) - int(d0[d]) if d in d0 else int(s)) % 2 ** 32
                         for d, s in d1.items())
