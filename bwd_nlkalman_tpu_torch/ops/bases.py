"""Numpy-built constant tensors (DCT basis, window, blur/zoom matrices).

Every constant is named by a key tuple ``(kind, *args)`` and built by a
numpy function of ``args``. A ``bases`` mapping (from :func:`basis_name`
to tensor) is the one source of constants for a call that passes it:
``NLKalmanDenoiser`` registers the constants of its frame size as buffers
and passes them down, and :func:`make_bases` builds such a mapping for
any other caller. Such a mapping also holds the band form of each blur
and zoom matrix among its keys (``band_cuda.band_builds``), which G
applies on the card. A call given ``bases=None`` builds what it needs then.
"""

from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch

from .band_cuda import band_builds

def basis_name(key: tuple) -> str:
    """Buffer-safe name of a constant key, e.g. ('blur', 48, 0.8) -> 'blur_48_0p8'."""
    return "_".join(str(k).replace(".", "p").replace("-", "m") for k in key)


def _build(key: tuple, build: Callable[..., np.ndarray], device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(build(*key[1:])), device=device)


def make_bases(builds: Mapping[tuple, Callable[..., np.ndarray]],
               device=None) -> dict[str, torch.Tensor]:
    """A ``bases`` mapping holding ``build(*key[1:])`` for every key of
    ``builds``, and the band form of each blur and zoom matrix among them."""
    builds = {**builds, **band_builds(builds)}
    return {basis_name(k): _build(k, b, device) for k, b in builds.items()}


def basis(bases: Mapping[str, torch.Tensor] | None, key: tuple,
          build: Callable[..., np.ndarray], device) -> torch.Tensor:
    """The constant of ``key``: from ``bases``, which must hold it, or, with
    ``bases=None``, ``build(*key[1:])`` made now on ``device``."""
    if bases is None:
        return _build(key, build, device)
    return bases[basis_name(key)]
