"""Opponent color transform (port of ``bwd_nlkalman_tpu.ops.color``).

Channels-last float tensors (..., H, W, C); the identity unless C == 3,
like the reference (rgb2opp/opp2rgb, src/nlkalman.c:92-130).
"""

from __future__ import annotations

import math

import torch

_A = 1.0 / math.sqrt(3.0)
_B = 1.0 / math.sqrt(2.0)
_C = 2.0 * _A * math.sqrt(2.0)
_FWD = [
    [_A, _A, _A],
    [_B, 0.0, -_B],
    [0.25 * _C, -0.5 * _C, 0.25 * _C],
]
_CI = _A / _B
_INV = [
    [_A, _B, 0.5 * _CI],
    [_A, 0.0, -_CI],
    [_A, -_B, 0.5 * _CI],
]


def _mix(im: torch.Tensor, rows) -> torch.Tensor:
    m = torch.tensor(rows, dtype=im.dtype, device=im.device)
    return torch.einsum("...c,kc->...k", im, m)


def rgb2opp(im: torch.Tensor) -> torch.Tensor:
    """RGB -> opponent color space (identity unless last dim == 3)."""
    return im if im.shape[-1] != 3 else _mix(im, _FWD)


def opp2rgb(im: torch.Tensor) -> torch.Tensor:
    """Opponent -> RGB color space (identity unless last dim == 3)."""
    return im if im.shape[-1] != 3 else _mix(im, _INV)
