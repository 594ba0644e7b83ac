"""Differential operators with the reference's border rules.

Port of ``bwd_nlkalman_tpu.ops.grad`` (lib/tvl1flow/mask.c): (H, W)
tensors in, (H, W) tensors out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def forward_gradient(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fx = f[:, j+1] - f[:, j] (last col 0); fy likewise along rows."""
    fx = torch.cat([f[:, 1:] - f[:, :-1], torch.zeros_like(f[:, :1])], dim=1)
    fy = torch.cat([f[1:] - f[:-1], torch.zeros_like(f[:1])], dim=0)
    return fx, fy


def centered_gradient(f: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """0.5 (f[i+1] - f[i-1]) on an edge-replicated pad (mask.c:172-208)."""
    fp = F.pad(f[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    dx = 0.5 * (fp[1:-1, 2:] - fp[1:-1, :-2])
    dy = 0.5 * (fp[2:, 1:-1] - fp[:-2, 1:-1])
    return dx, dy


def divergence(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Backward-difference divergence, adjoint of forward_gradient.

    First col/row uses the value itself, last col/row MINUS the previous
    value (mask.c:68-91).
    """
    v1x = torch.cat([v1[:, :1], v1[:, 1:-1] - v1[:, :-2], -v1[:, -2:-1]], dim=1)
    v2y = torch.cat([v2[:1], v2[1:-1] - v2[:-2], -v2[-2:-1]], dim=0)
    return v1x + v2y
