"""Divergence-threshold occlusion detector.

Port of ``bwd_nlkalman_tpu.flow.occlusion`` (scripts/nlkalman-seq.sh:69-72):
occluded where the backward-difference flow divergence exceeds the
threshold; border differences are 0 (edge clamping).
"""

from __future__ import annotations

import torch


def occlusion_mask(flow: torch.Tensor, threshold: float = 0.75) -> torch.Tensor:
    """(H, W, 2) flow -> (H, W) float mask, 255.0 where occluded else 0."""
    u, v = flow[..., 0], flow[..., 1]
    du = torch.cat([torch.zeros_like(u[:, :1]), u[:, 1:] - u[:, :-1]], dim=1)
    dv = torch.cat([torch.zeros_like(v[:1]), v[1:] - v[:-1]], dim=0)
    div = du + dv
    return torch.where(div.abs() > threshold, 255.0, 0.0).to(flow.dtype)
