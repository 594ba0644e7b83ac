"""NL-Kalman filter and RTS smoother frame passes.

Port of ``bwd_nlkalman_tpu.core.nlkalman`` (``nlkalman_filter_frame``
:416, ``nlkalman_smooth_frame`` :498). The engine is an explicit
argument: ``"auto"`` runs K1 on CUDA tensors and the plain pass on CPU
tensors, ``"plain"`` the plain pass on any device.
"""

from __future__ import annotations

import torch

from ..params import NLKParams
from .engine import dense_pass, patch_validity  # noqa: F401  (re-export)


def _prepare(frame, other, prev_valid):
    """(other zeroed where invalid, prev_valid) as the JAX passes set them up."""
    h, w, _ = frame.shape
    has_prev = other is not None
    if prev_valid is None:
        prev_valid = torch.full((h, w), has_prev, dtype=torch.bool,
                                device=frame.device)
    if other is None:
        other = torch.zeros_like(frame)
    else:
        other = torch.where(prev_valid[..., None], other, 0.0)
    return other.contiguous(), prev_valid.contiguous()


def nlkalman_filter_frame(nisy: torch.Tensor, deno0: torch.Tensor | None,
                          prev_valid: torch.Tensor | None,
                          bsic1: torch.Tensor | None, sigma: float,
                          prms: NLKParams, engine: str = "auto",
                          bases=None) -> torch.Tensor:
    """One NL-Kalman filtering pass over a frame (OPP color space).

    nisy: (H, W, C) noisy frame; deno0: warped previous denoised frame or
    None; prev_valid: (H, W) bool validity of deno0 (None = all valid);
    bsic1: basic estimate (pass-1 output) for the second pass, or None.
    """
    has_prev, has_basic = deno0 is not None, bsic1 is not None
    deno0, prev_valid = _prepare(nisy, deno0, prev_valid)
    basic = bsic1 if has_basic else nisy
    return dense_pass(nisy.contiguous(), deno0, prev_valid, basic.contiguous(),
                      float(sigma), prms, "filter", has_prev, has_basic,
                      engine=engine, bases=bases)


def nlkalman_smooth_frame(filt1: torch.Tensor, smoo0: torch.Tensor | None,
                          prev_valid: torch.Tensor | None, sigma: float,
                          prms: NLKParams, engine: str = "auto",
                          bases=None) -> torch.Tensor:
    """One RTS smoothing pass (OPP space); smoo0 is the warped smoothed
    frame at t+1, or None."""
    has_prev = smoo0 is not None
    smoo0, prev_valid = _prepare(filt1, smoo0, prev_valid)
    filt1 = filt1.contiguous()
    return dense_pass(filt1, smoo0, prev_valid, filt1, float(sigma), prms,
                      "smooth", has_prev, False, engine=engine, bases=bases)
