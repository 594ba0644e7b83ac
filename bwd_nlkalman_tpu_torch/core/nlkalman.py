"""NL-Kalman filter and RTS smoother frame passes, and which engine runs them.

Port of ``bwd_nlkalman_tpu.core.nlkalman`` (``_pick_engine`` :384,
``nlkalman_filter_frame`` :416, ``nlkalman_smooth_frame`` :498). The
engine and the band type are explicit arguments: ``engine="auto"`` runs
K1 on CUDA tensors where :func:`k1_supported` holds and the plain pass
everywhere else, ``"plain"`` the plain pass on any device;
``window_dtype`` ("float32" or "bfloat16") is the type the pass holds its
DCT bands in, on either engine.

The rule is decided on the pass's parameters before any launch, as JAX's
auto engine sends what its Pallas kernel does not take to its XLA
engine; it is not a fallback: nothing catches a K1 error to reroute. The
first time a reason routes a pass on a CUDA tensor to the plain pass,
``warnings.warn`` names it ("patch_sz 7 is odd", ...), and
:data:`PLAIN_PASSES` counts every such pass.
"""

from __future__ import annotations

import warnings

import torch

from .._dispatch import LaunchCounter, check_engine, check_window_dtype
from ..params import NLKParams
from .engine import dense_pass, patch_validity  # noqa: F401  (re-export)
from .engine_cuda import pass_radius, plan_refusal

PLAIN_PASSES = LaunchCounter()   # NLK passes of CUDA tensors run by the plain pass
_WARNED: set[str] = set()


def k1_refusal(h: int, w: int, ch: int, prms: NLKParams, mode: str,
               window_dtype: str = "float32") -> str | None:
    """Why K1 does not take a pass over (h, w, ch) frames, or None where it
    does: the counterpart of ``pallas_pass_supported``
    (``bwd_nlkalman_tpu/core/engine_pallas.py:1279``). K1 takes an even
    patch size from 2 to 16, 1 to 7 channels, the K-similar-patches
    selection (``dista_lambda`` 1, ``dista_th`` 0), a search radius up to
    15, a frame at least one patch wide and high, and a site block that
    fits shared memory."""
    psz = prms.patch_sz
    if prms.dista_lambda != 1.0:
        return f"dista_lambda {prms.dista_lambda:g} is not 1 (a v2-only variant)"
    if prms.dista_th > 0.0:
        return f"dista_th {prms.dista_th:g} is above 0 (a v2-only variant)"
    why = plan_refusal(ch, pass_radius(prms, mode), psz, window_dtype)
    if why is None and (h < psz or w < psz):
        why = f"a {h}x{w} frame is smaller than one {psz}x{psz} patch"
    return why


def k1_supported(h: int, w: int, ch: int, prms: NLKParams, mode: str,
                 window_dtype: str = "float32") -> bool:
    """True where K1 takes the pass (:func:`k1_refusal` gives no reason)."""
    return k1_refusal(h, w, ch, prms, mode, window_dtype) is None


def plain_route_warning(reason: str) -> str:
    """The warning text of a pass routed to the plain pass for ``reason``."""
    return (f"NL-Kalman pass on the plain PyTorch version, not K1: {reason} "
            f"(the rule of core.nlkalman.k1_supported)")


def note_plain_routes(passes, h: int, w: int, ch: int,
                      window_dtype: str = "float32") -> list[str]:
    """Warn, before any launch, for each ``(NLKParams, mode)`` of ``passes``
    K1 does not take on (h, w, ch) frames; returns the reasons."""
    reasons = [r for p, mode in passes
               if (r := k1_refusal(h, w, ch, p, mode, window_dtype)) is not None]
    for r in reasons:
        _warn_once(r)
    return reasons


def _warn_once(reason: str) -> None:
    if reason not in _WARNED:
        _WARNED.add(reason)
        warnings.warn(plain_route_warning(reason), stacklevel=3)


def pick_engine(engine: str, frame: torch.Tensor, prms: NLKParams, mode: str,
                window_dtype: str = "float32") -> str:
    """The engine a pass over ``frame`` runs on: "plain" where
    ``engine="auto"`` meets a CUDA tensor and a pass K1 does not take
    (counted in :data:`PLAIN_PASSES`, warned once per reason), else
    ``engine`` as given."""
    check_engine(engine)
    check_window_dtype(window_dtype)
    if engine != "auto" or frame.device.type != "cuda":
        return engine
    reason = k1_refusal(*frame.shape, prms, mode, window_dtype)
    if reason is None:
        return engine
    _warn_once(reason)
    PLAIN_PASSES.add()
    return "plain"


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
                          bases=None, window_dtype: str = "float32") -> torch.Tensor:
    """One NL-Kalman filtering pass over a frame (OPP color space).

    nisy: (H, W, C) noisy frame; deno0: warped previous denoised frame or
    None; prev_valid: (H, W) bool validity of deno0 (None = all valid);
    bsic1: basic estimate (pass-1 output) for the second pass, or None.
    """
    has_prev, has_basic = deno0 is not None, bsic1 is not None
    engine = pick_engine(engine, nisy, prms, "filter", window_dtype)
    deno0, prev_valid = _prepare(nisy, deno0, prev_valid)
    basic = bsic1 if has_basic else nisy
    return dense_pass(nisy.contiguous(), deno0, prev_valid, basic.contiguous(),
                      float(sigma), prms, "filter", has_prev, has_basic,
                      engine=engine, bases=bases, window_dtype=window_dtype)


def nlkalman_smooth_frame(filt1: torch.Tensor, smoo0: torch.Tensor | None,
                          prev_valid: torch.Tensor | None, sigma: float,
                          prms: NLKParams, engine: str = "auto",
                          bases=None, window_dtype: str = "float32") -> torch.Tensor:
    """One RTS smoothing pass (OPP space); smoo0 is the warped smoothed
    frame at t+1, or None."""
    has_prev = smoo0 is not None
    engine = pick_engine(engine, filt1, prms, "smooth", window_dtype)
    smoo0, prev_valid = _prepare(filt1, smoo0, prev_valid)
    filt1 = filt1.contiguous()
    return dense_pass(filt1, smoo0, prev_valid, filt1, float(sigma), prms,
                      "smooth", has_prev, False, engine=engine, bases=bases,
                      window_dtype=window_dtype)
