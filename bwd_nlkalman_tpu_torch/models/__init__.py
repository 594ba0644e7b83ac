"""The registry of the pipeline variants users call by name.

Port of ``bwd_nlkalman_tpu.models``. ``get_model(name, sigma)`` returns a
ready-to-run denoiser ``fn(noisy (T, H, W, C) tensor) -> denoised`` with
the variant's pipeline and sigma's default parameters:

- ``nlk-seq``    nlkalman-seq.sh: two-pass filter + backward RTS
- ``nlk-flt``    filtering only
- ``nlk-fsmo``   causal forward smoothing (nlkalman-fsmo-seq.sh)
- ``nlk-lsmo``   lag-1 smoothing (nlkalman-lsmo-seq.sh)
- ``msnlk``      multiscale DCT pyramid (msnlkalman-seq.sh)
- ``msnlk-lz3``  Lanczos-3 pyramid (msnlkalman-lz3-seq.sh)

It also re-exports the building blocks, as the JAX package's does: the
frame passes, the flow and occlusion mask, the sequence drivers and the
parameters.
"""

from __future__ import annotations

import dataclasses

from .._dispatch import check_window_dtype, entry_device
from ..core import nlkalman_filter_frame, nlkalman_smooth_frame  # noqa: F401
from ..flow import occlusion_mask, tvl1_flow  # noqa: F401
from ..params import FilterMode, NLKParams, default_params  # noqa: F401
from ..pipeline import (  # noqa: F401
    denoise_batch,
    denoise_sequence,
    filter_sequence,
    fsmo_sequence,
    lsmo_sequence,
    smooth_sequence,
)
from ..pipeline.multiscale import (  # noqa: F401
    PYRAMIDS,
    MultiscaleDenoiser,
    ms_denoise_sequence,
    pyramid_flow,
)
from ..pipeline.sequence import FlowConfig, NLKalmanDenoiser

# name -> (NLKalmanDenoiser's smoother or MultiscaleDenoiser's pyramid,
#          the output returned: 1 flt2, 2 smo1)
MODELS = {
    "nlk-seq": ("rts", 2),
    "nlk-flt": ("none", 1),
    "nlk-fsmo": ("fsmo", 2),
    "nlk-lsmo": ("lsmo", 2),
    "msnlk": ("dct", 2),
    "msnlk-lz3": ("lz3", 2),
}


def get_model(name: str, sigma: float, flow_cfg: FlowConfig | None = None,
              device="cuda", window_dtype: str = "float32"):
    """``fn(noisy (T, H, W, C) tensor) -> denoised`` for a registered
    variant at noise level ``sigma`` (TRAIN14 defaults).

    ``flow_cfg``: the single-scale variants' flow (default: the
    reference's); the multiscale variants use their scripts' own, with
    ``flow_cfg.state_dtype`` (K2's dual planes). Runs on
    ``device``, the card unless the caller asks for the CPU: a card that
    is not there raises here. ``window_dtype`` is the NLK passes' band
    type. The variant's module, with the constants of a frame size, is
    built at the first call with that size (where it runs the kernels, a
    pass K1 does not take is warned of then, and runs the plain pass);
    inputs must lie on ``device``. An unknown name raises KeyError.
    """
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODELS)}")
    kind, out = MODELS[name]
    sigma = float(sigma)
    dev = entry_device(device, "get_model")
    check_window_dtype(window_dtype)
    cfg = flow_cfg or FlowConfig()
    modules = {}

    def run(noisy):
        h, w = noisy.shape[1:3]
        if (h, w) not in modules:
            modules[(h, w)] = (
                MultiscaleDenoiser(sigma, h, w, pyramid=kind, device=dev,
                                   window_dtype=window_dtype,
                                   flow_cfg=dataclasses.replace(
                                       pyramid_flow(kind), state_dtype=cfg.state_dtype))
                if kind in PYRAMIDS else
                NLKalmanDenoiser(sigma, h, w, cfg, device=dev, smoother=kind,
                                 window_dtype=window_dtype))
        return modules[(h, w)](noisy)[out]

    run.__name__ = f"{name}_sigma{sigma:g}"
    return run
