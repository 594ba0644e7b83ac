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
"""

from __future__ import annotations

from .._dispatch import entry_device, runs_kernels
from ..core.engine_cuda import check_params
from ..params import FilterMode, default_params
from ..pipeline.multiscale import PYRAMIDS, MultiscaleDenoiser, level_sigmas
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
MAX_LEVELS = 4      # the most levels the multiscale scripts pick (8 Mpx and up)


def _passes(kind: str, sigma: float):
    """The (NLKParams, mode) of every pass a variant can run: a multiscale
    variant's at every level count it can pick."""
    sigmas = level_sigmas(sigma, MAX_LEVELS) if kind in PYRAMIDS else [sigma]
    passes = [(default_params(s, m), "filter") for s in sigmas
              for m in (FilterMode.FLT1, FilterMode.FLT2)]
    return passes + [(default_params(sigma, FilterMode.SMO1), "smooth")]


def get_model(name: str, sigma: float, flow_cfg: FlowConfig | None = None,
              device="cuda"):
    """``fn(noisy (T, H, W, C) tensor) -> denoised`` for a registered
    variant at noise level ``sigma`` (TRAIN14 defaults).

    ``flow_cfg``: the single-scale variants' flow (default: the
    reference's); the multiscale variants use their scripts' own. Runs on
    ``device``, the card unless the caller asks for the CPU: a card that
    is not there raises here, as do parameters K1 does not take where the
    kernels run. The variant's module, with the constants of a frame
    size, is built at the first call with that size; inputs must lie on
    ``device``. An unknown name raises KeyError.
    """
    if name not in MODELS:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODELS)}")
    kind, out = MODELS[name]
    sigma = float(sigma)
    dev = entry_device(device, "get_model")
    if runs_kernels(dev, "auto"):
        check_params(_passes(kind, sigma))
    cfg = flow_cfg or FlowConfig()
    modules = {}

    def run(noisy):
        h, w = noisy.shape[1:3]
        if (h, w) not in modules:
            modules[(h, w)] = (
                MultiscaleDenoiser(sigma, h, w, pyramid=kind, device=dev)
                if kind in PYRAMIDS else
                NLKalmanDenoiser(sigma, h, w, cfg, device=dev, smoother=kind))
        return modules[(h, w)](noisy)[out]

    run.__name__ = f"{name}_sigma{sigma:g}"
    return run
