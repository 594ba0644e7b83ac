"""Parameter system for the NL-Kalman filter/smoother (the port's own copy
of ``bwd_nlkalman_tpu.params``; ``convert.params_from_jax`` carries a JAX
``NLKParams`` across).

Mirrors the reference parameter structure and the shipped "TRAIN14"
sigma-dependent defaults (reference: src/nlkalman.h:22-37 and
src/nlkalman.c:426-487).  A value of ``-1`` means "auto": resolved from the
noise level by :func:`default_params`, exactly like the C binaries resolve
their CLI flags.

All parameters are static (Python ints/floats): they select the shapes
and constants of a pass.
"""

from __future__ import annotations

import dataclasses
import enum


class FilterMode(enum.Enum):
    """Which set of trained defaults to use (reference src/nlkalman.h:40)."""

    FLT1 = "flt1"  # first filtering pass
    FLT2 = "flt2"  # second filtering pass (uses pass-1 output as guide)
    SMO1 = "smo1"  # RTS smoothing pass


@dataclasses.dataclass(frozen=True)
class NLKParams:
    """Parameters of one filtering/smoothing pass.

    Reference struct nlkalman_params (src/nlkalman.h:22-37); the K-similar-
    patches build is modeled (K_SIMILAR_PATCHES defined, src/nlkalman.h:11).
    """

    patch_sz: int = -1       # patch size (psz x psz)
    search_sz_x: int = -1    # search window radius, spatial filtering
    search_sz_t: int = -1    # search window radius, temporal filtering
    npatches_x: int = -1     # number of similar patches, spatial
    npatches_t: int = -1     # number of similar patches, temporal (kalman)
    npatches_tagg: int = -1  # group size aggregated after the kalman update
    dista_lambda: float = -1.0  # weight of current frame in patch distance
    # patch-distance THRESHOLD selection (the reference's non-K build,
    # src/nlkalman.h:32 + src/nlkalman.c:528,712-717): 0 (default) keeps
    # the shipped K-similar-patches selection; > 0 selects every patch
    # with normalized distance <= dista_th^2 (with the non-K build's
    # dista_sigma2 noise correction, src/nlkalman.c:633).
    dista_th: float = 0.0
    beta_x: float = -1.0     # noise multiplier, spatial (wiener) filtering
    beta_t: float = -1.0     # noise multiplier, kalman filtering

    def resolved(self, sigma: float, mode: FilterMode) -> "NLKParams":
        return default_params(sigma, mode, self)


def default_params(
    sigma: float,
    mode: FilterMode,
    base: NLKParams | None = None,
) -> NLKParams:
    """Resolve ``-1`` fields from the TRAIN14 sigma-dependent formulas.

    Reference: nlkalman_default_params, src/nlkalman.c:426-487.  Trained on
    12 DAVIS test-challenge clips + 2 DERF-HD clips at 960x540, cropped
    400x400, grayscale, 20 frames (comment at src/nlkalman.c:445-454).
    """
    p = base if base is not None else NLKParams()

    def r(cur, default):
        return default if cur < 0 else cur

    patch_sz = r(p.patch_sz, 8)
    search_sz_x = r(p.search_sz_x, 10)
    search_sz_t = r(p.search_sz_t, 5)
    dista_lambda = r(p.dista_lambda, 1.0)

    if mode == FilterMode.FLT1:
        npatches_x = r(p.npatches_x, int(0.5 * sigma + 40.0))
        beta_x = r(p.beta_x, -0.04 * sigma + 3.91)
        npatches_t = r(p.npatches_t, 30)
        npatches_tagg = r(p.npatches_tagg, 20)
        beta_t = r(p.beta_t, -0.005 * sigma + 2.05)
    elif mode == FilterMode.FLT2:
        npatches_x = r(p.npatches_x, int(0.5 * sigma + 10.0))
        beta_x = r(p.beta_x, 0.004 * sigma + 0.21)
        npatches_t = r(p.npatches_t, int(max(5.0, sigma)))
        npatches_tagg = r(p.npatches_tagg, 1)
        beta_t = r(p.beta_t, 0.014 * sigma + 1.38)
    elif mode == FilterMode.SMO1:
        npatches_x = r(p.npatches_x, 0)
        beta_x = r(p.beta_x, 0.0)
        npatches_t = r(p.npatches_t, int(max(5.0, 3.0 * sigma - 15.0)))
        npatches_tagg = r(p.npatches_tagg, npatches_t)
        beta_t = r(p.beta_t, max(1.0, -0.14 * sigma + 8.0))
    else:  # pragma: no cover
        raise ValueError(f"unknown mode {mode}")

    return NLKParams(
        patch_sz=patch_sz,
        search_sz_x=search_sz_x,
        search_sz_t=search_sz_t,
        npatches_x=npatches_x,
        npatches_t=npatches_t,
        npatches_tagg=npatches_tagg,
        dista_lambda=dista_lambda,
        beta_x=beta_x,
        beta_t=beta_t,
        dista_th=p.dista_th,
    )
