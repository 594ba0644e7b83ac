"""Parameters of an NL-Kalman pass and the TRAIN14 sigma-dependent
defaults (src/nlkalman.h:22-37, src/nlkalman.c:426-487)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Params:
    patch_sz: int
    search_sz_x: int
    search_sz_t: int
    npatches_x: int
    npatches_t: int
    npatches_tagg: int
    beta_x: float
    beta_t: float


def default_params(sigma: float, mode: str) -> Params:
    """The shipped defaults at noise level ``sigma`` for mode "flt1",
    "flt2" or "smo1" (patch 8, search radii 10 and 5)."""
    if mode == "flt1":
        return Params(8, 10, 5, int(0.5 * sigma + 40.0), 30, 20,
                      -0.04 * sigma + 3.91, -0.005 * sigma + 2.05)
    if mode == "flt2":
        return Params(8, 10, 5, int(0.5 * sigma + 10.0), int(max(5.0, sigma)), 1,
                      0.004 * sigma + 0.21, 0.014 * sigma + 1.38)
    if mode == "smo1":
        nt = int(max(5.0, 3.0 * sigma - 15.0))
        return Params(8, 10, 5, 0, nt, nt, 0.0, max(1.0, -0.14 * sigma + 8.0))
    raise ValueError(f"unknown mode {mode!r}")


def pass_radius(p: Params, mode: str) -> int:
    """A filter pass searches the larger of its radii, a smoother pass the
    temporal one."""
    return max(p.search_sz_x, p.search_sz_t) if mode == "filter" else p.search_sz_t
