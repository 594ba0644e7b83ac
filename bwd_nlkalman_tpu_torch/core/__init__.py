"""NL-Kalman core: the filter / smoother passes and the NLK pass kernel K1."""

from .nlkalman import (  # noqa: F401
    nlkalman_filter_frame,
    nlkalman_smooth_frame,
    patch_validity,
)
