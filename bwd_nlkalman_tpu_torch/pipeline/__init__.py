"""Whole-sequence denoising of the port and the ``NLKalmanDenoiser`` module."""

from .sequence import (  # noqa: F401
    FlowConfig,
    NLKalmanDenoiser,
    denoise_sequence,
    filter_frame_pair,
    filter_sequence,
    filter_step_warm,
    smooth_sequence,
)
