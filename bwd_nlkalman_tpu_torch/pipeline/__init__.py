"""Whole-sequence denoising of the port, the ``NLKalmanDenoiser`` module
and the ground-truth harness."""

from .gt import add_noise_sequence, gt_measures, sequence_psnr  # noqa: F401
from .sequence import (  # noqa: F401
    FlowConfig,
    NLKalmanDenoiser,
    denoise_sequence,
    filter_frame_pair,
    filter_sequence,
    filter_step_warm,
    smooth_sequence,
)
