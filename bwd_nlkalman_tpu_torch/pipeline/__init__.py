"""Whole-sequence, streaming and multiscale denoising of the port, their
modules and the ground-truth harness."""

from .gt import add_noise_sequence, gt_measures, sequence_psnr  # noqa: F401
from .multiscale import MultiscaleDenoiser, ms_denoise_sequence  # noqa: F401
from .sequence import (  # noqa: F401
    FlowConfig,
    NLKalmanDenoiser,
    denoise_batch,
    denoise_sequence,
    filter_frame_pair,
    filter_sequence,
    filter_sequence_precomputed,
    filter_step_warm,
    fsmo_sequence,
    lsmo_sequence,
    smooth_sequence,
    smooth_sequence_precomputed,
)
from .stream import StreamingDenoiser, run_streaming  # noqa: F401
