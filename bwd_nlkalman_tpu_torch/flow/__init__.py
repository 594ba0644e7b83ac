"""Optical flow: multiscale TV-L1 (level kernel K2), the reference's
single-scale solver, the TV-L1 energy, the divergence occlusion detector
and the flow-accuracy measures."""

from .measure import angular_error, endpoint_error, measure_sequence  # noqa: F401
from .occlusion import occlusion_mask  # noqa: F401
from .tvl1 import (  # noqa: F401
    flow_energy,
    luma,
    tvl1_flow,
    tvl1_flow_single_scale,
    tvl1_flow_warm,
)
