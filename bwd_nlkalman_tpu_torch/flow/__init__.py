"""Optical flow: multiscale TV-L1 (level kernel K2) and the divergence
occlusion detector."""

from .occlusion import occlusion_mask  # noqa: F401
from .tvl1 import luma, tvl1_flow, tvl1_flow_warm  # noqa: F401
