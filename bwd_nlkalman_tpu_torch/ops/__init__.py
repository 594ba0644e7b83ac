"""Image ops of the port: color, windows, DCT, warps (K4), gradients,
Gaussian blur and zoom."""

from .color import opp2rgb, rgb2opp  # noqa: F401
from .dct import dct_image_all_patches  # noqa: F401
from .gaussian import gaussian_blur  # noqa: F401
from .grad import centered_gradient, divergence, forward_gradient  # noqa: F401
from .warp import (  # noqa: F401
    bicubic_warp,
    warp_bicubic_nan,
    warp_bicubic_zero,
    warp_bicubic_zero_multi,
)
from .windows import window_np  # noqa: F401
from .zoom import zoom_in, zoom_out, zoom_size  # noqa: F401
