"""Image/flow I/O of the port: the same names and bytes as
``bwd_nlkalman_tpu.io`` (float TIFF, PNG, Middlebury .flo, PFM with iio's
unflipped rows), pure numpy, and printf-patterned frame sequences.
"""

from .codecs import (  # noqa: F401
    read_image,
    write_image,
    read_flo,
    write_flo,
    read_pfm,
    write_pfm,
    read_png,
    write_png,
    read_tiff,
    write_tiff,
)
from .video import FrameSequence, read_video, write_video  # noqa: F401
