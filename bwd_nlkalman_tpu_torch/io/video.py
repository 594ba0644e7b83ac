"""Frame-pattern video reader/writer.

The reference addresses sequences as printf patterns ("%03d") over frame
indices (vio_read_video_float_vec, src/main-seq.c:14-57; bash scripts use
`printf $SEQ $i`).  Same convention here (the port's copy of
``bwd_nlkalman_tpu.io.video``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .codecs import read_image, write_image


@dataclasses.dataclass
class FrameSequence:
    """A printf-patterned frame sequence on disk."""

    pattern: str  # e.g. "/data/seq/%03d.png"
    first: int
    last: int
    step: int = 1

    def path(self, i: int) -> str:
        return self.pattern % i

    def indices(self):
        return range(self.first, self.last + 1, self.step)

    def read(self) -> np.ndarray:
        return read_video(self.pattern, self.first, self.last, self.step)


def read_video(pattern: str, first: int, last: int, step: int = 1) -> np.ndarray:
    """Read frames pattern%first..pattern%last into (T, H, W, C) float32."""
    frames = [read_image(pattern % i) for i in range(first, last + 1, step)]
    shapes = {f.shape for f in frames}
    if len(shapes) != 1:
        raise ValueError(f"inconsistent frame shapes: {shapes}")
    return np.stack(frames, axis=0)


def write_video(pattern: str, video: np.ndarray, first: int, step: int = 1) -> None:
    """Write (T, H, W, C) frames to pattern%first, pattern%(first+step), ..."""
    for t in range(video.shape[0]):
        write_image(pattern % (first + t * step), video[t])
