"""The sharded sequence function: the whole nlkalman-seq pipeline (filter
loop and backward RTS smoothing, flow included) over a ('dp', 'sp') mesh.

Port of ``bwd_nlkalman_tpu.parallel.sequence`` (``denoise_sequence_sharded``
:60-205). It is the port's ``pipeline.sequence.denoise_sequence`` given
the mesh: the same frame-0 passes, warm-start peel and loops, with every
NL-Kalman pass row-sharded (``parallel/spatial.py``) and the flows,
occlusion masks and warps too (``parallel/flow.py``: K2 or K3 and K4 on
each shard's rows on the card), along the same 'sp' rows that JAX leaves
to GSPMD. A flow level whose shards would own fewer rows than the halo
of a round (the small-level rule) runs whole on the mesh's first device;
colour conversion runs there on whole frames. So on one clip the outputs
equal the unsharded ``denoise_sequence``'s up to the order of the fold's
sums and of the flow's stopping sums.
"""

from __future__ import annotations

import torch

from ..params import NLKParams
from ..pipeline.sequence import FlowConfig, denoise_sequence
from .mesh import Mesh


@torch.no_grad()
def denoise_sequence_sharded(noisy: torch.Tensor, sigma: float, mesh: Mesh,
                             p1: NLKParams | None = None, p2: NLKParams | None = None,
                             ps: NLKParams | None = None,
                             flow_cfg: FlowConfig = FlowConfig(),
                             smoothing: bool = True, **kw):
    """Sharded pipeline over one clip (T, H, W, C) -> (flt1, flt2, smo1) on
    the mesh's first device; smo1 None without ``smoothing``. ``kw`` are
    ``denoise_sequence``'s (``smooth_flow_cfg``, ``engine``, ``bases`` on
    the mesh's first device, ``window_dtype``).

    H is split over the mesh's 'sp' axis (the divisibility rules of
    ``_spatial_pass``); a single clip runs on batch row 0."""
    return denoise_sequence(noisy.to(mesh.first, torch.float32), sigma, p1, p2, ps,
                            flow_cfg, smoothing, mesh=mesh, **kw)
