"""Multi-device parallelism: the device mesh, row-sharded NL-Kalman passes
with halo exchange, the row-sharded flow, occlusion and warps, and batch
data parallelism.

Port of ``bwd_nlkalman_tpu.parallel``. The JAX package maps the
reference's OpenMP threads within a frame onto rows sharded over the
'sp' mesh axis (shard_map with ppermute halo exchange sized by the
search radius + patch size) and its GNU-parallel processes across files
onto clips over 'dp'. The port keeps that model with one process driving
a mesh of ``torch.device`` s: each shard's rows and halos are moved with
``Tensor.to`` (peer to peer across cards), and K1 runs each shard's pass
with its own site rows, the global patch-row bounds and unnormalised
sums. TV-L1 (K2 or K3 per level, rounds with halo exchange and a
stop-or-go flag decided on the device), occlusion and the K4 warps run
on each shard's rows too (``flow.py``), where JAX leaves them to GSPMD.
A mesh may repeat a device (``make_mesh(1, 3, ["cuda:0"] * 3)`` on
one card, ``make_mesh(1, 4, ["cpu"] * 4)`` on the CPU).
"""

from .dryrun import dryrun_multichip  # noqa: F401
from .flow import (  # noqa: F401
    sharded_occlusion_mask,
    sharded_tvl1_flow,
    sharded_tvl1_flow_warm,
    sharded_warm_gate,
    sharded_warp,
)
from .mesh import Mesh, make_mesh  # noqa: F401
from .sequence import denoise_sequence_sharded  # noqa: F401
from .spatial import (  # noqa: F401
    resolve_engine,
    sharded_filter_step,
    spatial_filter_frame,
    spatial_smooth_frame,
)
