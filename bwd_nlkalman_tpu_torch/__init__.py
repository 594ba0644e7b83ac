"""bwd_nlkalman_tpu_torch — the PyTorch/CUDA port of bwd_nlkalman_tpu.

The JAX package stays the reference; this package mirrors its module
names. Plain tensor code is PyTorch; each Pallas kernel of the JAX
package is a hand-written CUDA kernel under ``csrc/``, built at first use
by ``_build.py``:

- K1 the NL-Kalman pass      (``core/engine_cuda.py``,     ``csrc/nlk_pass.cu``)
- K2 the TV-L1 level         (``flow/tvl1_cuda.py``,       ``csrc/tvl1_level.cu``)
- K3 the TV-L1 tiled block   (``flow/tvl1_block_cuda.py``, ``csrc/tvl1_block.cu``)
- K4 the bicubic warp        (``ops/warp_cuda.py``,        ``csrc/warp.cu``)
- P  the streaming-rate probe (``tools/vpu_probe.py``,     ``csrc/probe.cu``)

and one kernel that replaces no Pallas kernel:

- G  the flow's blur and zooms, a banded separable product
                             (``ops/band_cuda.py``,        ``csrc/band_sep.cu``)

Each kernel runs on CUDA tensors; on CPU tensors its plain PyTorch
version runs instead. Entry points (``NLKalmanDenoiser``,
``StreamingDenoiser``, ``MultiscaleDenoiser``, ``models.get_model``, the
CLIs under ``cli/``) run on the card unless asked for the CPU.
``parallel`` shards the NLK passes' rows over a mesh of devices with halo
exchange (K1 on each shard's own sites), and the flow, occlusion and warps
too (K2, K3 and K4 in their shard forms), runs the sharded sequence and
spreads a batch of clips over the mesh's 'dp' axis. ``native`` is the C++
io library (PNG, TIFF, JPEG, PFM, FLO and a threaded frame loader),
built at first use with g++. This package imports neither JAX nor the
JAX package.
"""

__version__ = "0.1.0"

from . import params as params  # noqa: F401
from .params import FilterMode, NLKParams, default_params  # noqa: F401
from .pipeline import (FlowConfig, MultiscaleDenoiser, NLKalmanDenoiser,  # noqa: F401
                       StreamingDenoiser, denoise_sequence)


def kernel_counters():
    """The launch counters of the port's kernels, by kernel id; "K4c9"
    counts the K4 warps of 9 channels among K4's, "K4grp" those in more
    than one channel group (more than 9 channels)."""
    from .core.engine_cuda import LAUNCHES as k1
    from .flow.tvl1_block_cuda import LAUNCHES as k3
    from .flow.tvl1_cuda import LAUNCHES as k2
    from .ops.band_cuda import LAUNCHES as g
    from .ops.warp_cuda import LAUNCHES as k4
    from .ops.warp_cuda import LAUNCHES_C9 as k4c9
    from .ops.warp_cuda import LAUNCHES_GROUPED as k4grp
    from .tools.vpu_probe import LAUNCHES as p

    return {"K1": k1, "K2": k2, "K3": k3, "K4": k4, "K4c9": k4c9, "K4grp": k4grp,
            "P": p, "G": g}
