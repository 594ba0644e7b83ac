"""bwd_nlkalman_tpu_torch — the PyTorch/CUDA port of bwd_nlkalman_tpu.

The JAX package stays the reference; this package mirrors its module
names. Plain tensor code is PyTorch; each Pallas kernel of the ported
path is a hand-written CUDA kernel under ``csrc/``, built at first use
by ``_build.py``:

- K1 the NL-Kalman pass   (``core/engine_cuda.py``, ``csrc/nlk_pass.cu``)
- K2 the TV-L1 level      (``flow/tvl1_cuda.py``,   ``csrc/tvl1_level.cu``)
- K4 the bicubic warp     (``ops/warp_cuda.py``,    ``csrc/warp.cu``)

Each kernel runs on CUDA tensors; on CPU tensors its plain PyTorch
version runs instead. This package never imports JAX.
"""

__version__ = "0.1.0"

from .params import FilterMode, NLKParams, default_params  # noqa: F401
from .pipeline import FlowConfig, NLKalmanDenoiser, denoise_sequence  # noqa: F401


def kernel_counters():
    """The launch counters of the ported kernels, by kernel id."""
    from .core.engine_cuda import LAUNCHES as k1
    from .flow.tvl1_cuda import LAUNCHES as k2
    from .ops.warp_cuda import LAUNCHES as k4

    return {"K1": k1, "K2": k2, "K4": k4}
