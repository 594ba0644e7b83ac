"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device (the CPU
test machines have none, and no nvcc). On a GPU machine, run
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q``
(``--noconftest`` keeps JAX out: the repo's conftest imports it). This
file imports no JAX.
"""

import numpy as np
import pytest
import torch

from bwd_nlkalman_tpu_torch.core.engine import dense_pass_v2
from bwd_nlkalman_tpu_torch.core.engine_cuda import dense_pass_cuda
from bwd_nlkalman_tpu_torch.flow.tvl1_cuda import tvl1_level_cuda
from bwd_nlkalman_tpu_torch.flow.tvl1_fused import tvl1_level_plain
from bwd_nlkalman_tpu_torch.ops.warp import bicubic_warp_plain
from bwd_nlkalman_tpu_torch.ops.warp_cuda import bicubic_warp_cuda
from bwd_nlkalman_tpu_torch.params import FilterMode, default_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.parametrize("c", [1, 2, 3])
def test_warp_kernel_matches_plain(dev, c):
    rng = np.random.default_rng(c)
    h, w = 32, 40
    im = _t(rng.uniform(0, 255, (h, w, c)).astype(np.float32), dev)
    flow = 1.5 * rng.standard_normal((h, w, 2)).astype(np.float32)
    flow[:6, :, 1] -= 9.0
    flow = _t(flow, dev)
    out, valid = bicubic_warp_cuda(im, flow)
    ref, ref_valid = bicubic_warp_plain(im, flow)
    assert torch.equal(valid, ref_valid)
    torch.testing.assert_close(out, ref, rtol=0.0, atol=1e-3)


@pytest.mark.parametrize("mode,fm,has_prev,has_basic", [
    ("filter", FilterMode.FLT1, False, False),
    ("filter", FilterMode.FLT1, True, False),
    ("filter", FilterMode.FLT2, True, True),
    ("smooth", FilterMode.SMO1, True, False),
])
def test_nlk_kernel_matches_plain(dev, mode, fm, has_prev, has_basic):
    rng = np.random.default_rng(0)
    h, w = 48, 64
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    clean = (100 + 60 * np.sin(0.1 * xx) + 50 * np.cos(0.13 * yy))[..., None].astype(np.float32)
    cur = _t(clean + 20 * rng.standard_normal(clean.shape).astype(np.float32), dev)
    valid = np.ones((h, w), bool)
    valid[:2] = valid[:, :2] = False
    prev = _t(np.where(valid[..., None], clean + 2 * rng.standard_normal(clean.shape), 0)
              .astype(np.float32), dev)
    basic = _t(clean + 4 * rng.standard_normal(clean.shape).astype(np.float32), dev)
    valid = _t(valid, dev)
    if not has_prev:
        prev, valid = torch.zeros_like(cur), torch.zeros_like(valid)
    args = (cur, prev, valid, basic if has_basic else cur, 20.0,
            default_params(20.0, fm), mode, has_prev, has_basic)
    torch.testing.assert_close(dense_pass_cuda(*args), dense_pass_v2(*args),
                               rtol=1e-3, atol=5e-2)


@pytest.mark.parametrize("nwarps,k_check,max_iters,atol",
                         [(2, 8, 32, 2e-3), (1, 1, 1, 1e-5)])
def test_tvl1_level_kernel_matches_plain(dev, nwarps, k_check, max_iters, atol):
    rng = np.random.default_rng(7)
    h, w = 25, 41
    base = np.cumsum(np.cumsum(rng.normal(size=(h + 8, w + 8)), 0), 1)
    base = ((base - base.min()) / (base.max() - base.min()) * 255).astype(np.float32)
    i0, i1 = _t(base[4:4 + h, 4:4 + w], dev), _t(base[2:2 + h, 5:5 + w], dev)
    u0 = torch.zeros((h, w, 2), device=dev)
    kw = dict(nwarps=nwarps, k_check=k_check, max_iters=max_iters)
    torch.testing.assert_close(tvl1_level_cuda(i0, i1, u0, **kw),
                               tvl1_level_plain(i0, i1, u0, **kw),
                               rtol=0.0, atol=atol)
