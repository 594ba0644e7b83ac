"""The port's sharded sequence and ``denoise_batch`` over a mesh, on
the CPU.

``denoise_sequence_sharded`` on two CPU shards is held against the
port's own ``denoise_sequence`` on the same clip: the port's
``denoise_sequence`` is held against JAX's by
``tests/test_torch_pipeline.py``, and JAX's sharded sequence against JAX's
single-chip one by ``tests/test_parallel_seq.py``. Only the order of the
sharded fold's sums differs, so the bar is a max abs difference of 2e-3
on every output. The test against JAX's sharded sequence itself is marked
``slow``: JAX's sharded sequence compiles a TV-L1 flow scan on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bwd_nlkalman_tpu_torch import parallel
from bwd_nlkalman_tpu_torch.flow import tvl1
from bwd_nlkalman_tpu_torch.ops.bases import make_bases
from bwd_nlkalman_tpu_torch.params import FilterMode, default_params
from bwd_nlkalman_tpu_torch.pipeline import FlowConfig, denoise_batch, denoise_sequence
from bwd_nlkalman_tpu_torch.pipeline.sequence import pipeline_bases

torch.set_num_threads(1)
SIGMA = 20.0
T, H, W = 3, 64, 48


def _clip(t=T, h=H, w=W, seed=0):
    """A translating structured scene + AWGN, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(np.cumsum(rng.standard_normal((h + 8, w + 8)), 0), 1)
    base = ((base - base.min()) / (base.max() - base.min()) * 175 + 40).astype(np.float32)
    clean = np.stack([base[i:i + h, i:i + w] for i in range(t)])[..., None]
    return clean + SIGMA * rng.standard_normal(clean.shape).astype(np.float32)


def _cfg(warm):
    return FlowConfig(warm_start=True, warm_nwarps=3) if warm else FlowConfig()


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_sharded_sequence_matches_single(warm):
    """Two CPU shards (a 32-row block, the default parameters' 20-row
    halo): flt1, flt2 and smo1 within 2e-3 of ``denoise_sequence``."""
    noisy = torch.from_numpy(_clip())
    mesh = parallel.make_mesh(1, 2, ["cpu"] * 2)
    got = parallel.denoise_sequence_sharded(noisy, SIGMA, mesh, flow_cfg=_cfg(warm))
    want = denoise_sequence(noisy, SIGMA, flow_cfg=_cfg(warm))
    for name, g, r in zip(("flt1", "flt2", "smo1"), got, want):
        assert g.shape == noisy.shape, name
        err = float((g - r).abs().max())
        assert err <= 2e-3, f"{name}: max abs diff {err}"


def test_sharded_sequence_takes_the_drivers_options():
    """The caller's ``bases`` and the smoother's own ``smooth_flow_cfg``
    reach the sharded sequence as they reach ``denoise_sequence``."""
    noisy = torch.from_numpy(_clip())
    p = [default_params(SIGMA, m) for m in FilterMode]
    smooth_cfg = FlowConfig(nwarps=3)
    bases = make_bases(pipeline_bases(H, W, (_cfg(True), smooth_cfg), p), "cpu")
    got = parallel.denoise_sequence_sharded(noisy, SIGMA, parallel.make_mesh(1, 2, ["cpu"] * 2),
                                            flow_cfg=_cfg(True), smooth_flow_cfg=smooth_cfg,
                                            bases=bases)
    want = denoise_sequence(noisy, SIGMA, flow_cfg=_cfg(True), smooth_flow_cfg=smooth_cfg)
    for name, g, r in zip(("flt1", "flt2", "smo1"), got, want):
        err = float((g - r).abs().max())
        assert err <= 2e-3, f"{name}: max abs diff {err}"


def test_sharded_sequence_without_smoothing():
    """``smoothing=False`` returns the filter outputs and no smo1."""
    noisy = torch.from_numpy(_clip(t=2))
    flt1, flt2, smo1 = parallel.denoise_sequence_sharded(
        noisy, SIGMA, parallel.make_mesh(1, 2, ["cpu"] * 2), smoothing=False)
    assert smo1 is None and flt1.shape == flt2.shape == noisy.shape


def test_denoise_batch_over_dp_matches_unsharded():
    """``denoise_batch(mesh=dp 2)``: each clip whole on its batch row's
    device, the same result as ``denoise_batch()``; a batch that dp does
    not divide is refused."""
    batch = torch.from_numpy(np.stack([_clip(2, 48, 48, s) for s in (1, 2)]))
    mesh = parallel.make_mesh(2, 1, ["cpu"] * 2)
    got = denoise_batch(batch, SIGMA, mesh=mesh)
    want = denoise_batch(batch, SIGMA)
    for g, r in zip(got, want):
        assert g.shape == batch.shape
        torch.testing.assert_close(g, r, rtol=0.0, atol=0.0)
    with pytest.raises(ValueError, match="not divisible by dp=2"):
        denoise_batch(batch[:1], SIGMA, mesh=mesh)


@pytest.mark.slow
def test_sharded_sequence_matches_jax_sharded(monkeypatch):
    """The port's sharded sequence against JAX's ``denoise_sequence_sharded``
    on 2 devices, same clip, flt2 and smo1 PSNR within 0.05 dB. Marked
    slow: JAX's function compiles its TV-L1 flow scan on the CPU (45-64 s
    alone). The port runs at the XLA path's TV-L1 granularity of 10, as
    tests/test_torch_pipeline.py does."""
    import jax
    import jax.numpy as jnp

    from bwd_nlkalman_tpu import parallel as j_par
    from bwd_nlkalman_tpu.parallel.sequence import denoise_sequence_sharded as j_sharded
    from bwd_nlkalman_tpu.pipeline.sequence import FlowConfig as JFlowConfig

    monkeypatch.setattr(tvl1, "_k_check", lambda npx: 10)
    rng = np.random.default_rng(5)
    base = np.cumsum(np.cumsum(rng.standard_normal((H + 8, W + 8)), 0), 1)
    base = ((base - base.min()) / (base.max() - base.min()) * 175 + 40).astype(np.float32)
    clean = np.stack([base[i:i + H, i:i + W] for i in range(T)])[..., None]
    noisy = clean + SIGMA * rng.standard_normal(clean.shape).astype(np.float32)

    def psnr(x):
        return float(10 * np.log10(255.0 ** 2 / np.mean((np.asarray(x) - clean) ** 2)))

    cfg = FlowConfig(warm_start=True)
    got = parallel.denoise_sequence_sharded(torch.from_numpy(noisy), SIGMA,
                                            parallel.make_mesh(1, 2, ["cpu"] * 2),
                                            flow_cfg=cfg)
    j_got = j_sharded(jnp.asarray(noisy), SIGMA,
                      j_par.make_mesh(dp=1, sp=2, devices=jax.devices()[:2]),
                      flow_cfg=JFlowConfig(**dataclasses.asdict(cfg)))
    for name, g, j in zip(("flt1", "flt2", "smo1"), got, j_got):
        assert abs(psnr(g.numpy()) - psnr(j)) <= 0.05, name
