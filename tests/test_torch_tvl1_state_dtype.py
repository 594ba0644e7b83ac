"""K2's bfloat16 dual planes (``state_dtype="bfloat16"``) on the CPU.

The port's plain K2 level, ``tvl1_level_plain(state_dtype="bfloat16")``,
is held against JAX's ``tvl1_single_scale_fused(state_dtype="bfloat16",
interpret=True)`` on the 25x41 pair of ``tests/test_round3.py:26-60``.

bfloat16 rounding is a step function: where XLA's float32 arithmetic and
PyTorch's differ by an ulp (XLA's CPU backend may contract a product and
a sum into one FMA), a dual can round to the other bfloat16 neighbour, a
jump 2^16 ulps wide. The next iterations spread it, so the two bf16
trajectories part as far as bf16 and float32 do. Measured on the CPU
(max abs over the flow; "negative": the port in float32 against JAX in
bf16):

- 2 iterations (nwarps=1, k_check=1): 2.4e-7, negative 9.8e-4; bar 1e-5.
- 3 iterations: 1.5e-4, negative 1.4e-3; bar 5e-4.
- 32 iterations (nwarps=2, k_check=8): max 8.3e-3 and mean 1.18e-3, the
  port in float32 the same (1.6e-2, 1.18e-3): the flips have spread. So
  that case is held by what the rounding does, not by pointwise
  agreement: the mean departure of the bf16 level from the float32 level
  equals JAX's within a factor of 2 (ratio 1.02 measured; 0 for a port
  that does not round, 4.6 for one that also rounds u), and the mean
  abs error against JAX is within 2e-3 (1.18e-3).

Each bar is applied to the port in float32 too, and the short cases and
the ratio must fail it (the negative case). One module-scoped JAX run per
case; 2 and 3 iterations share a compile (``max_iters`` is traced).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.flow.tvl1_fused import tvl1_single_scale_fused as j_level
from bwd_nlkalman_tpu_torch import convert
from bwd_nlkalman_tpu_torch._dispatch import check_state_dtype
from bwd_nlkalman_tpu_torch.flow import tvl1, tvl1_fused
from bwd_nlkalman_tpu_torch.flow.tvl1_cuda import tvl1_level_cuda, tvl1_level_round_cuda
from bwd_nlkalman_tpu_torch.flow.tvl1_fused import tvl1_level_plain
from bwd_nlkalman_tpu_torch.pipeline import FlowConfig

torch.set_num_threads(1)
SHORT = {2: 1e-5, 3: 5e-4}     # iterations -> max abs bar against JAX
LONG = dict(nwarps=2, k_check=8, max_iters=32)
LONG_MEAN = 2e-3               # mean abs against JAX
LONG_RATIO = (0.5, 2.0)        # bf16's mean departure from float32, port over JAX


def _pair(h=25, w=41):
    rng = np.random.default_rng(7)
    base = np.cumsum(np.cumsum(rng.normal(size=(h + 8, w + 8)), 0), 1)
    base = ((base - base.min()) / (base.max() - base.min()) * 255).astype(np.float32)
    return (base[4:4 + h, 4:4 + w].copy(), base[2:2 + h, 5:5 + w].copy(),
            np.zeros((h, w, 2), np.float32))


@functools.lru_cache(maxsize=None)
def _jax(nwarps, k_check, max_iters):
    i0, i1, u0 = (jnp.asarray(x) for x in _pair())
    return np.asarray(j_level(i0, i1, u0, nwarps=nwarps, k_check=k_check,
                              max_iters=max_iters, state_dtype="bfloat16",
                              interpret=True))


def _port(state_dtype, **kw):
    return tvl1_level_plain(*(torch.from_numpy(x) for x in _pair()),
                            state_dtype=state_dtype, **kw).numpy()


@pytest.mark.parametrize("iters", sorted(SHORT))
def test_short_level_matches_jax_bf16(iters):
    """A few iterations of one round each: u depends on the rounded duals
    from the second on. The port in float32 fails the same bar."""
    kw = dict(nwarps=1, k_check=1, max_iters=iters)
    want = _jax(**kw)
    err = np.abs(_port("bfloat16", **kw) - want).max()
    neg = np.abs(_port("float32", **kw) - want).max()
    assert err <= SHORT[iters] < neg


def test_level_rounding_matches_jax_bf16():
    """32 iterations in 2 warp stages: the bf16 level departs from the
    float32 level as JAX's does (a port that does not round departs by 0),
    and lies within LONG_MEAN of JAX's on average."""
    want = _jax(**LONG)
    f32 = _port("float32", **LONG)
    got = _port("bfloat16", **LONG)
    ref = np.abs(want - f32).mean()
    lo, hi = LONG_RATIO
    assert lo <= np.abs(got - f32).mean() / ref <= hi
    assert np.abs(got - want).mean() <= LONG_MEAN


def test_duals_hold_bfloat16_values(monkeypatch):
    """Every dual an iteration stores is a bfloat16 value, the last of a
    round included; u is not rounded."""
    stored, outs = [], []
    store, one_iter = tvl1_fused._store_duals, tvl1_fused._one_iter
    monkeypatch.setattr(tvl1_fused, "_store_duals",
                        lambda pa, pb, sd: stored.append(store(pa, pb, sd)) or stored[-1])
    monkeypatch.setattr(tvl1_fused, "_one_iter",
                        lambda *a: outs.append(one_iter(*a)) or outs[-1])
    _port("bfloat16", nwarps=1, k_check=4, max_iters=4)
    assert len(stored) == len(outs) == 4
    for p in (p for pair in stored for p in pair):
        assert torch.equal(p, p.to(torch.bfloat16).float())
    u = outs[-1][0]
    assert not torch.equal(u, u.to(torch.bfloat16).float())


@pytest.mark.parametrize("bad", ["float16", "bf16", "float64", ""])
def test_unknown_state_dtype_raises(bad):
    i0, i1, u0 = (torch.from_numpy(x) for x in _pair())
    for call in (lambda: check_state_dtype(bad),
                 lambda: tvl1_level_plain(i0, i1, u0, max_iters=1, state_dtype=bad),
                 lambda: FlowConfig(state_dtype=bad),
                 lambda: tvl1.tvl1_flow(i0, i1, state_dtype=bad)):
        with pytest.raises(ValueError):
            call()


def test_flow_config_keeps_float32():
    """``FlowConfig()`` and a config carried from JAX (which has no such
    field) keep float32 duals; the JAX-side type is passed explicitly."""
    from bwd_nlkalman_tpu.pipeline.sequence import FlowConfig as JFlowConfig

    assert FlowConfig().state_dtype == "float32"
    assert FlowConfig()._kw()["state_dtype"] == "float32"
    j = JFlowConfig(fscale=0, lambda_=0.2)
    got = convert.flow_config_from_jax(j)
    assert got.state_dtype == "float32" and (got.fscale, got.lambda_) == (0, 0.2)
    assert convert.flow_config_from_jax(j, "bfloat16").state_dtype == "bfloat16"
    assert dataclasses.replace(FlowConfig(), state_dtype="bfloat16")._kw()["state_dtype"] \
        == "bfloat16"


def test_state_dtype_reaches_k2_levels_only(monkeypatch):
    """``tvl1_flow`` passes the type to K2's levels: the bf16 flow differs
    from the float32 one, and equals a flow whose every level is solved by
    the bf16 plain level. Levels on the tiled (K3) path ignore it, as the
    JAX package's do: with every level pushed there, both types give the
    same bits."""
    i0, i1, _ = (torch.from_numpy(x) for x in _pair(32, 40))
    kw = dict(fscale=0, max_iters=16)
    f32 = tvl1.tvl1_flow(i0, i1, **kw)
    bf16 = tvl1.tvl1_flow(i0, i1, state_dtype="bfloat16", **kw)
    assert float((bf16 - f32).abs().max()) > 1e-4
    seen = []
    level = tvl1_fused.tvl1_level_plain
    monkeypatch.setattr(tvl1_fused, "tvl1_level_plain",
                        lambda *a, **k: seen.append(k["state_dtype"]) or level(*a, **k))
    assert torch.equal(tvl1.tvl1_flow(i0, i1, state_dtype="bfloat16", **kw), bf16)
    assert seen and set(seen) == {"bfloat16"}
    monkeypatch.setattr(tvl1, "fused_level_supported", lambda h, w: False)
    assert torch.equal(tvl1.tvl1_flow(i0, i1, state_dtype="bfloat16", **kw),
                       tvl1.tvl1_flow(i0, i1, **kw))


def test_warm_step_takes_state_dtype():
    """``tvl1_flow_warm`` and ``FlowConfig.flow_warm`` solve the carried
    level with the configured duals."""
    i0, i1, _ = (torch.from_numpy(x) for x in _pair(32, 40))
    cfg = FlowConfig(fscale=0, max_iters=16, warm_start=True)
    _, carry = cfg.flow_cold_carry(i0, i1)
    cfg16 = dataclasses.replace(cfg, state_dtype="bfloat16")
    got, _ = cfg16.flow_warm(i1, i0, carry)
    want, _ = tvl1.tvl1_flow_warm(i1, i0, carry, **cfg16._kw())
    assert torch.equal(got, want)
    assert float((got - cfg.flow_warm(i1, i0, carry)[0]).abs().max()) > 1e-4


def test_kernel_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the kernel wrappers raise: the plain version is the
    caller's to take, never a fallback."""
    i0, i1, u0 = (torch.from_numpy(x) for x in _pair())
    with pytest.raises(ValueError, match="CUDA"):
        tvl1_level_cuda(i0, i1, u0, state_dtype="bfloat16")
    with pytest.raises(ValueError):
        tvl1_level_round_cuda(torch.zeros((6, 25, 41)), torch.zeros((4, 25, 41)), 8, 0, 25,
                              (0, 0), None, state_dtype="bfloat16")


@pytest.mark.parametrize("name", ["msnlk", "msnlk-lz3", "nlk-flt"])
def test_models_take_state_dtype_from_flow_cfg(monkeypatch, name):
    """``models.get_model`` hands ``flow_cfg.state_dtype`` to every K2 level
    of its pipeline: the single-scale variants through the config, the
    multiscale ones (which keep their scripts' own flow parameters)
    through ``MultiscaleDenoiser(flow_cfg=)``, their scripts' flows with
    the type."""
    from bwd_nlkalman_tpu_torch import models

    seen = []
    level = tvl1_fused.tvl1_level_plain
    monkeypatch.setattr(tvl1_fused, "tvl1_level_plain",
                        lambda *a, **k: seen.append(k["state_dtype"]) or level(*a, **k))
    x = torch.from_numpy(np.stack([_pair(32, 40)[0], _pair(32, 40)[1]])[..., None])
    cfg = FlowConfig(max_iters=8, state_dtype="bfloat16")
    out = models.get_model(name, 20.0, cfg, device="cpu")(x)
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
    assert seen and set(seen) == {"bfloat16"}
