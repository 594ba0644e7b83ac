"""The port's row-sharded flow, occlusion and warps (``parallel/flow.py``)
on ``["cpu"] * sp`` meshes, sp 2, 3 and 4.

Each is held against the port's own whole-frame plain version on the same
inputs, made from a seed. The sharded steps compute every pixel as the
whole-frame ones do; only the order of the stopping sums differs, which
could move a level's stop by a round only where its error sits at
epsilon. So the bar
against the whole frame is 1e-4 px on the flow (0 was measured), and the
masks and warps must be equal. The flows are also held to JAX's
``tvl1_flow(backend="xla")`` at its granularity of 10 iterations (the
port's ``flow.tvl1._k_check`` monkeypatched, as
``tests/test_torch_pipeline.py`` does; the sharded flow reads it from
there) at ``tests/test_torch_flow.py``'s bar, a mean end-point error of
0.05 px. At 48x64 and granularity 10 the solved 48x64 level is sharded at
every sp (its shards own 12 to 24 rows, the halo is 10); the coarser ones
run whole by the small-level rule, as ``STATS`` records. The sharded
sequence at 48x64 (sp=2) and 96x48 (sp=3) is held within 0.05 dB of the
unsharded port.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.flow import occlusion as j_occ
from bwd_nlkalman_tpu.flow import tvl1 as j_tvl1
from bwd_nlkalman_tpu.ops import warp as j_warp
from bwd_nlkalman_tpu_torch import parallel
from bwd_nlkalman_tpu_torch.flow import tvl1, tvl1_fused, tvl1_tiled
from bwd_nlkalman_tpu_torch.flow.occlusion import occlusion_mask
from bwd_nlkalman_tpu_torch.ops.warp import bicubic_warp
from bwd_nlkalman_tpu_torch.parallel import flow as pflow
from bwd_nlkalman_tpu_torch.pipeline import FlowConfig, denoise_sequence

torch.set_num_threads(1)
SPS = [2, 3, 4]
KW = dict(fscale=0, lambda_=0.25)
FLOW_TOL = 1e-4     # px, the sharded flow against the port's whole-frame flow
EPE_BAR = 0.05      # px, against JAX (tests/test_torch_flow.py)


@pytest.fixture
def xla_granularity(monkeypatch):
    monkeypatch.setattr(tvl1, "_k_check", lambda npx: 10)


def _pair(seed=0, h=48, w=64, dx=2, dy=1):
    rng = np.random.default_rng(seed)
    base = np.cumsum(np.cumsum(rng.normal(size=(h + 8, w + 8)), 0), 1)
    base = ((base - base.min()) / (base.max() - base.min()) * 255).astype(np.float32)
    return base[4:4 + h, 4:4 + w].copy(), base[4 + dy:4 + dy + h, 4 + dx:4 + dx + w].copy()


def _epe(a, b):
    return float(np.mean(np.linalg.norm(np.asarray(a) - np.asarray(b), axis=-1)))


def _mesh(sp):
    return parallel.make_mesh(1, sp, ["cpu"] * sp)


@functools.lru_cache(maxsize=None)
def _jax_flows():
    """JAX's XLA flow on _pair() (cold, with its carry) and the warm step
    from that carry: the one JAX run of this file."""
    i0, i1 = (jnp.asarray(x) for x in _pair())
    cold, carry = j_tvl1.tvl1_flow(i0, i1, backend="xla", return_carry=True, **KW)
    warm, _ = j_tvl1.tvl1_flow_warm(i0, i1, carry, backend="xla", warm_nwarps=3, **KW)
    return np.asarray(cold), np.asarray(carry), np.asarray(warm)


def _torch_pair():
    return tuple(torch.from_numpy(x) for x in _pair())


@pytest.mark.parametrize("sp", SPS)
def test_sharded_flow_cold(sp, xla_granularity):
    i0, i1 = _torch_pair()
    pflow.STATS.reset()
    got, got_fs = parallel.sharded_tvl1_flow(i0, i1, _mesh(sp), return_carry=True, **KW)
    assert (48, 64, sp) in pflow.STATS.levels_sharded and pflow.STATS.rounds["k2"] > 0
    want, want_fs = tvl1.tvl1_flow(i0, i1, return_carry=True, **KW)
    assert float((got - want).abs().max()) <= FLOW_TOL
    assert float((got_fs - want_fs).abs().max()) <= FLOW_TOL
    assert _epe(got, _jax_flows()[0]) <= EPE_BAR


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("sp", SPS)
def test_sharded_flow_warm_and_gate(sp, stale, xla_granularity):
    """The warm step from JAX's carry: the gate's verdict and sums as the
    whole frame's, and the flow; a stale carry trips the gate and takes
    the cold pyramid."""
    i0, i1 = _torch_pair()
    _, carry, j_warm = _jax_flows()
    carry = torch.from_numpy(-carry - 6.0 if stale else carry.copy())
    mesh = _mesh(sp)
    a, b = tvl1._prep_pair(i0, i1)
    ok, r_warm, r_zero = parallel.sharded_warm_gate(a, b, carry, mesh)
    w_ok, w_warm, w_zero = tvl1.warm_gate(a, b, carry)
    assert bool(ok) == bool(w_ok) == (not stale)
    torch.testing.assert_close(torch.stack([r_warm, r_zero]), torch.stack([w_warm, w_zero]),
                               rtol=1e-5, atol=0.0)
    pflow.STATS.reset()
    got, got_fs = parallel.sharded_tvl1_flow_warm(i0, i1, carry, mesh, warm_nwarps=3, **KW)
    assert (48, 64, sp) in pflow.STATS.levels_sharded
    want, want_fs = tvl1.tvl1_flow_warm(i0, i1, carry, warm_nwarps=3, **KW)
    assert float((got - want).abs().max()) <= FLOW_TOL
    assert float((got_fs - want_fs).abs().max()) <= FLOW_TOL
    if not stale:
        assert _epe(got, j_warm) <= EPE_BAR


@pytest.mark.parametrize("sp", SPS)
def test_sharded_flow_tiled_levels(sp, monkeypatch):
    """The levels that take K3's rule (here every level, by a smaller
    budget) shard in blocks of K_ITERS = 24 where the shards own 24 rows
    (the 48x64 level at sp 2)."""
    budget = tvl1_fused._plan(24, 32)[2]
    monkeypatch.setattr(tvl1, "fused_level_supported", lambda h, w: h * w < 24 * 32 and
                        tvl1_fused._plan(h, w)[2] < budget)
    i0, i1 = _torch_pair()
    pflow.STATS.reset()
    got = parallel.sharded_tvl1_flow(i0, i1, _mesh(sp), **KW)
    want = tvl1.tvl1_flow(i0, i1, **KW)
    assert ((48, 64, sp) in pflow.STATS.levels_sharded) == (sp == 2)
    assert (pflow.STATS.rounds["k3"] > 0) == (sp == 2)
    assert float((got - want).abs().max()) <= FLOW_TOL


@pytest.mark.parametrize("k2,state_dtype", [(True, "float32"), (False, None),
                                             (True, "bfloat16")],
                         ids=["k2", "k3", "k2-bf16"])
def test_round_blocks_sum_to_whole_round(k2, state_dtype):
    """Both rules' plain rounds on three row blocks with a halo of k rows:
    each block's own rows equal the whole frame's round, and the owned
    sums add up to the whole frame's. K2's with bfloat16 duals too: the
    rounding is pointwise."""
    rng = np.random.default_rng(3)
    h, w, k = 40, 24, 6
    state = torch.from_numpy(rng.normal(size=(6, h, w)).astype(np.float32))
    consts = torch.from_numpy(rng.normal(size=(4, h, w)).astype(np.float32))
    consts[2] = consts[2].abs() if not k2 else -consts[2].abs()
    rnd = (functools.partial(tvl1_fused.tvl1_level_round_plain, state_dtype=state_dtype)
           if k2 else tvl1_tiled.tvl1_stage_round_plain)
    whole, s_whole = rnd(state, consts, k, 0, h, (0, 0))
    total = 0.0
    for r0, r1 in pflow.row_bounds(h, 3):
        e0, e1 = max(0, r0 - k), min(h, r1 + k)
        blk, s = rnd(state[:, e0:e1], consts[:, e0:e1], k, e0, h, (r0 - e0, e1 - r1))
        torch.testing.assert_close(blk[:, r0 - e0:r1 - e0], whole[:, r0:r1], rtol=0, atol=0)
        total += float(s)
    assert total == pytest.approx(float(s_whole), rel=1e-6)
    with pytest.raises(ValueError):
        rnd(state[:, 10:30], consts[:, 10:30], k, 10, h, (k - 1, k))


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
def test_sharded_flow_bf16_duals(warm):
    """With bfloat16 duals the sharded flow (K2's rounds on sp=2's blocks)
    gives the whole-frame bf16 flow, cold and warm; both differ from the
    float32 flows, so the type reached the rounds."""
    i0, i1 = _torch_pair()
    mesh, kw = _mesh(2), dict(KW, state_dtype="bfloat16")
    pflow.STATS.reset()
    if warm:
        carry = torch.from_numpy(_jax_flows()[1].copy())
        got, _ = parallel.sharded_tvl1_flow_warm(i0, i1, carry, mesh, warm_nwarps=3, **kw)
        want, _ = tvl1.tvl1_flow_warm(i0, i1, carry, warm_nwarps=3, **kw)
        f32, _ = tvl1.tvl1_flow_warm(i0, i1, carry, warm_nwarps=3, **KW)
    else:
        got = parallel.sharded_tvl1_flow(i0, i1, mesh, **kw)
        want = tvl1.tvl1_flow(i0, i1, **kw)
        f32 = tvl1.tvl1_flow(i0, i1, **KW)
    assert (48, 64, 2) in pflow.STATS.levels_sharded and pflow.STATS.rounds["k2"] > 0
    assert float((got - want).abs().max()) <= FLOW_TOL
    assert float((want - f32).abs().max()) > 1e-3


def test_round_ctl_rule():
    """The rounds' stop-or-go (``RoundCtl``, the plain side of the round
    kernel's ``round_go``): round 0 runs and sets the flag; a later round
    runs while the previous round's sums, added in shard order, over the
    level's size exceed epsilon squared; once it stops it stays stopped
    until the next stage's round 0; a running round writes its shard's
    slot of its parity's row."""
    from bwd_nlkalman_tpu_torch.flow.tvl1_tile import RoundCtl

    h, w, eps = 4, 5, 0.01
    ctl = RoundCtl(2, "cpu", eps, h, w)
    ran = []

    def fn(state, consts, k, y0, h_, halo):
        ran.append(y0)
        return state + 1.0, torch.tensor(float(y0))

    st = torch.zeros((6, 2, w))
    limit = float(np.float32(eps * eps)) * h * w
    assert torch.equal(ctl.run_plain(fn, st, None, 1, 7, h, (0, 0), 1, 0), st + 1.0)
    assert float(ctl.sums[0, 1]) == 7.0 and int(ctl.flag) == 1
    ctl.sums[0] = torch.tensor([limit * 0.75, limit * 0.5])      # above the bar together
    assert ctl.go(1) and int(ctl.flag) == 1
    ctl.sums[1] = torch.tensor([limit * 0.25, limit * 0.5])      # below the bar: stop
    assert torch.equal(ctl.run_plain(fn, st, None, 1, 3, h, (0, 0), 0, 2), st)
    assert int(ctl.flag) == 0 and ran == [7]
    ctl.sums[0] = torch.tensor([limit * 4, 0.0])
    assert not ctl.go(3) and int(ctl.flag) == 0
    assert ctl.go(0) and int(ctl.flag) == 1


@pytest.mark.parametrize("sp", SPS)
def test_sharded_occlusion(sp):
    flow = torch.from_numpy(np.random.default_rng(5).normal(0, 0.6, (48, 64, 2))
                            .astype(np.float32))
    got = parallel.sharded_occlusion_mask(flow, _mesh(sp), 0.75)
    want = occlusion_mask(flow, 0.75)
    assert 0 < float(want.mean()) < 255
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_occ.occlusion_mask(
        jnp.asarray(flow.numpy()), 0.75)))


@pytest.mark.parametrize("sp", SPS)
def test_sharded_warps(sp):
    """Both warps: the denoiser's (occluded pixels invalid, 2 channels) and
    TV-L1's (I1 and its gradients warped for a warp stage's constants, in
    K3's and K2's form), each shard's rows against the whole frame's, and
    each warp against JAX's."""
    rng = np.random.default_rng(6)
    h, w = 48, 64
    im = torch.from_numpy(rng.uniform(0, 255, (h, w, 2)).astype(np.float32))
    flow = torch.from_numpy(rng.normal(0, 3, (h, w, 2)).astype(np.float32))
    occ = torch.from_numpy(np.where(rng.uniform(size=(h, w)) < 0.1, 255.0, 0.0)
                           .astype(np.float32))
    mesh = _mesh(sp)
    out, valid = parallel.sharded_warp(im, flow, occ, mesh)
    w_out, w_valid = bicubic_warp(im, flow, occ)
    assert torch.equal(valid, w_valid) and torch.equal(out, w_out)
    j_out, j_valid = j_warp.warp_bicubic_nan(jnp.asarray(im.numpy()), jnp.asarray(flow.numpy()),
                                             jnp.asarray(occ.numpy()))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    np.testing.assert_allclose(torch.where(valid[..., None], out, 0).numpy(),
                               np.where(np.asarray(j_valid)[..., None], np.asarray(j_out), 0),
                               rtol=1e-5, atol=1e-3)
    i1 = im[..., 0]
    i1s = torch.stack([i1, *tvl1_tiled.centered_gradient(i1)], dim=-1)
    state = torch.cat([flow.permute(2, 0, 1), torch.zeros((4, h, w))])
    j_i1s = np.asarray(j_warp.warp_bicubic_zero_multi(
        jnp.asarray(i1s.numpy()), jnp.asarray(flow[..., 0].numpy()),
        jnp.asarray(flow[..., 1].numpy())))
    for nig in (False, True):
        whole = tvl1_tiled.tvl1_stage_consts(i1s, state, im[..., 1], nig=nig)
        np.testing.assert_allclose(whole[:2].permute(1, 2, 0).numpy(), j_i1s[..., 1:],
                                   rtol=1e-5, atol=1e-3)
        for r0, r1 in pflow.row_bounds(h, sp):
            blk = tvl1_tiled.tvl1_stage_consts(i1s, state[:, r0:r1].contiguous(),
                                               im[r0:r1, :, 1], y0=r0, nig=nig)
            assert torch.equal(blk, whole[:, r0:r1])


def _clip(t=3, h=96, w=48, sigma=20.0, seed=0):
    rng = np.random.default_rng(seed)
    base = np.cumsum(np.cumsum(rng.standard_normal((h + 8, w + 8)), 0), 1)
    base = ((base - base.min()) / (base.max() - base.min()) * 175 + 40).astype(np.float32)
    clean = np.stack([base[i:i + h, i:i + w] for i in range(t)])[..., None]
    return clean, clean + sigma * rng.standard_normal(clean.shape).astype(np.float32)


def _psnr(clean, x):
    return float(10 * np.log10(255.0 ** 2 / np.mean((np.asarray(x) - clean) ** 2)))


@pytest.mark.parametrize("sp,h,w", [(2, 48, 64), (3, 96, 48)])
def test_sharded_sequence_psnr(sp, h, w, xla_granularity):
    """The sharded sequence (flow sharded: its fscale=1 level, 24x32 or
    48x24, owns 12 or 16 rows a shard) on 3 frames at warm fscale=1: flt2
    and smo1 within 0.05 dB of the unsharded port. 96x48 at sp=3: the NLK
    passes need row blocks of at least their 20-row halo."""
    clean, noisy = _clip(h=h, w=w)
    x = torch.from_numpy(noisy)
    cfg = FlowConfig(warm_start=True, warm_nwarps=3)
    pflow.STATS.reset()
    _, flt2, smo1 = parallel.denoise_sequence_sharded(x, 20.0, _mesh(sp), flow_cfg=cfg)
    assert (h // 2, w // 2, sp) in pflow.STATS.levels_sharded
    _, w_flt2, w_smo1 = denoise_sequence(x, 20.0, flow_cfg=cfg)
    assert abs(_psnr(clean, flt2) - _psnr(clean, w_flt2)) <= 0.05
    assert abs(_psnr(clean, smo1) - _psnr(clean, w_smo1)) <= 0.05
    assert _psnr(clean, smo1) > _psnr(clean, noisy) + 6.0
