"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where there is no CUDA device (the CPU
test machines have none, and no nvcc). On a GPU machine, run
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q``
(``--noconftest`` keeps JAX out: the repo's conftest imports it). This
file imports no JAX.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from bwd_nlkalman_tpu_torch.core import engine_cuda
from bwd_nlkalman_tpu_torch.core.engine import dense_pass_v2
from bwd_nlkalman_tpu_torch.core.engine_cuda import PATCH_SIZES, dense_pass_cuda, pass_radius
from bwd_nlkalman_tpu_torch.flow import tvl1_block_cuda as k3
from bwd_nlkalman_tpu_torch.flow import tvl1_cuda as k2
from bwd_nlkalman_tpu_torch.flow import tvl1_fused, tvl1_tiled
from bwd_nlkalman_tpu_torch.flow.tvl1_block_cuda import tvl1_block_cuda
from bwd_nlkalman_tpu_torch.flow.tvl1_cuda import tvl1_level_cuda
from bwd_nlkalman_tpu_torch.flow.tvl1_fused import tvl1_level_plain
from bwd_nlkalman_tpu_torch.ops import warp_cuda
from bwd_nlkalman_tpu_torch.ops.warp import bicubic_warp_plain
from bwd_nlkalman_tpu_torch.ops.warp_cuda import bicubic_warp_cuda
from bwd_nlkalman_tpu_torch.params import FilterMode, default_params
from bwd_nlkalman_tpu_torch.tools import vpu_probe
from bwd_nlkalman_tpu_torch.tools.k1_bench import nlk_inputs, search_cases, widened_cases
from bwd_nlkalman_tpu_torch.tools.warp_bench import noisy_flow

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


@pytest.mark.parametrize("band", [False, True])
@pytest.mark.parametrize("occl", [False, True])
@pytest.mark.parametrize("h,w", [(1, 1), (3, 3), (17, 16), (32, 40), (37, 53), (270, 480)])
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 21])
def test_warp_kernel_matches_plain(dev, c, h, w, occl, band):
    """K4 against its plain version: every channel instance (1, 2, 3, 6,
    9, and the generic one at 4, 5, 7 and 8), launches in channel groups
    (10, 12 and 14, the filter's and fsmo's warps of 4-7-channel clips, and
    21, odd), frames with no valid pixel, ragged tiles, occlusion, and a
    band shifted by hundreds of pixels."""
    rng = np.random.default_rng(c)
    im = _t(rng.uniform(0, 255, (h, w, c)).astype(np.float32), dev)
    flow = _t(noisy_flow(rng, h, w, band), dev)
    oc = _t(np.where(rng.uniform(size=(h, w)) < 0.1, 255.0, 0.0).astype(np.float32),
            dev) if occl else None
    out, valid = bicubic_warp_cuda(im, flow, oc)
    ref, ref_valid = bicubic_warp_plain(im, flow, oc)
    assert valid.dtype == torch.bool and torch.equal(valid, ref_valid)
    torch.testing.assert_close(out, ref, rtol=0.0, atol=1e-3)


@pytest.mark.parametrize("c", range(1, 25))
def test_warp_kernel_takes_any_channel_count_in_one_launch(dev, c):
    """1..24 channels, each one launch of its channel-group plan, against
    the plain version (test_warp_kernel_matches_plain's bar)."""
    rng = np.random.default_rng(c + 40)
    h, w = 37, 53
    im = _t(rng.uniform(0, 255, (h, w, c)).astype(np.float32), dev)
    flow = _t(noisy_flow(rng, h, w, False), dev)
    oc = _t(np.where(rng.uniform(size=(h, w)) < 0.1, 255.0, 0.0).astype(np.float32), dev)
    warp_cuda.LAUNCHES.reset()
    warp_cuda.LAUNCHES_GROUPED.reset()
    out, valid = bicubic_warp_cuda(im, flow, oc)
    assert warp_cuda.LAUNCHES.count == 1
    assert warp_cuda.LAUNCHES_GROUPED.count == int(len(warp_cuda.channel_groups(c)) > 1)
    ref, ref_valid = bicubic_warp_plain(im, flow, oc)
    assert torch.equal(valid, ref_valid)
    torch.testing.assert_close(out, ref, rtol=0.0, atol=1e-3)


@pytest.mark.parametrize("c", [10, 11, 12, 13, 14, 15, 16, 17, 21, 24])
def test_warp_kernel_groups_keep_the_one_group_bits(dev, c):
    """Each channel group of a launch of more than 9 channels gives the
    output and mask of the one-group launch of its channels (8, or the
    rest: 1-8 over these counts).

    Groups run the generic instance. So a group of 4, 5, 7 or 8 channels
    keeps the bits of that count's own launch, the generic instance too.
    The instances of 1, 2, 3 and 6 keep the parent's code, whose compiled
    FMA contraction differs from the generic instance's: against them a
    group is held to test_warp_kernel_matches_plain's bar of 1e-3 (a
    float32 ulp of the values near 255 is 1.5e-5)."""
    rng = np.random.default_rng(c + 60)
    h, w = 270, 480
    im = _t(rng.uniform(0, 255, (h, w, c)).astype(np.float32), dev)
    flow = _t(noisy_flow(rng, h, w, True), dev)
    oc = _t(np.where(rng.uniform(size=(h, w)) < 0.1, 255.0, 0.0).astype(np.float32), dev)
    out, valid = bicubic_warp_cuda(im, flow, oc)
    for c0, n in warp_cuda.channel_groups(c):
        want, want_valid = bicubic_warp_cuda(im[..., c0:c0 + n].contiguous(), flow, oc)
        assert torch.equal(want_valid, valid), c0
        if n in (1, 2, 3, 6):
            torch.testing.assert_close(out[..., c0:c0 + n], want, rtol=0.0, atol=1e-3)
        else:
            assert torch.equal(out[..., c0:c0 + n], want), c0


def test_warp_kernel_takes_unaligned_tensors(dev):
    """Contiguous views whose data is 4 bytes off an 8-byte boundary."""
    rng = np.random.default_rng(2)
    h, w, c = 37, 53, 2
    im = torch.empty(h * w * c + 1, device=dev)[1:].view(h, w, c)
    im.copy_(_t(rng.uniform(0, 255, (h, w, c)).astype(np.float32), dev))
    flow = torch.empty(h * w * 2 + 1, device=dev)[1:].view(h, w, 2)
    flow.copy_(_t(noisy_flow(rng, h, w, False), dev))
    out, valid = bicubic_warp_cuda(im, flow)
    ref, ref_valid = bicubic_warp_plain(im, flow)
    assert torch.equal(valid, ref_valid)
    torch.testing.assert_close(out, ref, rtol=0.0, atol=1e-3)


@pytest.mark.parametrize("h,w", [(3, 3), (25, 41), (270, 480)])
@pytest.mark.parametrize("band", [False, True])
def test_warp_tvl1_consts_kernel_matches_plain(dev, h, w, band):
    """K4's TV-L1 entry against ``tvl1_stage_consts_plain``: the warped
    planes to 1e-3 as every warp, grad and rho_c to 2e-2 (products with
    gradients and flow), and exactly 0 / -i0 out of the frame."""
    rng = np.random.default_rng(9)
    i0, i1 = _level_pair(dev, h, w)
    i1x, i1y = tvl1_tiled.centered_gradient(i1)
    i1s = torch.stack([i1, i1x, i1y], -1)
    state = _t(rng.normal(0, 0.3, (6, h, w)).astype(np.float32), dev)
    state[:2] = _t(np.moveaxis(noisy_flow(rng, h, w, band), -1, 0), dev)
    warp_cuda.LAUNCHES.reset()
    got = warp_cuda.warp_tvl1_consts_cuda(i1s, state, i0)
    assert warp_cuda.LAUNCHES.count == 1
    want = tvl1_tiled.tvl1_stage_consts_plain(i1s, state, i0)
    torch.testing.assert_close(got[:2], want[:2], rtol=0.0, atol=1e-3)
    torch.testing.assert_close(got[2:], want[2:], rtol=0.0, atol=2e-2)
    _, valid = bicubic_warp_plain(i1s, state[:2].permute(1, 2, 0).contiguous())
    out = ~valid
    assert out.any()
    assert not got[:3, out].any() and torch.equal(got[3, out], -i0[out])
    assert torch.equal(tvl1_tiled.tvl1_stage_consts(i1s, state, i0), got)


NLK_CASES = [
    # mode, filter mode, has_prev, has_basic, h, w, channels, search_sz_x,
    # invalid blocks in prev_valid
    ("filter", FilterMode.FLT1, False, False, 48, 64, 1, None, False),
    ("filter", FilterMode.FLT1, True, False, 48, 64, 1, None, False),
    ("filter", FilterMode.FLT2, True, True, 48, 64, 1, None, False),
    ("smooth", FilterMode.SMO1, True, False, 48, 64, 1, None, False),
    # a ragged frame: hh - 1 no multiple of 4, a partial last run of sites
    ("filter", FilterMode.FLT1, True, False, 37, 53, 1, None, False),
    ("smooth", FilterMode.SMO1, True, False, 37, 53, 1, None, False),
    ("filter", FilterMode.FLT1, True, False, 48, 64, 2, None, False),
    ("filter", FilterMode.FLT1, True, False, 37, 53, 3, None, False),
    ("smooth", FilterMode.SMO1, True, False, 37, 53, 3, None, False),
    # the largest window K1 takes: 961 offsets
    ("filter", FilterMode.FLT1, True, False, 64, 96, 1, 15, False),
    ("filter", FilterMode.FLT1, False, False, 64, 96, 1, 15, False),
    # compact and full candidate lists in one site block
    ("filter", FilterMode.FLT1, True, False, 48, 64, 1, None, True),
    ("filter", FilterMode.FLT2, True, True, 48, 64, 1, None, True),
]


@pytest.mark.parametrize("mode,fm,has_prev,has_basic,h,w,c,sx,blocks", NLK_CASES)
def test_nlk_kernel_matches_plain(dev, mode, fm, has_prev, has_basic, h, w, c, sx,
                                  blocks):
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    clean = (100 + 60 * np.sin(0.1 * xx) + 50 * np.cos(0.13 * yy))[..., None]
    clean = np.repeat(clean, c, -1).astype(np.float32)
    cur = _t(clean + 20 * rng.standard_normal(clean.shape).astype(np.float32), dev)
    valid = np.ones((h, w), bool)
    valid[:2] = valid[:, :2] = False
    if blocks:  # sites of one block see valid and invalid previous patches
        valid[14:22, 18:26] = False
        valid[30:33, 40:44] = False
    prev = _t(np.where(valid[..., None], clean + 2 * rng.standard_normal(clean.shape), 0)
              .astype(np.float32), dev)
    basic = _t(clean + 4 * rng.standard_normal(clean.shape).astype(np.float32), dev)
    valid = _t(valid, dev)
    if not has_prev:
        prev, valid = torch.zeros_like(cur), torch.zeros_like(valid)
    prms = default_params(20.0, fm)
    if sx is not None:
        prms = dataclasses.replace(prms, search_sz_x=sx)
    args = (cur, prev, valid, basic if has_basic else cur, 20.0, prms, mode,
            has_prev, has_basic)
    torch.testing.assert_close(dense_pass_cuda(*args), dense_pass_v2(*args),
                               rtol=1e-3, atol=5e-2)


@pytest.mark.parametrize("window_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("psz,c,mode,has_prev,has_basic,prms",
                         widened_cases(PATCH_SIZES, (1, 3, 4, 7)))
def test_nlk_kernel_sizes_match_plain(dev, psz, c, mode, has_prev, has_basic, prms,
                                      window_dtype):
    """K1 at every patch size it is built for and 1, 3, 4 and 7 channels,
    each kind of pass in turn, on float32 and bfloat16 bands, against the
    plain pass with the same bands, at K1's bar (rtol 1e-3, atol 5e-2: a
    distance summed in another order can flip a selection tie)."""
    rng = np.random.default_rng(psz * 10 + c)
    cur, prev, valid, basic = (_t(a, dev) for a in nlk_inputs(rng, 48, 64, c))
    if not has_prev:
        prev, valid = torch.zeros_like(cur), torch.zeros_like(valid)
    args = (cur, prev, valid, basic if has_basic else cur, 20.0, prms, mode,
            has_prev, has_basic, None, window_dtype)
    engine_cuda.LAUNCHES.reset()
    got = dense_pass_cuda(*args)
    assert engine_cuda.LAUNCHES.count == 1
    torch.testing.assert_close(got, dense_pass_v2(*args), rtol=1e-3, atol=5e-2)


def _level_pair(dev, h=25, w=41):
    rng = np.random.default_rng(7)
    base = np.cumsum(np.cumsum(rng.normal(size=(h + 8, w + 8)), 0), 1)
    base = ((base - base.min()) / (base.max() - base.min()) * 255).astype(np.float32)
    return _t(base[4:4 + h, 4:4 + w], dev), _t(base[2:2 + h, 5:5 + w], dev)


@pytest.mark.parametrize("nwarps,k_check,max_iters,atol",
                         [(2, 8, 32, 2e-3), (1, 1, 1, 1e-5)])
def test_tvl1_level_kernel_matches_plain(dev, nwarps, k_check, max_iters, atol):
    h, w = 25, 41
    i0, i1 = _level_pair(dev, h, w)
    u0 = torch.zeros((h, w, 2), device=dev)
    kw = dict(nwarps=nwarps, k_check=k_check, max_iters=max_iters)
    torch.testing.assert_close(tvl1_level_cuda(i0, i1, u0, **kw),
                               tvl1_level_plain(i0, i1, u0, **kw),
                               rtol=0.0, atol=atol)


@pytest.mark.parametrize("nwarps,k_check,max_iters", [(1, 1, 2), (1, 1, 3), (2, 8, 32)])
def test_tvl1_level_kernel_bf16_matches_plain(dev, nwarps, k_check, max_iters):
    """K2 with bfloat16 duals gives its plain version's bits: its rule
    rounds every operation on its own in the plain version's order, the
    warp stage's constants too. Rounds of one iteration (u depends on the
    rounded duals from the second on) and two warp stages of rounds of 8;
    the float32 level differs."""
    h, w = 25, 41
    i0, i1 = _level_pair(dev, h, w)
    u0 = torch.zeros((h, w, 2), device=dev)
    kw = dict(nwarps=nwarps, k_check=k_check, max_iters=max_iters)
    want = tvl1_level_plain(i0, i1, u0, state_dtype="bfloat16", **kw)
    assert torch.equal(tvl1_level_cuda(i0, i1, u0, state_dtype="bfloat16", **kw), want)
    assert not torch.equal(tvl1_level_plain(i0, i1, u0, **kw), want)


@pytest.mark.parametrize("h,w", [(25, 41), (270, 480)])
@pytest.mark.parametrize("band", [False, True])
def test_warp_tvl1_consts_kernel_bf16_form_matches_plain(dev, h, w, band):
    """K4's TV-L1 entry in the form of K2's bfloat16 rule (each operation
    rounded on its own) gives ``tvl1_stage_consts_plain``'s bits, whole
    and on a row block."""
    rng = np.random.default_rng(9)
    i0, i1 = _level_pair(dev, h, w)
    i1s = torch.stack([i1, *tvl1_tiled.centered_gradient(i1)], -1)
    state = _t(rng.normal(0, 0.3, (6, h, w)).astype(np.float32), dev)
    state[:2] = _t(np.moveaxis(noisy_flow(rng, h, w, band), -1, 0), dev)
    got = warp_cuda.warp_tvl1_consts_cuda(i1s, state, i0, nig=True, state_dtype="bfloat16")
    assert torch.equal(got, tvl1_tiled.tvl1_stage_consts_plain(i1s, state, i0, nig=True))
    r0 = h // 3
    blk = state[:, r0:].contiguous()
    assert torch.equal(warp_cuda.warp_tvl1_consts_cuda(i1s, blk, i0[r0:].contiguous(), r0,
                                                       True, "bfloat16"), got[:, r0:])


@pytest.mark.parametrize("h,w", [(25, 41), (270, 480)])
@pytest.mark.parametrize("k,nwarps,max_iters,atol", [(24, 2, 48, 2e-3), (1, 1, 1, 1e-5)])
def test_tvl1_tiled_kernel_matches_plain(dev, monkeypatch, h, w, k, nwarps,
                                         max_iters, atol):
    """K3 (with K4 warps) against its plain version over whole levels, with
    the bars of the JAX suite's K2: two blocks per warp stage, and one
    iteration."""
    monkeypatch.setattr(tvl1_tiled, "K_ITERS", k)
    i0, i1 = _level_pair(dev, h, w)
    u0 = torch.zeros((h, w, 2), device=dev)
    kw = dict(nwarps=nwarps, max_iters=max_iters)
    torch.testing.assert_close(tvl1_tiled.tvl1_single_scale_tiled(i0, i1, u0, **kw),
                               tvl1_tiled.tvl1_level_tiled_plain(i0, i1, u0, **kw),
                               rtol=0.0, atol=atol)


# levels of one tile whose halo is the frame border (2x2, 17x16, 25x41,
# 37x53) and of many tiles with seams and a ragged last row and column
# (270x480), at rounds of 1, 10 and 24 iterations
LEVELS = [(2, 2), (17, 16), (25, 41), (37, 53), (270, 480)]


@pytest.mark.parametrize("h,w", LEVELS)
@pytest.mark.parametrize("k", [1, 10, 24])
def test_tvl1_level_kernel_counts_match_plain(dev, monkeypatch, h, w, k):
    """K2 against its plain version to convergence (two warp stages, a cap
    of 300): the same iteration count, and the flow within 1e-2."""
    i0, i1 = _level_pair(dev, h, w)
    u0 = torch.zeros((h, w, 2), device=dev)
    kw = dict(nwarps=2, k_check=k, max_iters=300)
    plain_iters = []
    one_iter = tvl1_fused._one_iter
    monkeypatch.setattr(tvl1_fused, "_one_iter",
                        lambda *a: plain_iters.append(1) or one_iter(*a))
    want = tvl1_level_plain(i0, i1, u0, **kw)
    k2.ITERATIONS.reset()
    got = tvl1_level_cuda(i0, i1, u0, **kw)
    assert k2.ITERATIONS.count == len(plain_iters)
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-2)


@pytest.mark.parametrize("h,w", LEVELS)
@pytest.mark.parametrize("k", [1, 10, 24])
def test_tvl1_tiled_kernel_counts_match_plain(dev, monkeypatch, h, w, k):
    """K3's level (with K4 warps) against its plain version to convergence:
    the same block count, the flow within 1e-2, and no host sync in the
    kernel's level (sync debug mode "error" raises on one)."""
    monkeypatch.setattr(tvl1_tiled, "K_ITERS", k)
    i0, i1 = _level_pair(dev, h, w)
    u0 = torch.zeros((h, w, 2), device=dev)
    kw = dict(nwarps=2, max_iters=300)
    plain_blocks = []
    block = tvl1_tiled.tvl1_block
    monkeypatch.setattr(tvl1_tiled, "tvl1_block",
                        lambda *a, **k_: plain_blocks.append(1) or block(*a, **k_))
    want = tvl1_tiled.tvl1_level_tiled_plain(i0, i1, u0, **kw)
    k3.LAUNCHES.reset()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tvl1_tiled.tvl1_single_scale_tiled(i0, i1, u0, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert k3.LAUNCHES.count == len(plain_blocks)
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-2)


def test_tvl1_block_kernel_error_matches_plain(dev):
    """One block's state and mean squared update, from a mid-level state."""
    rng = np.random.default_rng(11)
    h, w = 270, 480
    state = _t(rng.normal(0, 0.5, (6, h, w)).astype(np.float32), dev)
    state[2:, :, -1] = 0.0   # dual planes are zero at the last column / row
    state[2:, -1, :] = 0.0
    consts = _t(rng.normal(0, 1, (4, h, w)).astype(np.float32), dev)
    consts[2] = consts[0] ** 2 + consts[1] ** 2
    got, got_err = tvl1_block_cuda(state, consts, 24)
    want, want_err = tvl1_tiled.tvl1_block_plain(state, consts, 24)
    torch.testing.assert_close(got, want, rtol=0.0, atol=2e-3)
    torch.testing.assert_close(got_err, want_err, rtol=1e-3, atol=0.0)


@pytest.mark.parametrize("variant", list(vpu_probe.VARIANTS))
def test_probe_kernel_matches_plain(dev, variant):
    nchains, op, dtype = vpu_probe.VARIANTS[variant]
    a = vpu_probe.probe_input(64, 512, dev)
    got = vpu_probe.probe_cuda(a, nchains, op, dtype, k=8)
    want = vpu_probe.probe_plain(a, nchains, op, dtype, k=8)
    rtol = 1e-6 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=rtol, atol=0.0)


def test_streaming_fsmo_kernels_match_plain(dev):
    """Streaming fsmo on a 64x80 RGB clip through the kernels against the
    plain versions on the card: every output's PSNR within 0.05 dB (the
    slice's bar in chip_smoke.py), and the 9-channel warp through K4."""
    from bwd_nlkalman_tpu_torch.pipeline.stream import StreamingDenoiser

    rng = np.random.default_rng(4)
    t, h, w = 3, 64, 80
    fields = [np.cumsum(np.cumsum(rng.standard_normal((h + 8, w + 8)), 0), 1)
              for _ in range(3)]
    base = np.stack([(f - f.min()) / (f.max() - f.min()) * 175 + 40 for f in fields], -1)
    clean = np.stack([base[i:i + h, i:i + w] for i in range(t)]).astype(np.float32)
    noisy = _t(clean + 20 * rng.standard_normal(clean.shape).astype(np.float32), dev)
    clean = _t(clean, dev)
    res = {}
    for engine in ("auto", "plain"):
        warp_cuda.LAUNCHES_C9.reset()
        sd = StreamingDenoiser(20.0, smoother="fsmo", engine=engine, device=dev)
        outs = [sd.step(f) + (sd.smo,) for f in noisy]
        res[engine] = [float(10 * torch.log10(255.0 ** 2 / torch.mean((x - clean) ** 2)))
                       for x in (torch.stack(o) for o in zip(*outs))]
        assert warp_cuda.LAUNCHES_C9.count == (t - 1 if engine == "auto" else 0)
    for got, want in zip(res["auto"], res["plain"]):
        assert abs(got - want) <= 0.05


@pytest.mark.parametrize("name,mode,has_prev,has_basic,prms", search_cases(),
                         ids=[c[0] for c in search_cases()])
def test_nlk_kernel_at_search_extremes(dev, name, mode, has_prev, has_basic, prms):
    """K1 against its plain version on a 400x400 gray pass (the training
    protocol's crop) at the parameter search's extremes: npx 1 and 98, nagg
    20, and group sizes above the window's candidate count. Held by share
    of pixels past K1's bar (rtol 1e-3, atol 5e-2) and by mean abs error,
    as chip_smoke.py holds the 1080p passes: a selection tie can flip."""
    rng = np.random.default_rng(40)
    cur, prev, valid, basic = (_t(a, dev) for a in nlk_inputs(rng, 400, 400, 1))
    if not has_prev:
        prev, valid = torch.zeros_like(cur), torch.zeros_like(valid)
    args = (cur, prev, valid, basic if has_basic else cur, 20.0, prms, mode,
            has_prev, has_basic)
    engine_cuda.LAUNCHES.reset()
    got = dense_pass_cuda(*args)
    assert engine_cuda.LAUNCHES.count == 1
    want = dense_pass_v2(*args)
    diff = (got - want).abs()
    assert float((diff > 5e-2 + 1e-3 * want.abs()).float().mean()) <= 5e-5
    assert float(diff.mean()) <= 2e-4


SHARD_PASSES = {"flt prev basic": ("filter", FilterMode.FLT2, True, True),
                "flt first frame": ("filter", FilterMode.FLT1, False, False),
                "smo": ("smooth", FilterMode.SMO1, True, False)}


@pytest.mark.parametrize("kind", list(SHARD_PASSES))
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("psz", [4, 8])
@pytest.mark.parametrize("window_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sp", [2, 4])
def test_nlk_kernel_shard_arguments_match_plain(dev, sp, window_dtype, psz, c, kind):
    """K1 with ``site_rows``, ``qy_bounds`` and ``return_accum`` on every
    shard's halo-extended block of a 96x80 frame, against the plain pass
    with the same arguments: the sums and weights, scaled by the largest
    weight, at K1's bar (rtol 1e-3; atol 5e-2 on the sums, in pixel
    units, 5e-2/255 on the weights); rows no owned site reaches hold
    nothing; and the folded, normalised shards against K1's whole-frame
    pass at the JAX package's sharded bar (rtol 1e-4, atol 2e-3)."""
    from bwd_nlkalman_tpu_torch.parallel.spatial import (_halo_extend, _halo_fold,
                                                         shard_bounds, shard_halo)

    mode, fm, has_prev, has_basic = SHARD_PASSES[kind]
    prms = dataclasses.replace(default_params(20.0, fm), patch_sz=psz, search_sz_x=6,
                               search_sz_t=3)
    h, w = 96, 80
    rng = np.random.default_rng(psz + c)
    cur, prev, valid, basic = (_t(a, dev) for a in nlk_inputs(rng, h, w, c))
    if not has_prev:
        prev, valid = torch.zeros_like(cur), torch.zeros_like(valid)
    if not has_basic:
        basic = cur
    halo, block = shard_halo(prms, mode), h // sp
    ext = [_halo_extend([x[i * block:(i + 1) * block] for i in range(sp)], halo)
           for x in (cur, prev, valid, basic)]
    outs, aggs = [], []
    for i in range(sp):
        site_rows, qy = shard_bounds(i, block, halo, h, psz)
        args = (*(e[i].contiguous() for e in ext), 20.0, prms, mode, has_prev, has_basic)
        kw = dict(window_dtype=window_dtype, site_rows=site_rows, qy_bounds=qy,
                  return_accum=True)
        out, agg = dense_pass_cuda(*args, **kw)
        want_out, want_agg = dense_pass_v2(*args, **kw)
        s = float(want_agg.max())
        assert s > 0.0
        torch.testing.assert_close(out / s, want_out / s, rtol=1e-3, atol=5e-2)
        torch.testing.assert_close(agg / s, want_agg / s, rtol=1e-3, atol=5e-2 / 255)
        assert float(agg[:halo - pass_radius(prms, mode)].abs().max()) == 0.0
        outs.append(out)
        aggs.append(agg)
    outs, aggs = _halo_fold(outs, halo), _halo_fold(aggs, halo)
    got = torch.cat([torch.where((a > 1e-6)[..., None], o / torch.clamp(a, min=1e-6)[..., None],
                                 cur[i * block:(i + 1) * block])
                     for i, (o, a) in enumerate(zip(outs, aggs))])
    whole = dense_pass_cuda(cur, prev, valid, basic, 20.0, prms, mode, has_prev, has_basic,
                            window_dtype=window_dtype)
    torch.testing.assert_close(got, whole, rtol=1e-4, atol=2e-3)


def test_sharded_frame_passes_on_one_card(dev):
    """``spatial_filter_frame`` / ``spatial_smooth_frame`` on ``[cuda:0] * 3``
    launch K1 once a shard and agree with the whole-frame K1 pass."""
    from bwd_nlkalman_tpu_torch.core.engine_cuda import LAUNCHES
    from bwd_nlkalman_tpu_torch.core.nlkalman import (nlkalman_filter_frame,
                                                     nlkalman_smooth_frame)
    from bwd_nlkalman_tpu_torch.parallel import (make_mesh, spatial_filter_frame,
                                                 spatial_smooth_frame)

    rng = np.random.default_rng(9)
    cur, prev, valid, basic = (_t(a, dev) for a in nlk_inputs(rng, 120, 96, 1))
    mesh = make_mesh(1, 3, ["cuda:0"] * 3)
    p1, ps = default_params(20.0, FilterMode.FLT1), default_params(20.0, FilterMode.SMO1)
    LAUNCHES.reset()
    got = spatial_filter_frame(cur, prev, valid, None, 20.0, p1, mesh)
    assert LAUNCHES.count == 3
    torch.testing.assert_close(got, nlkalman_filter_frame(cur, prev, valid, None, 20.0, p1),
                               rtol=1e-4, atol=2e-3)
    got = spatial_smooth_frame(cur, prev, valid, 20.0, ps, mesh)
    torch.testing.assert_close(got, nlkalman_smooth_frame(cur, prev, valid, 20.0, ps),
                               rtol=1e-4, atol=2e-3)


@pytest.mark.parametrize("rule", ["k2", "k3", "k2-bf16"])
@pytest.mark.parametrize("k", [4, 8, 10, 24])
@pytest.mark.parametrize("sp", [1, 2, 3])
def test_tvl1_round_kernels_match_plain(dev, sp, k, rule):
    """K2's and K3's round entries on every shard's row block of a 270x480
    level (halo k rows, border rules at the level's edges only) against
    their plain versions from the same mid-level state: the owned rows
    within 2e-3 (k iterations, as the blocks of the JAX suite's bar; the
    halo rows are the neighbours' to fill), the owned rows' sum (the
    shard's slot) within rtol 1e-3, the device count once per running
    round; K2's with bfloat16 duals ("k2-bf16") under the same bars. The stop-or-go as ``RoundCtl.go`` takes it: a later round whose
    previous sums are under epsilon squared runs nothing and clears the
    flag, which keeps the next round from running even above the bar,
    until a round 0 sets it again."""
    from bwd_nlkalman_tpu_torch.flow.tvl1_tile import RoundCtl
    from bwd_nlkalman_tpu_torch.parallel.flow import row_bounds

    rng = np.random.default_rng(13)
    h, w = 270, 480
    state = _t(rng.normal(0, 0.5, (6, h, w)).astype(np.float32), dev)
    consts = _t(rng.normal(0, 1, (4, h, w)).astype(np.float32), dev)
    g = consts[0] ** 2 + consts[1] ** 2
    is_k2 = rule.startswith("k2")
    consts[2] = -1.0 / g if is_k2 else g
    kernel = k2.tvl1_level_round_cuda if is_k2 else k3.tvl1_stage_round_cuda
    plain = tvl1_fused.tvl1_level_round_plain if is_k2 else tvl1_tiled.tvl1_stage_round_plain
    if rule == "k2-bf16":
        sd = dict(state_dtype="bfloat16")
        kernel, plain = (functools.partial(kernel, **sd), functools.partial(plain, **sd))
    counter = k2.ITERATIONS if is_k2 else k3.LAUNCHES
    count = k if is_k2 else 1
    ctl = RoundCtl(sp, dev, 0.01, h, w)
    for i, (r0, r1) in enumerate(row_bounds(h, sp)):
        e0, e1 = max(0, r0 - k), min(h, r1 + k)
        halo = (r0 - e0, e1 - r1)
        blk, cs = state[:, e0:e1].contiguous(), consts[:, e0:e1].contiguous()
        want, want_s = plain(blk, cs, k, e0, h, halo)
        counter.reset()
        got = kernel(blk.clone(), cs, k, e0, h, halo, ctl, i, 0, count=True)
        assert counter.count == count and int(ctl.flag) == 1
        own = slice(halo[0], e1 - e0 - halo[1])
        torch.testing.assert_close(got[:, own], want[:, own], rtol=0.0, atol=2e-3)
        torch.testing.assert_close(ctl.sums[0, i], want_s, rtol=1e-3, atol=0.0)
    small = float(np.float32(0.01 * 0.01)) * h * w / (2 * sp)
    for r, prev, runs in ((1, small, False), (2, 1e6, False), (0, 0.0, True)):
        ctl.sums[(r - 1) % 2] = prev
        counter.reset()
        got = kernel(blk.clone(), cs, k, e0, h, halo, ctl, sp - 1, r, count=True)
        assert torch.equal(got, blk) != runs and int(ctl.flag) == int(runs)
        assert counter.count == (count if runs else 0)


@pytest.mark.parametrize("nig", [False, True])
@pytest.mark.parametrize("c", [1, 2, 3, 9, 12])
@pytest.mark.parametrize("sp", [1, 2, 3])
def test_warp_kernel_row_offset_matches_plain(dev, sp, c, nig):
    """K4's shard form: each shard's rows of the warp (from the whole
    source) and of the TV-L1 entry's constants (K3's and K2's form), on a
    270x480 frame with a band of flow, against the plain versions with the
    same row offset, at test_warp_kernel_matches_plain's bar (K2's nig
    through the |grad|^2 it inverts: a small gradient's last bits move its
    inverse by more); and the row blocks of the kernel against its whole
    frame, equal."""
    from bwd_nlkalman_tpu_torch.parallel.flow import row_bounds

    rng = np.random.default_rng(c + 20)
    h, w = 270, 480
    im = _t(rng.uniform(0, 255, (h, w, c)).astype(np.float32), dev)
    flow = _t(noisy_flow(rng, h, w, True), dev)
    oc = _t(np.where(rng.uniform(size=(h, w)) < 0.1, 255.0, 0.0).astype(np.float32), dev)
    # the TV-L1 entry on a level's smooth image, its gradients and a flow of
    # a few pixels (a band of hundreds of pixels makes rho_c's products
    # large enough that their last bits exceed any fixed bar)
    base = np.cumsum(np.cumsum(rng.normal(size=(h, w)), 0), 1)
    i1 = ((base - base.min()) / (base.max() - base.min()) * 255).astype(np.float32)
    i1s = _t(np.stack([i1, *np.gradient(i1, axis=(1, 0))], -1).astype(np.float32), dev)
    state = torch.cat([_t(noisy_flow(rng, h, w, False), dev).permute(2, 0, 1),
                       torch.zeros((4, h, w), device=dev)])
    i0 = _t(np.roll(i1, 2, axis=1), dev)
    whole, whole_v = bicubic_warp_cuda(im, flow, oc)
    whole_cs = warp_cuda.warp_tvl1_consts_cuda(i1s, state, i0, nig=nig)
    for r0, r1 in row_bounds(h, sp):
        out, valid = bicubic_warp_cuda(im, flow[r0:r1].contiguous(), oc[r0:r1].contiguous(), r0)
        ref, ref_valid = bicubic_warp_plain(im, flow[r0:r1], oc[r0:r1], r0)
        assert torch.equal(valid, ref_valid) and torch.equal(valid, whole_v[r0:r1])
        torch.testing.assert_close(out, ref, rtol=0.0, atol=1e-3)
        assert torch.equal(out, whole[r0:r1])
        blk = state[:, r0:r1].contiguous()
        cs = warp_cuda.warp_tvl1_consts_cuda(i1s, blk, i0[r0:r1].contiguous(), r0, nig)
        ref_cs = tvl1_tiled.tvl1_stage_consts_plain(i1s, blk, i0[r0:r1], r0, nig)
        assert torch.equal(cs, whole_cs[:, r0:r1])
        if nig:  # K2's nig = -1/|grad|^2 held as the |grad|^2 it comes from
            cs, ref_cs = (torch.cat([c[:2], torch.where(c[2:3] != 0, -1.0 / c[2:3], 0.0), c[3:]])
                          for c in (cs, ref_cs))
        torch.testing.assert_close(cs, ref_cs, rtol=1e-5, atol=1e-3)


def test_sharded_flow_on_one_card(dev):
    """The row-sharded flow on ``[cuda:0] * sp`` (K2 rounds on the 270x480
    level of a 540x960 pair, K4's shard form) against the whole-frame
    flow: mean end-point error within 1e-4 px, max abs within 1e-2."""
    from bwd_nlkalman_tpu_torch.flow import tvl1
    from bwd_nlkalman_tpu_torch.parallel import make_mesh, sharded_tvl1_flow

    rng = np.random.default_rng(4)
    h, w = 540, 960
    base = np.cumsum(np.cumsum(rng.normal(size=(h + 8, w + 8)), 0), 1)
    base = ((base - base.min()) / (base.max() - base.min()) * 255).astype(np.float32)
    i0, i1 = _t(base[4:4 + h, 4:4 + w], dev), _t(base[5:5 + h, 6:6 + w], dev)
    want = tvl1.tvl1_flow(i0, i1, fscale=1, lambda_=0.25)
    for sp in (2, 3):
        k2.LAUNCHES.reset()
        got = sharded_tvl1_flow(i0, i1, make_mesh(1, sp, ["cuda:0"] * sp), fscale=1,
                                lambda_=0.25)
        assert k2.LAUNCHES.count > 0
        epe = float(torch.linalg.vector_norm(got - want, dim=-1).mean())
        assert epe <= 1e-4 and float((got - want).abs().max()) <= 1e-2


def test_sharded_flow_bf16_on_one_card(dev):
    """With bfloat16 duals the row-sharded flow on ``[cuda:0] * 2`` gives the
    whole-frame flow's bits: K2's rounds and K4's constants in the bf16
    rule's form compute every pixel as the whole level does."""
    from bwd_nlkalman_tpu_torch.flow import tvl1
    from bwd_nlkalman_tpu_torch.parallel import make_mesh, sharded_tvl1_flow

    rng = np.random.default_rng(4)
    h, w = 540, 960
    base = np.cumsum(np.cumsum(rng.normal(size=(h + 8, w + 8)), 0), 1)
    base = ((base - base.min()) / (base.max() - base.min()) * 255).astype(np.float32)
    i0, i1 = _t(base[4:4 + h, 4:4 + w], dev), _t(base[5:5 + h, 6:6 + w], dev)
    kw = dict(fscale=1, lambda_=0.25, state_dtype="bfloat16")
    want = tvl1.tvl1_flow(i0, i1, **kw)
    k2.LAUNCHES.reset()
    got = sharded_tvl1_flow(i0, i1, make_mesh(1, 2, ["cuda:0"] * 2), **kw)
    assert k2.LAUNCHES.count > 0 and torch.equal(got, want)


def _fmaf(w, x, acc):
    """fmaf(w, x, acc) on float32 arrays, exactly: the product is exact in
    float64, and the float64 sum's rounding error (two-sum) settles the
    float32 ties that rounding twice would get wrong."""
    p = w.astype(np.float64) * x.astype(np.float64)
    a = np.asarray(acc, np.float32).astype(np.float64)
    s = p + a
    z = s - p
    e = (p - (s - z)) + (a - z)
    r = s.astype(np.float32)
    o = np.nextafter(r, np.where(s > r, np.float32(np.inf), np.float32(-np.inf)))
    tie = (e != 0) & (s == (r.astype(np.float64) + o.astype(np.float64)) / 2)
    return np.where(tie & ((e > 0) == (o > r)), o, r)


def _band_chain(x, band_y, band_x, fma):
    """The two passes of G over the (..., H, W) planes of x, rows first,
    each output ``acc = fma(w[t], x[lo + t], acc)`` over its taps in
    ascending order from zero; each band is (lo, weights)."""
    (lo_y, w_y), (lo_x, w_x) = band_y, band_x
    mid = np.float32(0)
    for t in range(w_x.shape[1]):
        mid = fma(w_x[:, t], x[..., lo_x + t], mid)
    out = np.float32(0)
    for t in range(w_y.shape[1]):
        out = fma(w_y[:, t, None], mid[..., lo_y + t, :], out)
    return out


def _hold_band(got, x, key_y, key_x, build, scale=1.0, planes_last=False):
    """G's output ``got`` is the ascending fma chain's bits (``_band_chain``)
    on x, times ``scale``; returns the bound that rounding puts on any
    other order of the same sums, the dense products' included: twice
    gamma(Ty + Tx) of the sums of absolute terms, per output."""
    from bwd_nlkalman_tpu_torch.ops.band_cuda import band_of, band_parts

    by, bx = (band_parts(band_of(build, *k)) for k in (key_y, key_x))
    xp = np.moveaxis(x, -1, 0) if planes_last else x
    want = _band_chain(xp, by, bx, _fmaf) * np.float32(scale)
    mag = _band_chain(np.abs(xp).astype(np.float64),
                      *((lo, np.abs(w).astype(np.float64)) for lo, w in (by, bx)),
                      lambda w, v, acc: w * v + acc)
    if planes_last:
        want, mag = np.moveaxis(want, 0, -1), np.moveaxis(mag, 0, -1)
    g = got.cpu().numpy()
    assert g.shape == want.shape and np.array_equal(g, want)
    n = by[1].shape[1] + bx[1].shape[1]
    return 2 * n * 2.0 ** -24 / (1 - n * 2.0 ** -24) * mag * abs(scale)


def _flow_products(h, w):
    """(step, (P, H, W) input shape or the (h, w, 2) flow's, output (H, W))
    of each product of a flow on (h, w) frames: the pair's blur, every
    zoom-out of the pair and every zoom-in of the flow."""
    from bwd_nlkalman_tpu_torch.flow import tvl1

    sizes = tvl1._pyramid_sizes(w, h, tvl1.num_scales(w, h, 100, 0.5), 0.5)
    out = [("blur", (2, h, w), (h, w))]
    for s, ((pw, ph), (nw, nh)) in enumerate(zip(sizes, sizes[1:])):
        out.append((f"zoomout{s}", (2, ph, pw), (nh, nw)))
        out.append((f"zoomin{s + 1}", (nh, nw, 2), (ph, pw)))
    return out


# the share of the any-order rounding bound that the dense products may
# reach against G: twice the most measured on an H100 (0.25)
BAND_GAP_SHARE = 0.5

BAND_CASES = [(f"{h}x{w}-{step}", step, shape, size)
              for h, w in [(1080, 1920), (400, 400)]
              for step, shape, size in _flow_products(h, w)]


@pytest.mark.parametrize("name,step,shape,size", BAND_CASES, ids=[c[0] for c in BAND_CASES])
def test_band_kernel_is_the_ascending_chain(dev, name, step, shape, size):
    """G on the flow's blur, zoom-outs and flow zoom-ins of the 1080p and
    400x400 pyramids, in one launch a call: the bits of each output's taps
    summed by fma in ascending order from zero, and the dense cuBLAS
    products (the plain version) within the rounding of another order.
    cuBLAS sums most of these shapes in k-slices of its own, so its bits
    are not G's."""
    from bwd_nlkalman_tpu_torch.flow import tvl1
    from bwd_nlkalman_tpu_torch.ops import band_cuda, gaussian, zoom

    rng = np.random.default_rng(len(name))
    band_cuda.LAUNCHES.reset()
    if step == "blur":
        x = rng.uniform(0, 255, shape).astype(np.float32)
        xt = _t(x, dev)
        got = gaussian.gaussian_blur(xt, tvl1.PRESMOOTHING_SIGMA)
        want = torch.stack([gaussian.gaussian_blur(p, tvl1.PRESMOOTHING_SIGMA, engine="plain")
                            for p in xt])
        keys, build, kw = [("blur", n, tvl1.PRESMOOTHING_SIGMA) for n in shape[1:]], \
            gaussian.blur_matrix_np, {}
    elif step.startswith("zoomout"):
        x = rng.uniform(0, 255, shape).astype(np.float32)
        xt = _t(x, dev)
        got = zoom.zoom_out(xt, 0.5)
        want = torch.stack([zoom.zoom_out(p, 0.5, engine="plain") for p in xt])
        keys, build, kw = zoom.zoom_out_keys(*shape[1:], 0.5), zoom._zoom_out_matrix_np, {}
    else:
        x = rng.uniform(-8, 8, shape).astype(np.float32)
        u = _t(x, dev)
        h, w = size
        got = tvl1._zoom_flow(u, w, h, 0.5, None)
        want = torch.stack([zoom.zoom_in(u[..., 0], w, h, engine="plain"),
                            zoom.zoom_in(u[..., 1], w, h, engine="plain")], dim=-1) * 2.0
        keys, build = zoom.zoom_in_keys(*shape[:2], w, h), zoom._resample_matrix_np
        kw = dict(scale=2.0, planes_last=True)
    assert band_cuda.LAUNCHES.count == 1
    bound = _hold_band(got, x, *keys, build, **kw)
    gap = np.abs(got.cpu().numpy().astype(np.float64) - want.cpu().numpy())
    # on an H100 the dense products came within 0.09-0.25 of the bound
    assert got.shape == want.shape and (gap <= BAND_GAP_SHARE * bound).all()


@pytest.mark.parametrize("layout", ["plane", "planes", "strided", "last"])
@pytest.mark.parametrize("h,w,sigma", [(1, 1, 0.8), (9, 15, 0.8), (25, 41, 0.8),
                                       (135, 240, 0.7), (270, 480, 3.0), (68, 120, 12.0)])
def test_band_kernel_layouts_are_the_ascending_chain(dev, h, w, sigma, layout):
    """G on one plane, a stack of planes, the planes of a strided view and
    planes last (the multiscale recompose's channels), at ragged sizes and
    at blurs wide enough to take the plan's smaller tiles: the ascending
    fma chain's bits in one launch, each plane of a stack on a 128-byte
    line."""
    from bwd_nlkalman_tpu_torch.ops import band_cuda, gaussian

    rng = np.random.default_rng(h + w)
    full = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    ft = _t(full, dev)
    x = {"plane": ft[..., 0], "planes": ft.permute(2, 0, 1).contiguous(),
         "strided": ft.permute(2, 0, 1), "last": ft}[layout]
    band_cuda.LAUNCHES.reset()
    got = gaussian.gaussian_blur(x, sigma, planes_last=layout == "last")
    assert band_cuda.LAUNCHES.count == 1
    keys = [("blur", n, float(sigma)) for n in (h, w)]
    ref = {"plane": full[..., 0], "last": full}.get(layout, np.moveaxis(full, -1, 0))
    _hold_band(got, ref, *keys, gaussian.blur_matrix_np, planes_last=layout == "last")
    if layout == "last":
        assert got.is_contiguous()
    elif layout != "plane":
        assert all(got[c].data_ptr() % 128 == 0 for c in range(3))


def test_band_kernel_launches_15_a_cell_flow(dev):
    """G's counter on the benchmark cells' path (cold TV-L1 at fscale 1 on
    1080p gray, ``FlowConfig``'s defaults): 15 launches a flow (the pair's
    blur, 7 zoom-outs of the pair, 7 zoom-ins of the flow), and 15 a flow
    over a request of the denoiser, which makes 2 (T - 1) flows."""
    from bwd_nlkalman_tpu_torch.ops import band_cuda
    from bwd_nlkalman_tpu_torch.pipeline import FlowConfig, NLKalmanDenoiser

    t, h, w = 3, 1080, 1920
    rng = np.random.default_rng(15)
    noisy = _t(rng.uniform(0, 255, (t, h, w, 1)).astype(np.float32), dev)
    cfg = FlowConfig()
    model = NLKalmanDenoiser(20.0, h, w, cfg, device=dev)
    band_cuda.LAUNCHES.reset()
    cfg.flow(noisy[0, ..., 0], noisy[1, ..., 0])
    assert band_cuda.LAUNCHES.count == 15
    band_cuda.LAUNCHES.reset()
    model(noisy)
    assert band_cuda.LAUNCHES.count == 15 * 2 * (t - 1)
