"""The reference at a tiny size on the CPU, held to the program's own
plain versions there: the same operations on the same data give the same
answers."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from portbench.reference import flow as rflow
from portbench.reference import nlk as rnlk
from portbench.reference import noise as rnoise
from portbench.reference import ops as rops
from portbench.reference.params import default_params as rparams

SIGMA = 20.0


def _scene(h, w, seed=0):
    g = torch.Generator().manual_seed(seed)
    b = torch.randn(h + 8, w + 8, generator=g, dtype=torch.float64).cumsum(0).cumsum(1)
    return ((b - b.min()) / (b.max() - b.min()) * 175 + 40).float(), g


def test_awgn_is_the_programs_bit_for_bit():
    from bwd_nlkalman_tpu_torch.ops.noise import awgn

    x = np.random.default_rng(0).uniform(0, 255, (13, 17, 1)).astype(np.float32)
    assert np.array_equal(rnoise.awgn(x, SIGMA, 2 ** 31 + 5), awgn(x, SIGMA, 2 ** 31 + 5))


def test_warp_and_occlusion_are_the_programs():
    from bwd_nlkalman_tpu_torch.flow.occlusion import occlusion_mask
    from bwd_nlkalman_tpu_torch.ops.warp import bicubic_warp_plain

    b, g = _scene(24, 30)
    im = torch.stack([b[:24, :30], b[1:25, 2:32]], -1)
    fl = 3 * torch.randn(24, 30, 2, generator=g)
    occ = occlusion_mask(fl, 0.75)
    assert torch.equal(rops.occlusion_mask(fl, 0.75), occ)
    for a, e in zip(rops.bicubic_warp(im, fl, occ), bicubic_warp_plain(im, fl, occ)):
        assert torch.equal(a, e)


@pytest.mark.parametrize("kw", [dict(lambda_=0.25, fscale=1), dict(lambda_=0.2, fscale=0)])
def test_batched_flows_are_the_programs_one_by_one(kw):
    from bwd_nlkalman_tpu_torch.flow.tvl1 import tvl1_flow

    b, g = _scene(40, 52)
    i0 = torch.stack([b[2:34, 3:47] + 3 * torch.randn(32, 44, generator=g) for _ in range(3)])
    i1 = torch.stack([b[1:33, 1:45] + 3 * torch.randn(32, 44, generator=g) for _ in range(3)])
    u = rflow.tvl1_flows(i0, i1, rops.Consts("cpu"), **kw)
    for j in range(3):
        assert torch.equal(u[j], tvl1_flow(i0[j], i1[j], **kw))


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_batched_flows_are_each_pair_alone_bit_for_bit(device):
    """On the card a matrix product's and a sum's rounding depends on how
    many pairs they hold; the reference takes them pair by pair. Texture
    pairs jumping back 7 px, on a size with an odd level (15x9)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(3)
    t = 40 + 175 * torch.rand(3, 79, 127, generator=g)
    i0 = (t[:, 7:, 7:] + 3 * torch.randn(3, 72, 120, generator=g)).to(device)
    i1 = (t[:, :72, :120] + 3 * torch.randn(3, 72, 120, generator=g)).to(device)
    kw = dict(lambda_=0.25, fscale=1)
    c = rops.Consts(device)
    u = rflow.tvl1_flows(i0, i1, c, **kw)
    for j in range(3):
        assert torch.equal(u[j:j + 1], rflow.tvl1_flows(i0[j:j + 1], i1[j:j + 1], c, **kw))


@pytest.mark.parametrize("mode", ["flt1", "flt2", "smo1", "flt1-first"])
def test_nlk_passes_are_the_programs(mode):
    from bwd_nlkalman_tpu_torch.core import nlkalman_filter_frame, nlkalman_smooth_frame
    from bwd_nlkalman_tpu_torch.params import FilterMode, default_params

    b, g = _scene(30, 36)
    clean = b[:30, :36, None]
    cur = clean + SIGMA * torch.randn(clean.shape, generator=g)
    prev = clean + 2 * torch.randn(clean.shape, generator=g)
    basic = clean + 4 * torch.randn(clean.shape, generator=g)
    valid = torch.ones(30, 36, dtype=torch.bool)
    valid[10:14, 12:18] = False
    name = mode.split("-")[0]
    p, rp = default_params(SIGMA, FilterMode(name)), rparams(SIGMA, name)
    if mode == "smo1":
        want = nlkalman_smooth_frame(cur, prev, valid, SIGMA, p)
        got = rnlk.smooth_frame(cur, prev, valid, SIGMA, rp, block_bytes=1 << 22)
    elif mode == "flt1-first":
        want = nlkalman_filter_frame(cur, None, None, None, SIGMA, p)
        got = rnlk.filter_frame(cur, None, None, None, SIGMA, rp, block_bytes=1 << 22)
    else:
        bs = basic if name == "flt2" else None
        want = nlkalman_filter_frame(cur, prev, valid, bs, SIGMA, p)
        got = rnlk.filter_frame(cur, prev, valid, bs, SIGMA, rp, block_bytes=1 << 22)
    # the blocks of sites differ, so the sums' order does
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_step_gaps_are_zero_on_the_programs_plain_run():
    """The reference's step check of a clip the program denoised on the CPU."""
    from bwd_nlkalman_tpu_torch import FlowConfig, NLKalmanDenoiser
    from portbench.reference.sequence import step_gaps

    b, g = _scene(32, 40)
    clip = torch.stack([b[t:t + 32, t:t + 40] for t in range(4)])[..., None]
    noisy = clip + SIGMA * torch.randn(clip.shape, generator=g)
    f1, f2, s1 = NLKalmanDenoiser(SIGMA, 32, 40, FlowConfig(), device="cpu")(noisy)
    flow = dict(fscale=1, lambda_=0.25, tau=0.25, theta=0.3, nscales=100, zfactor=0.5,
                nwarps=5, epsilon=0.01, max_iters=None)
    gaps = step_gaps(noisy, f1, f2, s1, SIGMA, flow, 0.75, [1, 3], [0, 2], 1 << 22, 0.001)
    assert gaps["smo1_last"] == 0.0
    assert max(max(v) for s in ("flt1", "flt2", "smo1") for _, *v in gaps[s]) < 1e-4
    assert [t for t, *_ in gaps["flt1"]] == [0, 1, 3] and [t for t, *_ in gaps["smo1"]] == [0, 2]


def test_trimmed_rms_leaves_out_the_largest_share():
    from portbench.reference.sequence import rms, trimmed_rms

    a = torch.zeros(100, 10)
    b = torch.full((100, 10), 0.5)
    b[0, :3] = 40.0                      # 3 of 1000 pixels swing
    assert trimmed_rms(a, b, 0.003) == pytest.approx(0.5)
    assert trimmed_rms(a, b, 0.002) > 1.0 and trimmed_rms(a, b, 0.0) == pytest.approx(rms(a, b))
    b[5, 5] = float("nan")
    assert math.isnan(trimmed_rms(a, b, 0.01))
