"""The port's plain NL-Kalman pass (K1's plain version) against the JAX
``dense_pass_v2`` and frame passes, on the same numpy inputs.

Tolerance: the JAX suite's own bar for its kernel against ``dense_pass_v2``
(tests/test_engine_pallas.py), rtol=1e-3, atol=5e-2 on a 0-255 scale: the
two sum distances and statistics in different orders, and a distance
that rounds differently can change which patches are selected.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.core import nlkalman as j_nlk
from bwd_nlkalman_tpu.core.engine import dense_pass_v2 as j_dense_pass_v2
from bwd_nlkalman_tpu.params import FilterMode, NLKParams, default_params
from bwd_nlkalman_tpu_torch.convert import params_from_jax
from bwd_nlkalman_tpu_torch.core import nlkalman_filter_frame, nlkalman_smooth_frame
from bwd_nlkalman_tpu_torch.core.engine import dense_pass_v2
from bwd_nlkalman_tpu_torch.core.engine_cuda import (MAX_RAD, dense_pass_cuda, plan_refusal,
                                                     site_plan)
from bwd_nlkalman_tpu_torch.tools.k1_bench import busy_ms, kernel_ms

torch.set_num_threads(1)

PRMS = NLKParams(
    patch_sz=8, search_sz_x=6, search_sz_t=3,
    npatches_x=12, npatches_t=8, npatches_tagg=4,
    dista_lambda=1.0, beta_x=3.0, beta_t=2.0,
)
SPRMS = NLKParams(
    patch_sz=8, search_sz_x=6, search_sz_t=3,
    npatches_x=0, npatches_t=8, npatches_tagg=8,
    dista_lambda=1.0, beta_x=0.0, beta_t=4.0,
)
# the six mode cases of tests/test_engine_pallas.py
CASES = [
    ("filter", False, False, PRMS, 1),
    ("filter", True, False, PRMS, 1),
    ("filter", True, True, PRMS, 1),
    ("smooth", True, False, SPRMS, 1),
    ("smooth", False, False, SPRMS, 1),
    ("filter", True, False, PRMS, 3),
]


def _inputs(rng, h=32, w=40, ch=1, sigma=20.0):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    clean = (100 + 60 * np.sin(0.1 * xx) + 50 * np.cos(0.13 * yy))[..., None]
    clean = np.repeat(clean, ch, -1).astype(np.float32)
    cur = clean + sigma * rng.standard_normal(clean.shape).astype(np.float32)
    prev = clean + 2 * rng.standard_normal(clean.shape).astype(np.float32)
    valid = np.ones((h, w), bool)
    valid[10:14, 20:26] = False
    basic = clean + 4 * rng.standard_normal(clean.shape).astype(np.float32)
    return cur, np.where(valid[..., None], prev, 0.0).astype(np.float32), valid, basic


@pytest.mark.parametrize("mode,has_prev,has_basic,prms,ch", CASES)
def test_plain_pass_matches_dense_pass_v2(rng, mode, has_prev, has_basic, prms, ch):
    sigma = 20.0
    cur, prev, valid, basic = _inputs(rng, ch=ch)
    if not has_prev:
        prev, valid = np.zeros_like(cur), np.zeros(valid.shape, bool)
    if not has_basic:
        basic = cur
    want = np.asarray(j_dense_pass_v2(
        jnp.asarray(cur), jnp.asarray(prev), jnp.asarray(valid),
        jnp.asarray(basic), sigma, prms, mode, has_prev, has_basic))
    got = dense_pass_v2(torch.from_numpy(cur), torch.from_numpy(prev),
                        torch.from_numpy(valid), torch.from_numpy(basic),
                        sigma, params_from_jax(prms), mode, has_prev,
                        has_basic).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-2)


def _frames(rng, h=48, w=64):
    cur, prev, valid, basic = _inputs(rng, h, w)
    valid[:, :2] = valid[:2] = False      # a warp's invalid border band
    return cur, np.where(valid[..., None], prev, 0.0).astype(np.float32), valid, basic


@pytest.mark.parametrize("with_prev,with_basic,mode",
                         [(False, False, FilterMode.FLT1),
                          (True, False, FilterMode.FLT1),
                          (True, True, FilterMode.FLT2)])
def test_filter_frame_default_params(rng, with_prev, with_basic, mode):
    sigma = 20.0
    prms = default_params(sigma, mode)
    cur, prev, valid, basic = _frames(rng)
    args = [cur, prev if with_prev else None, valid if with_prev else None,
            basic if with_basic else None]
    want = np.asarray(j_nlk.nlkalman_filter_frame(
        *[None if a is None else jnp.asarray(a) for a in args], sigma, prms,
        engine="v2"))
    got = nlkalman_filter_frame(
        *[None if a is None else torch.from_numpy(a) for a in args], sigma,
        params_from_jax(prms))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=5e-2)


@pytest.mark.parametrize("with_prev", [True, False])
def test_smooth_frame_default_params(rng, with_prev):
    sigma = 20.0
    prms = default_params(sigma, FilterMode.SMO1)
    cur, prev, valid, _ = _frames(rng)
    args = [cur, prev if with_prev else None, valid if with_prev else None]
    want = np.asarray(j_nlk.nlkalman_smooth_frame(
        *[None if a is None else jnp.asarray(a) for a in args], sigma, prms,
        engine="v2"))
    got = nlkalman_smooth_frame(
        *[None if a is None else torch.from_numpy(a) for a in args], sigma,
        params_from_jax(prms))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=5e-2)


@pytest.mark.parametrize("c", [1, 2, 3])
def test_k1_launch_plan_fits(c):
    """K1's site block fits the H100's 227 KB of shared memory a block may
    use, for every radius it takes, and holds what its layout needs: two
    stage buffers of two window rows (stride F + 1 floats) or three
    256-bin histograms per warp, which then hold its member list (2 bytes
    an offset), and each warp's vector, bits and flags."""
    f = 64 * c
    for rad in range(1, MAX_RAD + 1):
        sites, smem = site_plan(c, rad)
        n_off = (2 * rad + 1) ** 2
        strip = 4 * (4 * (sites - 1) + 2 * rad + 1) * (f + 1) * 4
        assert 1 <= sites <= 8
        assert smem <= 232_448
        assert 2 * n_off <= 3 * 256 * 4
        assert smem >= max(strip, sites * 3 * 256 * 4) + sites * (4 * f + 5 * n_off)
        assert smem % 16 == 0


@pytest.mark.parametrize("kw,plans", [
    # refused until K1 took every even patch size and 1-7 channels
    (dict(c=4, rad=10), True),
    (dict(c=1, rad=10, psz=6), True),
    (dict(c=1, rad=10, psz=16), True),
    (dict(c=7, rad=5, psz=2), True),
    # a site of 3 channels at psz 16 and radius 15 fits in bf16 bands only
    (dict(c=3, rad=15, psz=16, window_dtype="bfloat16"), True),
    (dict(c=3, rad=15, psz=16), False),
    (dict(c=7, rad=10, psz=16), False),
    # outside what K1 is built for
    (dict(c=1, rad=16), False),
    (dict(c=3, rad=16), False),
    (dict(c=0, rad=10), False),
    (dict(c=8, rad=10), False),
    (dict(c=1, rad=10, psz=7), False),
    (dict(c=1, rad=10, psz=18), False),
    (dict(c=1, rad=10, psz=0), False),
])
def test_k1_launch_plan_refuses(kw, plans):
    """What K1's launch plan takes: a plan fits 227 KB with 1 to 8 sites;
    anything else raises, with the reason plan_refusal gives."""
    why = plan_refusal(**kw)
    assert (why is None) is plans
    if plans:
        sites, smem = site_plan(**kw)
        assert 1 <= sites <= 8 and smem <= 232_448 and smem % 16 == 0
    else:
        with pytest.raises(ValueError, match="K1 does not take"):
            site_plan(**kw)


def test_k1_wrapper_takes_cuda_tensors_only(rng):
    """On CPU tensors the wrapper raises before it plans or launches
    anything; dense_pass runs the plain version there instead."""
    cur, prev, valid, basic = (torch.from_numpy(a) for a in _inputs(rng))
    prms = params_from_jax(PRMS)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dense_pass_cuda(cur, prev, valid, basic, 20.0, prms, "filter", True, False)


def test_k1_bench_profile_helpers():
    """The profiler helpers chip_smoke.py reads its per-stage times, busy
    time and top kernels with: names without namespaces or arguments, and
    busy time as the union of overlapping device intervals (in us)."""
    ev = [("void (anonymous namespace)::site_kernel<2>((anonymous namespace)::SiteArgs)",
           0.0, 1000.0),
          ("void (anonymous namespace)::site_kernel<2>((anonymous namespace)::SiteArgs)",
           500.0, 2000.0),
          ("Memset (Device)", 3000.0, 3500.0),
          ("void bnlk_nlk::(anonymous namespace)::fold_kernel<8, 3>(const float *)",
           4000.0, 4250.0)]
    assert kernel_ms(ev) == {"site_kernel<2>": 2.5, "Memset": 0.5, "fold_kernel<8, 3>": 0.25}
    assert busy_ms(ev) == 2.75
    assert busy_ms([]) == 0.0
