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
from bwd_nlkalman_tpu_torch.core import nlkalman_filter_frame, nlkalman_smooth_frame
from bwd_nlkalman_tpu_torch.core.engine import dense_pass_v2
from bwd_nlkalman_tpu_torch.params import FilterMode, NLKParams, default_params

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
                        sigma, prms, mode, has_prev, has_basic).numpy()
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
        *[None if a is None else torch.from_numpy(a) for a in args], sigma, prms)
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
        *[None if a is None else torch.from_numpy(a) for a in args], sigma, prms)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=5e-2)
