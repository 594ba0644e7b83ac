"""The port's plain NL-Kalman pass (K1's plain version) at the patch sizes
and channel counts K1 now takes beyond psz 8 and 1-3 channels, against
the JAX ``dense_pass_v2`` on the same numpy inputs.

Cases cover psz 2, 4, 6 and 12 (sites every psz/2) with 1, 3 and 4
channels, each kind of pass: a filter pass on a first frame, with a
previous frame, with a previous frame and a basic estimate, and the
smoother. Tolerance: K1's bar, the JAX suite's own for its kernel against
``dense_pass_v2`` (tests/test_engine_pallas.py), rtol 1e-3 and atol 5e-2
on a 0-255 scale: the two sum distances and statistics in different
orders, and a distance that rounds differently can flip which patches a
selection tie keeps.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.core.engine import dense_pass_v2 as j_dense_pass_v2
from bwd_nlkalman_tpu.params import FilterMode, default_params
from bwd_nlkalman_tpu_torch.convert import params_from_jax
from bwd_nlkalman_tpu_torch.core.engine import dense_pass_v2
from test_torch_nlk import _inputs

torch.set_num_threads(1)

SIGMA = 20.0
H, W = 24, 40
KINDS = {
    "filter first frame": ("filter", FilterMode.FLT1, False, False),
    "filter": ("filter", FilterMode.FLT1, True, False),
    "filter basic": ("filter", FilterMode.FLT2, True, True),
    "smooth": ("smooth", FilterMode.SMO1, True, False),
}
CASES = [
    (2, 1, "filter first frame"),
    (2, 3, "smooth"),
    (4, 1, "filter"),
    (4, 4, "filter basic"),
    (4, 3, "filter first frame"),
    (6, 3, "filter basic"),
    (6, 4, "smooth"),
    (6, 1, "filter"),
    # one case at psz 12: JAX's XLA pass compiles for 20-70 s there
    (12, 1, "filter"),
]


@pytest.mark.parametrize("psz,ch,kind", CASES)
def test_plain_pass_sizes_match_dense_pass_v2(psz, ch, kind):
    mode, fm, has_prev, has_basic = KINDS[kind]
    prms = dataclasses.replace(default_params(SIGMA, fm), patch_sz=psz)
    cur, prev, valid, basic = _inputs(np.random.default_rng(psz * 10 + ch), H, W, ch)
    if not has_prev:
        prev, valid = np.zeros_like(cur), np.zeros(valid.shape, bool)
    if not has_basic:
        basic = cur
    want = np.asarray(j_dense_pass_v2(
        jnp.asarray(cur), jnp.asarray(prev), jnp.asarray(valid), jnp.asarray(basic),
        SIGMA, prms, mode, has_prev, has_basic))
    got = dense_pass_v2(torch.from_numpy(cur), torch.from_numpy(prev),
                        torch.from_numpy(valid), torch.from_numpy(basic), SIGMA,
                        params_from_jax(prms), mode, has_prev, has_basic).numpy()
    assert got.shape == (H, W, ch)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-2)
