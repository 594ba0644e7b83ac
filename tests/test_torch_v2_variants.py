"""The v2-only NLK variants in the port's plain pass against the JAX
``dense_pass_v2``: LAMBDA_DISTANCE (``dista_lambda != 1``, JAX
core/engine.py:267-279) and threshold selection (``dista_th > 0``, with
the noise correction and no group-size caps, :284-314 and the
finalisation's ``nagg_f``). JAX runs them on its XLA engine only, never
in its Pallas kernel, and so does the port: K1 does not take them, and
the frame passes route them to the plain pass.

Tolerance: K1's bar, rtol 1e-3 and atol 5e-2 (reduction orders can flip a
selection tie; see tests/test_torch_nlk.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.core.engine import dense_pass_v2 as j_dense_pass_v2
from bwd_nlkalman_tpu.params import FilterMode, default_params
from bwd_nlkalman_tpu_torch.convert import params_from_jax
from bwd_nlkalman_tpu_torch.core import nlkalman as nlk
from bwd_nlkalman_tpu_torch.core.engine import dense_pass_v2
from test_torch_nlk import _inputs

torch.set_num_threads(1)

SIGMA = 20.0


@pytest.mark.parametrize("change,mode,fm,has_prev,has_basic", [
    (dict(dista_lambda=0.5), "filter", FilterMode.FLT1, True, False),
    (dict(dista_th=2.0), "filter", FilterMode.FLT2, True, True),
    (dict(dista_th=3.0), "smooth", FilterMode.SMO1, True, False),
])
def test_v2_variant_matches_jax(change, mode, fm, has_prev, has_basic):
    prms = dataclasses.replace(default_params(SIGMA, fm), **change)
    cur, prev, valid, basic = _inputs(np.random.default_rng(3), 24, 40, 1)
    if not has_prev:
        prev, valid = np.zeros_like(cur), np.zeros(valid.shape, bool)
    if not has_basic:
        basic = cur
    want = np.asarray(j_dense_pass_v2(
        jnp.asarray(cur), jnp.asarray(prev), jnp.asarray(valid), jnp.asarray(basic),
        SIGMA, prms, mode, has_prev, has_basic))
    p = params_from_jax(prms)
    got = dense_pass_v2(torch.from_numpy(cur), torch.from_numpy(prev),
                        torch.from_numpy(valid), torch.from_numpy(basic), SIGMA, p,
                        mode, has_prev, has_basic).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-2)
    # the variant changes the pass, and K1 does not take it
    base = dense_pass_v2(torch.from_numpy(cur), torch.from_numpy(prev),
                         torch.from_numpy(valid), torch.from_numpy(basic), SIGMA,
                         params_from_jax(default_params(SIGMA, fm)), mode,
                         has_prev, has_basic).numpy()
    assert np.abs(got - base).max() > 1e-2
    assert not nlk.k1_supported(24, 40, 1, p, mode)
