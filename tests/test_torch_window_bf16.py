"""The bf16 window path: the port's plain pass with
``window_dtype="bfloat16"`` against the TPU kernel's own bf16 pass, and
the whole slice in bf16 against float32 on the port alone.

The reference is JAX's ``dense_pass_pallas(..., window_dtype="bfloat16",
interpret=True)``: the Pallas kernel holds the x-, d- and n-bands in
bfloat16 and computes everything else in float32, as K1 and its plain
version do. JAX's XLA ``dense_pass_v2`` is another function in bf16 (it
rounds only the x and d windows and subtracts them in bf16): at these
inputs it differs from the Pallas pass by 0.22-0.53 (max abs, 0-255
scale), so it is not the reference here.

Tolerance against the Pallas pass: K1's bar, rtol 1e-3 and atol 5e-2,
a hundred times tighter than v2's gap. The bands can differ by a bf16
rounding where the two DCTs (a matrix product there, a separable sum
here) land on either side of a rounding boundary, and a selection tie can
then flip; at these inputs the passes agree to 1.7e-4.

The slice check holds the port's bf16 pipeline to the JAX package's own
bf16 gate (``tests/test_bf16_gate.py``): flt2 and smo1 PSNR within
0.05 dB of float32, at 48x64, T=3.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.core.engine_pallas import dense_pass_pallas
from bwd_nlkalman_tpu.params import FilterMode, default_params
from bwd_nlkalman_tpu_torch.convert import params_from_jax
from bwd_nlkalman_tpu_torch.core.engine import dense_pass_v2, round_band
from bwd_nlkalman_tpu_torch.pipeline import NLKalmanDenoiser
from test_torch_nlk import _inputs
from test_torch_smoothers import scene

torch.set_num_threads(1)

SIGMA = 20.0
# (psz, mode, trained defaults, has_prev, has_basic): two interpret-mode
# Pallas calls, 10-40 s each on the CPU
CASES = [
    (8, "filter", FilterMode.FLT1, True, False),
    (4, "smooth", FilterMode.SMO1, True, False),
]


@pytest.mark.parametrize("psz,mode,fm,has_prev,has_basic", CASES)
def test_bf16_plain_pass_matches_pallas(psz, mode, fm, has_prev, has_basic):
    prms = dataclasses.replace(default_params(SIGMA, fm), patch_sz=psz)
    cur, prev, valid, basic = _inputs(np.random.default_rng(psz), 24, 40, 1)
    if not has_basic:
        basic = cur
    want = np.asarray(dense_pass_pallas(
        jnp.asarray(cur), jnp.asarray(prev), jnp.asarray(valid), jnp.asarray(basic),
        SIGMA, prms, mode, has_prev, has_basic, window_dtype="bfloat16",
        interpret=True))
    args = (torch.from_numpy(cur), torch.from_numpy(prev), torch.from_numpy(valid),
            torch.from_numpy(basic), SIGMA, params_from_jax(prms), mode, has_prev,
            has_basic)
    got = dense_pass_v2(*args, window_dtype="bfloat16").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-2)
    # the bands are rounded: the pass is not the float32 one
    assert np.abs(got - dense_pass_v2(*args).numpy()).max() > 1e-2


def test_round_band():
    """float32 -> bfloat16 -> float32, round to nearest even; float32 as is."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 1.0 + 2.0 ** -9, -300.7])
    got = round_band(x, "bfloat16")
    assert got.dtype == torch.float32
    assert got.tolist() == [1.0, 1.0, 1.0 + 2.0 ** -6, 1.0, -300.0]
    assert round_band(x, "float32") is x
    with pytest.raises(ValueError, match="window_dtype"):
        round_band(x, "float16")


def test_bf16_slice_psnr_within_gate():
    clean, noisy = scene(3, 48, 64, seed=0)
    x = torch.from_numpy(noisy)
    out = {wdt: NLKalmanDenoiser(SIGMA, 48, 64, device="cpu", window_dtype=wdt)(x)
           for wdt in ("float32", "bfloat16")}

    def psnr(a):
        d = a.double().numpy() - clean
        return 10 * np.log10(255.0 ** 2 / np.mean(d * d))

    for i, name in ((1, "flt2"), (2, "smo1")):
        p32, p16 = psnr(out["float32"][i]), psnr(out["bfloat16"][i])
        assert abs(p16 - p32) <= 0.05, (name, p32, p16)
        assert p16 > psnr(torch.from_numpy(noisy)) + 6.0
    assert not torch.equal(out["float32"][2], out["bfloat16"][2])
