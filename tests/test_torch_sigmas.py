"""The port's ``denoise_sequence`` against JAX's at other noise levels
than the slices' sigma=20: gray clips at sigma=10 and sigma=40 (where the
smoother keeps 105 of the radius-5 window's 121 candidates).

Bar: the repo's parity bar, flt2 and smo1 PSNR within 0.05 dB of the JAX
pipeline on the same noisy clip, with the port at the XLA path's TV-L1
check granularity (``xla_granularity``, as ``tests/test_torch_pipeline.py``
runs it). ``tests/test_torch_rgb.py`` holds RGB at sigma=20 to the same
bar. Each JAX pipeline runs once for the module.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.pipeline import sequence as j_seq
from bwd_nlkalman_tpu_torch.pipeline import sequence as seq
from test_torch_pipeline import xla_granularity  # noqa: F401  (a fixture)
from test_torch_smoothers import psnr, scene

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def jax_run(sigma, c):
    """(clean, noisy, JAX flt1, flt2 and smo1) of one 32x40 clip of 3 frames."""
    clean, noisy = scene(3, 32, 40, c=c, sigma=sigma)
    outs = j_seq.denoise_sequence(jnp.asarray(noisy), sigma)
    return (clean, noisy) + tuple(np.asarray(x) for x in outs)


def hold_denoise_sequence(sigma, c):
    clean, noisy, _, j_flt2, j_smo1 = jax_run(sigma, c)
    _, flt2, smo1 = seq.denoise_sequence(torch.from_numpy(noisy), sigma)
    for name, got, want in (("flt2", flt2, j_flt2), ("smo1", smo1, j_smo1)):
        got = got.numpy()
        gap = psnr(clean, got) - psnr(clean, want)
        print(f"sigma={sigma:g} C={c} {name}: {gap:+.4f} dB, max abs diff "
              f"{np.abs(got - want).max():.3f}")
        assert got.shape == want.shape and np.isfinite(got).all()
        assert abs(gap) <= 0.05, name
    assert psnr(clean, smo1.numpy()) > psnr(clean, noisy) + 3.0


@pytest.mark.parametrize("sigma", [10.0, 40.0])
def test_denoise_sequence_gray_at_sigma(sigma, xla_granularity):  # noqa: F811
    hold_denoise_sequence(sigma, 1)
