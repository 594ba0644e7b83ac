"""The port's pipelines against JAX's on RGB clips at sigma=20: the
whole ``denoise_sequence`` and the lag-1 smoother ``lsmo_sequence``.

Bars: ``denoise_sequence`` as ``tests/test_torch_sigmas.py`` holds it
(flt2 and smo1 within 0.05 dB at TV-L1 granularity 10); lsmo as
``tests/test_torch_smoothers.py`` holds it on gray frames (every
output within 0.05 dB at granularity 10, 0.1 dB as shipped). JAX's lsmo
smooths the filtered stacks of its ``denoise_sequence`` run, which runs
once for the module.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.pipeline import sequence as j_seq
from bwd_nlkalman_tpu_torch.pipeline import sequence as seq
from test_torch_pipeline import xla_granularity  # noqa: F401  (a fixture)
from test_torch_sigmas import hold_denoise_sequence, jax_run
from test_torch_smoothers import BARS, granularity, hold

torch.set_num_threads(1)
SIGMA = 20.0


def test_denoise_sequence_rgb(xla_granularity):  # noqa: F811
    hold_denoise_sequence(SIGMA, 3)


@pytest.fixture(scope="module")
def jax_lsmo():
    """lsmo of JAX on the filtered stacks of the denoise_sequence run."""
    clean, noisy, flt1, flt2, _ = jax_run(SIGMA, 3)
    return clean, noisy, (flt1, flt2, j_seq.lsmo_sequence(jnp.asarray(flt2), SIGMA))


@pytest.mark.parametrize("gran", list(BARS))
def test_lsmo_sequence_rgb_matches_jax(jax_lsmo, monkeypatch, gran):
    clean, noisy, want = jax_lsmo
    granularity(monkeypatch, gran)
    flt1, flt2 = seq.filter_sequence(torch.from_numpy(noisy), SIGMA)
    hold(f"lsmo RGB {gran}", clean, (flt1, flt2, seq.lsmo_sequence(flt2, SIGMA)),
         tuple(np.asarray(x) for x in want), BARS[gran])
