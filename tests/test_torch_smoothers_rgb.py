"""The port's ``fsmo_sequence`` against JAX's on an RGB clip: all three
priors of a step ride one 9-channel warp. Bars as
``tests/test_torch_smoothers.py`` holds fsmo on gray frames: every
output within 0.05 dB at TV-L1 granularity 10, 0.1 dB as shipped. The
JAX pipeline runs once for the module.
"""

import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.pipeline import sequence as j_seq
from bwd_nlkalman_tpu_torch.pipeline import sequence as seq
from test_torch_smoothers import BARS, SIGMA, granularity, hold, scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rgb():
    clean, noisy = scene(3, 32, 40, c=3)
    return clean, noisy, j_seq.fsmo_sequence(jnp.asarray(noisy), SIGMA)


@pytest.mark.parametrize("gran", list(BARS))
def test_fsmo_sequence_rgb_matches_jax(rgb, monkeypatch, gran):
    clean, noisy, want = rgb
    granularity(monkeypatch, gran)
    hold(f"fsmo RGB {gran}", clean, seq.fsmo_sequence(torch.from_numpy(noisy), SIGMA),
         want, BARS[gran])
