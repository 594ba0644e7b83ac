"""The Lanczos-3 pyramid and the lz3 multiscale pipeline
(msnlkalman-lz3-seq) of the port against the JAX package.

- ``lanczos3_down`` / ``lanczos3_up`` / ``lanczos3_decompose`` /
  ``lanczos3_recompose``: the same taps, index arithmetic and order of
  operations in float32 as JAX's, so to 1e-5 of the largest value
  (agreement is exact on the CPU); the recompose blur is the shared
  Gaussian's matrix product, held as ``tests/test_torch_ops.py`` holds it.
- ``ms_denoise_sequence(pyramid="lz3")`` at 64x80, 2 levels, 3 gray
  frames: every output's PSNR within 0.05 dB of JAX's at TV-L1
  granularity 10; the ``msnlkalman-lz3-seq`` command's measures within
  0.1 dB of the JAX command's (one JAX pipeline for the module).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.cli import msnlkalman_lz3_seq as j_msnlkalman_lz3_seq
from bwd_nlkalman_tpu.ops import pyramid as j_pyr
from bwd_nlkalman_tpu.pipeline import multiscale as j_ms
from bwd_nlkalman_tpu_torch.cli import msnlkalman_lz3_seq
from bwd_nlkalman_tpu_torch.ops import pyramid
from bwd_nlkalman_tpu_torch.pipeline import multiscale as ms
from test_torch_pipeline import xla_granularity  # noqa: F401  (a fixture)
from test_torch_smoothers import SIGMA, _cli_pair, hold, scene

torch.set_num_threads(1)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(37, 53, 1), (37, 53, 3), (48, 64, 1), (48, 64, 3),
                                   (24, 30)])
def test_lanczos3_pyramid_matches_jax(shape):
    img = np.random.default_rng(2).uniform(0, 255, shape).astype(np.float32)
    x, xj = torch.from_numpy(img), jnp.asarray(img)
    _close(pyramid.lanczos3_down(x), j_pyr.lanczos3_down(xj))
    small = np.ascontiguousarray(img[::2, ::2])
    _close(pyramid.lanczos3_up(torch.from_numpy(small), *shape[:2]),
           j_pyr.lanczos3_up(jnp.asarray(small), *shape[:2]))
    got, want = pyramid.lanczos3_decompose(x, 2), j_pyr.lanczos3_decompose(xj, 2)
    assert [tuple(g.shape[:2]) for g in got] == pyramid.lanczos3_sizes(*shape[:2], 2)
    for g, w in zip(got, want):
        _close(g, w)
    got = [g + float(i) for i, g in enumerate(got)]
    want = [w + float(i) for i, w in enumerate(want)]
    for rec in (0.0, 0.7):
        _close(pyramid.lanczos3_recompose(got, rec), j_pyr.lanczos3_recompose(want, rec))


@pytest.fixture(scope="module")
def lz3_run():
    clean, noisy = scene(3, 64, 80)
    return clean, noisy, j_ms.ms_denoise_sequence(jnp.asarray(noisy), SIGMA, levels=2,
                                                  pyramid="lz3")


def test_ms_denoise_sequence_lz3_matches_jax(lz3_run, xla_granularity):  # noqa: F811
    clean, noisy, want = lz3_run
    got = ms.ms_denoise_sequence(torch.from_numpy(noisy), SIGMA, levels=2, pyramid="lz3")
    hold("multiscale lz3", clean, got, want, 0.05)


def test_msnlkalman_lz3_seq_cli_matches_jax_cli(lz3_run, tmp_path, monkeypatch):
    got, want = _cli_pair(tmp_path, monkeypatch, lz3_run[0], ["--levels", "2"],
                          (msnlkalman_lz3_seq.main, j_msnlkalman_lz3_seq.main))
    assert set(got) == set(want) == {"flt1", "flt2", "smo1"}
    for stage in got:
        print(f"msnlkalman-lz3-seq {stage}: {got[stage] - want[stage]:+.4f} dB")
        assert abs(got[stage] - want[stage]) <= 0.1, stage
