"""The DCT pyramid and the multiscale pipeline (msnlkalman-seq) of the port
against the JAX package.

- ``dct2_image`` / ``idct2_image``: two full-float32 matrix products
  against JAX's "highest"-precision einsum, in another summation order:
  rtol 1e-5, with an absolute floor of 1e-5 of the largest value (the
  near-zero coefficients carry the rounding of the large ones).
- ``dct_decompose`` / ``dct_recompose`` / ``merge_coarse`` to the same
  bars; ``pyramid_sizes`` and ``auto_pyramid_levels`` exactly, the latter
  on both sides of each of its three thresholds.
- ``ms_denoise_sequence(pyramid="dct")`` at 64x80, 2 levels, 3 gray
  frames: every output's PSNR within 0.05 dB of JAX's at TV-L1
  granularity 10; ``MultiscaleDenoiser`` equals the function; the
  ``--multiscale`` and ``msnlkalman-seq`` commands' measures within
  0.1 dB of the JAX commands' (one JAX pipeline for the module: the
  commands reuse its compiled executables).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.cli import msnlkalman_seq as j_msnlkalman_seq
from bwd_nlkalman_tpu.ops import dct as j_dct
from bwd_nlkalman_tpu.ops import pyramid as j_pyr
from bwd_nlkalman_tpu.pipeline import multiscale as j_ms
from bwd_nlkalman_tpu_torch.cli import msnlkalman_seq
from bwd_nlkalman_tpu_torch.ops import dct, pyramid
from bwd_nlkalman_tpu_torch.pipeline import multiscale as ms
from test_torch_pipeline import xla_granularity  # noqa: F401  (a fixture)
from test_torch_smoothers import SIGMA, _cli_pair, hold, scene

torch.set_num_threads(1)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def _image(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


SHAPES = [(37, 53, 1), (37, 53, 3), (48, 64, 1), (48, 64, 3)]


@pytest.mark.parametrize("shape", SHAPES)
def test_image_dct_matches_jax(shape):
    img = _image(shape)
    coef = dct.dct2_image(torch.from_numpy(img))
    _close(coef, j_dct.dct2_image(jnp.asarray(img)))
    _close(dct.idct2_image(torch.from_numpy(img)), j_dct.idct2_image(jnp.asarray(img)))
    _close(dct.idct2_image(coef), img)


@pytest.mark.parametrize("shape", SHAPES)
def test_dct_pyramid_matches_jax(shape):
    img = _image(shape, 1)
    got = pyramid.dct_decompose(torch.from_numpy(img), 3)
    want = j_pyr.dct_decompose(jnp.asarray(img), 3)
    for g, w in zip(got, want):
        _close(g, w)
    # shifted levels, so that recompose merges something
    got = [x + float(i) for i, x in enumerate(got)]
    want = [x + float(i) for i, x in enumerate(want)]
    _close(pyramid.dct_recompose(got, 0.7), j_pyr.dct_recompose(want, 0.7))
    _close(pyramid.merge_coarse(got[0], got[1], 0.8),
           j_pyr.merge_coarse(want[0], want[1], 0.8))


@pytest.mark.parametrize("h,w", [(45, 63), (64, 80), (1080, 1920), (2160, 3840)])
@pytest.mark.parametrize("levels", [1, 3, 4])
def test_pyramid_sizes_match_jax(h, w, levels):
    assert pyramid.pyramid_sizes(h, w, levels) == j_pyr.pyramid_sizes(h, w, levels)


@pytest.mark.parametrize("n,levels", [(499_999, 1), (500_000, 2), (1_999_999, 2),
                                      (2_000_000, 3), (7_999_999, 3), (8_000_000, 4)])
def test_auto_pyramid_levels_thresholds(n, levels):
    """One row of n pixels on each side of the 500 k, 2 M and 8 M
    thresholds, and 1080p: 3 levels."""
    assert pyramid.auto_pyramid_levels(1, n) == j_pyr.auto_pyramid_levels(1, n) == levels
    assert pyramid.auto_pyramid_levels(1080, 1920) == 3


@pytest.fixture(scope="module")
def dct_run():
    clean, noisy = scene(3, 64, 80)
    return clean, noisy, j_ms.ms_denoise_sequence(jnp.asarray(noisy), SIGMA, levels=2)


def test_ms_denoise_sequence_dct_matches_jax(dct_run, xla_granularity):  # noqa: F811
    clean, noisy, want = dct_run
    got = ms.ms_denoise_sequence(torch.from_numpy(noisy), SIGMA, levels=2)
    hold("multiscale dct", clean, got, want, 0.05)


def test_multiscale_denoiser_is_the_pipeline():
    _, noisy = scene(2, 48, 64)
    x = torch.from_numpy(noisy)
    model = ms.MultiscaleDenoiser(SIGMA, 48, 64, levels=2, device="cpu")
    for got, want in zip(model(x), ms.ms_denoise_sequence(x, SIGMA, levels=2)):
        assert torch.equal(got, want)
    assert model.levels == 2 and ms.MultiscaleDenoiser(SIGMA, 48, 64, device="cpu").levels == 1


@pytest.mark.parametrize("command", ["nlkalman-seq --multiscale", "msnlkalman-seq"])
def test_multiscale_cli_matches_jax_cli(dct_run, tmp_path, monkeypatch, command):
    flags = ["--levels", "2"]
    if command == "msnlkalman-seq":
        run = (msnlkalman_seq.main, j_msnlkalman_seq.main)
    else:
        run, flags = None, flags + ["--multiscale"]
    got, want = _cli_pair(tmp_path, monkeypatch, dct_run[0], flags, run)
    assert set(got) == set(want) == {"flt1", "flt2", "smo1"}
    for stage in got:
        print(f"{command} {stage}: {got[stage] - want[stage]:+.4f} dB")
        assert abs(got[stage] - want[stage]) <= 0.1, stage
