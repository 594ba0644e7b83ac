"""The port's drivers on clips of 4-7 channels (RGBA PNGs, multispectral
TIFFs), whose stacked priors K4 warps at 8-14 channels.

- ``filter_sequence`` + ``smooth_sequence`` on a 5-channel clip (T=3,
  32x40, sigma 20; the filter's warp has 10 channels) and ``fsmo_sequence``
  on a 4-channel clip (12), each against JAX's on the same numpy-seeded
  clip: every output's PSNR within 0.05 dB at TV-L1 granularity 10, as
  ``tests/test_torch_smoothers.py`` holds the gray and RGB clips. JAX's
  run of each takes minutes on the CPU (compiles), so these are ``slow``.
- On every run: the port alone on the same clips (finite, the stacks'
  shapes, denoised), and ``nlkalman-seq --smoother fsmo`` on RGBA PNGs,
  each a second or two.
"""

import os

import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.pipeline import sequence as j_seq
from bwd_nlkalman_tpu_torch.cli import nlkalman_seq
from bwd_nlkalman_tpu_torch.io import read_image, write_png
from bwd_nlkalman_tpu_torch.pipeline import sequence as seq
from test_torch_smoothers import BARS, SIGMA, granularity, hold, psnr, scene

torch.set_num_threads(1)
T, H, W = 3, 32, 40


def _filter_smooth(noisy):
    flt1, flt2 = seq.filter_sequence(noisy, SIGMA)
    return flt1, flt2, seq.smooth_sequence(flt2, SIGMA)


@pytest.fixture(scope="module")
def five():
    clean, noisy = scene(T, H, W, c=5)
    flt1, flt2 = j_seq.filter_sequence(jnp.asarray(noisy), SIGMA)
    return clean, noisy, (flt1, flt2, j_seq.smooth_sequence(flt2, SIGMA))


@pytest.fixture(scope="module")
def four():
    clean, noisy = scene(T, H, W, c=4)
    return clean, noisy, j_seq.fsmo_sequence(jnp.asarray(noisy), SIGMA)


@pytest.mark.slow
def test_filter_smooth_5_channels_matches_jax(five, monkeypatch):
    clean, noisy, want = five
    granularity(monkeypatch, "granularity 10")
    hold("filter+smooth 5 channels", clean, _filter_smooth(torch.from_numpy(noisy)), want,
         BARS["granularity 10"])


@pytest.mark.slow
def test_fsmo_4_channels_matches_jax(four, monkeypatch):
    clean, noisy, want = four
    granularity(monkeypatch, "granularity 10")
    hold("fsmo 4 channels", clean, seq.fsmo_sequence(torch.from_numpy(noisy), SIGMA), want,
         BARS["granularity 10"])


@pytest.mark.parametrize("c,run", [(5, _filter_smooth), (7, _filter_smooth),
                                   (4, lambda x: seq.fsmo_sequence(x, SIGMA))],
                         ids=["filter-smooth-5", "filter-smooth-7", "fsmo-4"])
def test_port_denoises_4_to_7_channel_clips(c, run):
    clean, noisy = scene(T, H, W, c=c)
    outs = run(torch.from_numpy(noisy))
    for out in outs:
        assert out.shape == (T, H, W, c) and torch.isfinite(out).all()
    assert psnr(clean, outs[2]) > psnr(clean, noisy) + 3.0


def test_nlkalman_seq_fsmo_on_rgba_pngs(tmp_path):
    """RGBA PNGs read as 4 channels; the smoothed frames come out with 4
    channels and the measures file reports each output."""
    clean, _ = scene(T, H, W, c=4)
    pat = str(tmp_path / "c-%03d.png")
    for i in range(T):
        write_png(pat % (i + 1), clean[i])
    assert read_image(pat % 1).shape == (H, W, 4)
    out = tmp_path / "out"
    assert nlkalman_seq.main([pat, "1", str(T), f"{SIGMA:g}", str(out), "--gt-pattern", pat,
                              "--smoother", "fsmo", "--device", "cpu"]) == 0
    assert read_image(str(out / "smo1-003.tif")).shape == (H, W, 4)
    measures = (out / "measures").read_text()
    assert all(f"{k}-total" in measures for k in ("flt1", "flt2", "smo1"))
    assert os.path.exists(out / "flt2-001.tif")
