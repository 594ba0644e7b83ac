"""The port's io, noise and ground-truth harness, its CLI helpers, and the
plain version of the streaming-rate probe P.

- Codecs: the port writes the very bytes the JAX package's pure-Python
  codecs write (``BNLK_NO_NATIVE`` keeps the JAX side off its optional
  native library), and each reads what the other wrote.
- Noise: the port's reference-exact AWGN is bit-identical to JAX
  ``ops.noise.awgn``.
- P: the plain chain at K=8 against a float64 numpy chain; float32
  variants to rtol 1e-5 (eight roundings of a contracting chain),
  bfloat16 to rtol 5e-2 (8 bits of mantissa).
"""

import argparse

import numpy as np
import pytest
import torch

from bwd_nlkalman_tpu import io as j_io
from bwd_nlkalman_tpu.cli import _common as j_common
from bwd_nlkalman_tpu.ops.noise import awgn as j_awgn
from bwd_nlkalman_tpu.pipeline import gt as j_gt
from bwd_nlkalman_tpu_torch import io
from bwd_nlkalman_tpu_torch.cli import _common
from bwd_nlkalman_tpu_torch.convert import params_from_jax
from bwd_nlkalman_tpu_torch.ops.noise import awgn
from bwd_nlkalman_tpu_torch.pipeline import gt
from bwd_nlkalman_tpu_torch.tools import vpu_probe

torch.set_num_threads(1)


def _image(rng, h, w, c, hi=255.0):
    return rng.uniform(0, hi, (h, w, c)).astype(np.float32)


@pytest.mark.parametrize("name,c,hi", [
    ("a.png", 1, 255.0), ("a.png", 3, 255.0), ("a.png", 1, 4000.0),
    ("a.tif", 3, 255.0), ("a.pfm", 1, 255.0), ("a.pfm", 3, 255.0),
    ("a.flo", 2, 20.0),
])
def test_codecs_write_the_jax_bytes(rng, tmp_path, monkeypatch, name, c, hi):
    monkeypatch.setenv("BNLK_NO_NATIVE", "1")
    img = _image(rng, 13, 17, c, hi)
    if name.endswith(".flo"):
        img -= 10.0
    p, j = str(tmp_path / ("p-" + name)), str(tmp_path / ("j-" + name))
    io.write_image(p, img)
    j_io.write_image(j, img)
    assert open(p, "rb").read() == open(j, "rb").read()
    got = io.read_image(j)
    np.testing.assert_array_equal(got, j_io.read_image(p))
    assert got.shape == img.shape
    if name.endswith(".png"):
        np.testing.assert_array_equal(got, np.clip(np.rint(img), 0, 65535))
    else:
        np.testing.assert_array_equal(got, img)


def test_video_round_trip(rng, tmp_path, monkeypatch):
    monkeypatch.setenv("BNLK_NO_NATIVE", "1")
    video = np.stack([_image(rng, 9, 11, 1) for _ in range(3)])
    pat = str(tmp_path / "f-%03d.tif")
    io.write_video(pat, video, first=4)
    np.testing.assert_array_equal(j_io.read_video(pat, 4, 6), video)
    seq = io.FrameSequence(pat, 4, 6)
    assert [seq.path(i) for i in seq.indices()] == [pat % i for i in (4, 5, 6)]
    np.testing.assert_array_equal(seq.read(), video)


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_awgn_bit_identical(rng, seed):
    img = _image(rng, 20, 24, 3)
    np.testing.assert_array_equal(awgn(img, 20.0, seed), j_awgn(img, 20.0, seed))


def test_gt_harness_matches_jax(rng):
    clean = np.stack([_image(rng, 16, 20, 1) for _ in range(3)])
    seeds = [5, 6, 7]
    noisy = gt.add_noise_sequence(clean, 15.0, seeds)
    np.testing.assert_array_equal(noisy, j_gt.add_noise_sequence(clean, 15.0, seeds))
    assert gt.sequence_psnr(clean, noisy, 1, 2) == j_gt.sequence_psnr(clean, noisy, 1, 2)
    stacks = {"flt1": noisy, "smo1": None}
    assert gt.gt_measures(clean, stacks) == j_gt.gt_measures(clean, stacks)


def test_cli_helpers_match_jax(capsys):
    """The reference-named parameter flags parse to the same NLKParams, and
    a frame-size mismatch exits 1 with the same message."""
    argv = ["--f1_p", "8", "--f1_nt", "12", "--f1_bx", "2.5", "--f1_l", "1"]
    parsed = []
    for common in (j_common, _common):
        ap = argparse.ArgumentParser()
        common.add_prms_group(ap, "f1", "filter 1")
        parsed.append(common.prms_from_args(ap.parse_args(argv), "f1"))
    assert params_from_jax(parsed[0]) == parsed[1]
    errors = []
    for common in (j_common, _common):
        with pytest.raises(SystemExit) as e:
            common.check_size("flow", np.zeros((4, 5, 2)), np.zeros((4, 6, 1)))
        assert e.value.code == 1
        errors.append(capsys.readouterr().err)
    assert errors[0] == errors[1] and "size mismatch" in errors[1]
    _common.check_size("mask", np.zeros((4, 6, 3)), np.zeros((4, 6, 1)), channels="any")


def _numpy_chain(a, nchains, op, k):
    x = a.astype(np.float64)
    y = x * 0.5 + 0.25
    accs = [x + c for c in range(nchains)]
    for _ in range(k):
        accs = [acc * x + y if op == "fma" else acc * x for acc in accs]
    return sum(accs)


@pytest.mark.parametrize("variant", list(vpu_probe.VARIANTS))
def test_probe_plain_matches_numpy_chain(variant):
    nchains, op, dtype = vpu_probe.VARIANTS[variant]
    a = vpu_probe.probe_input(8, 64, "cpu")
    got = vpu_probe.probe(a, nchains, op, dtype, k=8, grid=2)
    assert got.dtype == torch.float32 and got.shape == a.shape
    x = a.to(dtype).to(torch.float64).numpy()
    want = _numpy_chain(x, nchains, op, 8)
    rtol = 1e-5 if dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol)
