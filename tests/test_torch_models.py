"""The port's model registry, batch driver, default device and K1's
routing rule, on the CPU.

- ``get_model`` for each of the six names equals the direct pipeline
  call (the same arithmetic: the registry builds the variant's module);
  an unknown name raises ``KeyError``.
- ``denoise_batch`` equals ``denoise_sequence`` clip by clip.
- Every entry point of this slice, built without a device, asks for the
  card, and raises where there is none.
- The parameters the entry points refused before K1 took every even
  patch size and 1-7 channels: those K1 takes now route to it, the rest
  route to the plain pass with a warning that names the reason
  (``core.nlkalman.k1_refusal``, warned at an entry point's first frame
  and counted where a CUDA pass takes the plain route).
"""

import dataclasses

import numpy as np
import pytest
import torch

from bwd_nlkalman_tpu_torch import models
from bwd_nlkalman_tpu_torch.core import nlkalman as nlk
from bwd_nlkalman_tpu_torch.core.engine_cuda import MAX_RAD
from bwd_nlkalman_tpu_torch.params import FilterMode, default_params
from bwd_nlkalman_tpu_torch.pipeline import multiscale as ms
from bwd_nlkalman_tpu_torch.pipeline import sequence as seq
from bwd_nlkalman_tpu_torch.pipeline.stream import StreamingDenoiser
from test_torch_smoothers import SIGMA, scene

torch.set_num_threads(1)

DIRECT = {
    "nlk-seq": lambda x: seq.denoise_sequence(x, SIGMA)[2],
    "nlk-flt": lambda x: seq.filter_sequence(x, SIGMA)[1],
    "nlk-fsmo": lambda x: seq.fsmo_sequence(x, SIGMA)[2],
    "nlk-lsmo": lambda x: seq.lsmo_sequence(seq.filter_sequence(x, SIGMA)[1], SIGMA),
    "msnlk": lambda x: ms.ms_denoise_sequence(x, SIGMA)[2],
    "msnlk-lz3": lambda x: ms.ms_denoise_sequence(x, SIGMA, pyramid="lz3")[2],
}


@pytest.mark.parametrize("name", sorted(models.MODELS))
def test_get_model_is_the_pipeline(name):
    assert set(DIRECT) == set(models.MODELS)
    clean, noisy = scene(3, 24, 32)
    x = torch.from_numpy(noisy)
    run = models.get_model(name, SIGMA, device="cpu")
    out = run(x)
    assert run.__name__ == f"{name}_sigma20"
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert torch.equal(out, DIRECT[name](x))
    assert torch.equal(run(x), out)      # the module built at the first call


def test_unknown_model_raises():
    with pytest.raises(KeyError, match="unknown model"):
        models.get_model("nope", SIGMA, device="cpu")


def test_denoise_batch_is_per_clip():
    _, a = scene(2, 24, 32, seed=4)
    _, b = scene(2, 24, 32, seed=5)
    batch = torch.from_numpy(np.stack([a, b]))
    got = seq.denoise_batch(batch, SIGMA)
    for i in range(2):
        for g, w in zip(got, seq.denoise_sequence(batch[i], SIGMA)):
            assert torch.equal(g[i], w)
    assert all(g.shape == batch.shape for g in got)


ENTRY_POINTS = {
    "StreamingDenoiser": lambda: StreamingDenoiser(SIGMA),
    "MultiscaleDenoiser": lambda: ms.MultiscaleDenoiser(SIGMA, 16, 16),
    "get_model": lambda: models.get_model("msnlk", SIGMA),
    "NLKalmanDenoiser fsmo": lambda: seq.NLKalmanDenoiser(SIGMA, 16, 16, smoother="fsmo"),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_new_entry_points_run_on_the_card_by_default(name):
    if torch.cuda.is_available():
        ENTRY_POINTS[name]()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ENTRY_POINTS[name]()


@pytest.mark.parametrize("change,channels,reason", [
    # refused until K1 took every even patch size and 1-7 channels
    (dict(patch_sz=6), 1, None),
    ({}, 4, None),
    # still not K1's: the plain pass runs them, warned by name
    (dict(search_sz_x=MAX_RAD + 1), 1, f"search radius {MAX_RAD + 1}, K1 takes 0..{MAX_RAD}"),
    (dict(patch_sz=7), 1, "patch_sz 7 is odd"),
    ({}, 8, "8 channels, K1 takes 1..7"),
])
def test_k1_limits_raise_early(monkeypatch, change, channels, reason):
    """What an entry point that runs the kernels decides at its first frame,
    before any launch, for each pass (a filter pass's radius is the larger
    of its two): nothing raises; a pass K1 does not take gets the warning
    that names the reason, once, and goes to the plain pass."""
    monkeypatch.setattr(nlk, "_WARNED", set())
    p = dataclasses.replace(default_params(SIGMA, FilterMode.FLT1), **change)
    assert nlk.k1_refusal(48, 64, channels, p, "filter") == reason
    assert nlk.k1_supported(48, 64, channels, p, "filter") is (reason is None)
    if reason is None:
        assert nlk.note_plain_routes([(p, "filter")], 48, 64, channels) == []
        return
    want = nlk.plain_route_warning(reason)
    assert reason in want and "k1_supported" in want
    with pytest.warns(UserWarning, match=want.replace("(", r"\(").replace(")", r"\)")):
        assert nlk.note_plain_routes([(p, "filter")], 48, 64, channels) == [reason]
