"""Which engine runs an NLK pass: ``core.nlkalman.k1_supported``, the
counterpart of JAX's ``pallas_pass_supported``
(bwd_nlkalman_tpu/core/engine_pallas.py:1279), and the routing that
``engine="auto"`` applies to a CUDA pass before any launch.

The table holds the rule: K1 takes the defaults at 1080p gray and RGB
with float32 and bfloat16 bands, and not an odd patch size, lambda != 1,
a distance threshold, a radius over 15 or 8 channels. Where both rules
apply (the parameter rules, not the two cards' memory plans, which
differ: the TPU kernel's VMEM plan refuses 1080p RGB at full width, where
JAX then runs column strips), the verdict is JAX's too.
"""

import dataclasses
import types

import pytest
import torch

from bwd_nlkalman_tpu.core.engine_pallas import pallas_pass_supported
from bwd_nlkalman_tpu.params import FilterMode as JFilterMode
from bwd_nlkalman_tpu.params import default_params as j_default_params
from bwd_nlkalman_tpu_torch.convert import params_from_jax
from bwd_nlkalman_tpu_torch.core import nlkalman as nlk

SIGMA = 20.0
FM = {"flt1": JFilterMode.FLT1, "flt2": JFilterMode.FLT2, "smo1": JFilterMode.SMO1}
MODE = {"flt1": "filter", "flt2": "filter", "smo1": "smooth"}

# (h, w, ch, pass, change, window dtype, K1 takes it, JAX's rule applies)
TABLE = [
    (1080, 1920, 1, "flt1", {}, "float32", True, True),
    (1080, 1920, 1, "flt2", {}, "bfloat16", True, True),
    (1080, 1920, 1, "smo1", {}, "float32", True, True),
    (1080, 1920, 3, "flt1", {}, "float32", True, False),
    (1080, 1920, 3, "smo1", {}, "bfloat16", True, False),
    (540, 960, 1, "flt1", dict(patch_sz=4), "float32", True, True),
    (540, 960, 1, "flt1", dict(patch_sz=16), "bfloat16", True, False),
    (540, 960, 1, "flt1", dict(patch_sz=7), "float32", False, True),
    (540, 960, 1, "flt1", dict(patch_sz=5), "bfloat16", False, True),
    (540, 960, 1, "flt1", dict(dista_lambda=0.5), "float32", False, True),
    (540, 960, 1, "smo1", dict(dista_th=2.0), "float32", False, True),
    (540, 960, 1, "flt1", dict(search_sz_x=16), "float32", False, False),
    (540, 960, 8, "flt1", {}, "float32", False, True),
    (540, 960, 7, "smo1", {}, "float32", True, False),
    (6, 40, 1, "flt1", {}, "float32", False, True),
]


@pytest.mark.parametrize("h,w,ch,name,change,wdt,k1,same", TABLE)
def test_k1_supported_table(h, w, ch, name, change, wdt, k1, same):
    jp = dataclasses.replace(j_default_params(SIGMA, FM[name]), **change)
    p = params_from_jax(jp)
    assert nlk.k1_supported(h, w, ch, p, MODE[name], wdt) is k1
    assert (nlk.k1_refusal(h, w, ch, p, MODE[name], wdt) is None) is k1
    if same:
        assert pallas_pass_supported(h, w, ch, jp, MODE[name], window_dtype=wdt) is k1


def _cuda_frame(h, w, ch):
    """What pick_engine reads of a frame (shape, device) for a CUDA tensor,
    which this machine cannot make."""
    return types.SimpleNamespace(shape=(h, w, ch), device=torch.device("cuda"))


def test_pick_engine_routes_by_rule(monkeypatch):
    monkeypatch.setattr(nlk, "_WARNED", set())
    nlk.PLAIN_PASSES.reset()
    ok = params_from_jax(j_default_params(SIGMA, JFilterMode.FLT1))
    odd = dataclasses.replace(ok, patch_sz=7)
    frame = _cuda_frame(64, 96, 3)
    assert nlk.pick_engine("auto", frame, ok, "filter") == "auto"
    assert nlk.pick_engine("plain", frame, odd, "filter") == "plain"
    with pytest.warns(UserWarning, match="patch_sz 7 is odd"):
        assert nlk.pick_engine("auto", frame, odd, "filter") == "plain"
    # once per reason; every routed pass counts
    assert nlk.pick_engine("auto", frame, odd, "filter", "bfloat16") == "plain"
    assert nlk.PLAIN_PASSES.count == 2
    # CPU tensors run the plain pass anyway: no routing, no count
    cpu = torch.zeros((64, 96, 3))
    assert nlk.pick_engine("auto", cpu, odd, "filter") == "auto"
    assert nlk.PLAIN_PASSES.count == 2
    with pytest.raises(ValueError, match="window_dtype"):
        nlk.pick_engine("auto", frame, ok, "filter", "float16")
    nlk.PLAIN_PASSES.reset()


def test_entry_points_run_odd_patch_sizes_on_the_cpu():
    """No entry point refuses a pass JAX runs: an odd patch size and
    lambda != 1 run (the plain pass) where they raised before."""
    from bwd_nlkalman_tpu_torch.pipeline import NLKalmanDenoiser, StreamingDenoiser

    x = torch.rand((2, 24, 32, 1)) * 255
    p1 = params_from_jax(dataclasses.replace(j_default_params(SIGMA, JFilterMode.FLT1),
                                             patch_sz=5, dista_lambda=0.5))
    out = NLKalmanDenoiser(SIGMA, 24, 32, p1=p1, device="cpu", smoother="none")(x)
    assert out[1].shape == x.shape and bool(torch.isfinite(out[1]).all())
    sd = StreamingDenoiser(SIGMA, p1=p1, device="cpu")
    assert sd.step(x[0])[1].shape == x.shape[1:]


def test_stream_checkpoint_records_window_dtype(tmp_path):
    """A stream's checkpoint records the band type it ran with; a stream of
    another type does not resume from it, one of the same type does."""
    from bwd_nlkalman_tpu_torch.pipeline import StreamingDenoiser

    x = torch.rand((24, 32, 1)) * 255
    sd = StreamingDenoiser(SIGMA, device="cpu", window_dtype="bfloat16")
    sd.step(x)
    path = str(tmp_path / "s.npz")
    sd.save_state(path)
    with pytest.raises(ValueError, match="bfloat16 stream"):
        StreamingDenoiser(SIGMA, device="cpu").load_state(path)
    again = StreamingDenoiser(SIGMA, device="cpu", window_dtype="bfloat16")
    again.load_state(path)
    assert again.index == 0 and torch.equal(again.flt2, sd.flt2)
