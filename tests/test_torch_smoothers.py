"""The port's causal smoothers against the JAX package, on gray frames:
``fsmo_sequence``, ``lsmo_sequence`` and ``nlkalman-seq --smoother
fsmo|lsmo``.

Bars, as ``tests/test_torch_pipeline.py`` sets them: the PSNR of every
output against the clean frames within 0.05 dB of the JAX pipeline on
the same noisy clip with the port at the XLA path's TV-L1 check
granularity (10), and within 0.1 dB as shipped (K2's 8/24); the CLIs'
measures files within 0.1 dB. Each JAX pipeline runs once for the module
(a module-scoped fixture); the JAX CLIs then reuse its compiled
executables, as they run at the same shapes and parameters.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.cli import nlkalman_seq as j_nlkalman_seq
from bwd_nlkalman_tpu.pipeline import sequence as j_seq
from bwd_nlkalman_tpu_torch.cli import nlkalman_seq
from bwd_nlkalman_tpu_torch.flow import tvl1
from bwd_nlkalman_tpu_torch.io import write_tiff
from bwd_nlkalman_tpu_torch.pipeline import sequence as seq
from test_torch_fullres import _measures

torch.set_num_threads(1)
SIGMA = 20.0
# the flow configuration as the JAX command builds it from its flags, so
# that its calls hit the fixture's compiled executables
J_CFG = j_seq.FlowConfig(fscale=1, lambda_=0.25, occ_threshold=0.75)
BARS = {"granularity 10": 0.05, "shipped": 0.1}


def scene(t, h, w, c=1, sigma=SIGMA, seed=0):
    """A translating structured scene, one field per channel, and its AWGN,
    made with numpy from a seed: (clean, noisy), (T, H, W, C) float32. At
    c=1 the draws are those of ``test_torch_pipeline._clip``."""
    rng = np.random.default_rng(seed)
    fields = []
    for _ in range(c):
        base = np.cumsum(np.cumsum(rng.standard_normal((h + 8, w + 8)), 0), 1)
        fields.append((base - base.min()) / (base.max() - base.min()) * 175 + 40)
    base = np.stack(fields, -1).astype(np.float32)
    clean = np.stack([base[i:i + h, i:i + w] for i in range(t)])
    noisy = clean + sigma * rng.standard_normal(clean.shape).astype(np.float32)
    return clean, noisy


def psnr(clean, x):
    return float(10 * np.log10(255.0 ** 2 / np.mean((np.asarray(x) - clean) ** 2)))


def granularity(monkeypatch, name):
    """Run the port's TV-L1 at the XLA path's check granularity (10) for
    the "granularity 10" bar; leave it as shipped otherwise."""
    if name == "granularity 10":
        monkeypatch.setattr(tvl1, "_k_check", lambda npx: 10)


def hold(name, clean, got, want, bar):
    """Every output's PSNR within ``bar`` dB of JAX's; prints the gaps and
    the largest abs difference of each output."""
    for key, g, w in zip(("flt1", "flt2", "smo1"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        gap = psnr(clean, g) - psnr(clean, w)
        print(f"{name} {key}: {gap:+.4f} dB, max abs diff {np.abs(g - w).max():.3f}")
        assert g.shape == w.shape and np.isfinite(g).all()
        assert abs(gap) <= bar, key


@pytest.fixture(scope="module")
def gray():
    """fsmo and filter + lsmo of JAX on one gray 32x40 clip of 4 frames."""
    clean, noisy = scene(4, 32, 40)
    nj = jnp.asarray(noisy)
    fsmo = j_seq.fsmo_sequence(nj, SIGMA, flow_cfg=J_CFG)
    flt1, flt2 = j_seq.filter_sequence(nj, SIGMA, flow_cfg=J_CFG)
    lsmo = (flt1, flt2, j_seq.lsmo_sequence(flt2, SIGMA, flow_cfg=J_CFG))
    return clean, noisy, {"fsmo": fsmo, "lsmo": lsmo}


@pytest.mark.parametrize("gran", list(BARS))
def test_fsmo_sequence_matches_jax(gray, monkeypatch, gran):
    clean, noisy, want = gray
    granularity(monkeypatch, gran)
    got = seq.fsmo_sequence(torch.from_numpy(noisy), SIGMA)
    hold(f"fsmo {gran}", clean, got, want["fsmo"], BARS[gran])


@pytest.mark.parametrize("gran", list(BARS))
def test_lsmo_sequence_matches_jax(gray, monkeypatch, gran):
    clean, noisy, want = gray
    granularity(monkeypatch, gran)
    flt1, flt2 = seq.filter_sequence(torch.from_numpy(noisy), SIGMA)
    got = (flt1, flt2, seq.lsmo_sequence(flt2, SIGMA))
    hold(f"lsmo {gran}", clean, got, want["lsmo"], BARS[gran])


def test_fsmo_smoother_takes_the_opp_pass(monkeypatch):
    """fsmo's smoother pass gets the second filter pass's output in OPP as
    it comes out of the pass, not through an RGB round trip."""
    _, noisy = scene(2, 24, 32, c=3)
    seen, passes = [], {}
    smooth = seq.nlkalman_smooth_frame

    def record(filt1, *args, **kw):
        seen.append(filt1)
        return smooth(filt1, *args, **kw)

    filt = seq.nlkalman_filter_frame

    def record_filter(*args, **kw):
        out = filt(*args, **kw)
        passes.setdefault("f21", []).append(out)
        return out

    monkeypatch.setattr(seq, "nlkalman_smooth_frame", record)
    monkeypatch.setattr(seq, "nlkalman_filter_frame", record_filter)
    seq.fsmo_sequence(torch.from_numpy(noisy), SIGMA)
    assert len(seen) == 1 and seen[0] is passes["f21"][-1]


def _cli_pair(tmp_path, monkeypatch, clean, flags, mains=None):
    """A command of the port and of the JAX package (``mains``, default
    both nlkalman-seq), each run in this process in ground-truth mode (the
    same reference-exact noise) with ``flags``; returns (port, JAX)
    measures. The JAX command runs without its JAX set-up, which would
    turn on a persistent compilation cache the suite keeps off."""
    port_main, jax_main = mains or (nlkalman_seq.main, j_nlkalman_seq.main)
    monkeypatch.setattr(j_nlkalman_seq, "setup_jax", lambda: None)
    monkeypatch.setenv("BNLK_NO_NATIVE", "1")
    pat = str(tmp_path / "c-%03d.tif")
    for i in range(clean.shape[0]):
        write_tiff(pat % (i + 1), clean[i])
    args = [pat, "1", str(clean.shape[0]), "20", "--gt-pattern", pat, *flags]
    assert jax_main([*args[:4], str(tmp_path / "j"), *args[4:]]) == 0
    assert port_main([*args[:4], str(tmp_path / "p"), *args[4:],
                      "--device", "cpu"]) == 0
    return (_measures(os.path.join(tmp_path, "p", "measures")),
            _measures(os.path.join(tmp_path, "j", "measures")))


@pytest.mark.parametrize("smoother", ["fsmo", "lsmo"])
def test_nlkalman_seq_cli_smoother_matches_jax_cli(gray, tmp_path, monkeypatch,
                                                   smoother):
    got, want = _cli_pair(tmp_path, monkeypatch, gray[0], ["--smoother", smoother])
    assert set(got) == set(want) == {"flt1", "flt2", "smo1"}
    for stage in got:
        print(f"--smoother {smoother} {stage}: {got[stage] - want[stage]:+.4f} dB")
        assert abs(got[stage] - want[stage]) <= 0.1, stage
