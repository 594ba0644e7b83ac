"""The full-resolution flow path (fscale=0) of the port against the JAX package.

At 1080p the JAX package solves the 1080x1920 level of a full-resolution
flow with its tiled kernel K3 (that level is beyond K2's plan). On the
CPU, K3 itself cannot run (it needs TPU rolls and DMA semaphores), so the
counterpart of the port's K3 plain version is JAX
``tvl1_flow_single_scale(check_every=K, ...)``: the same where-form step,
last-iteration error and ``n += K`` stopping rule, differing only in
hypot against sqrt(x^2 + y^2) and in how l_t is rounded.

The frames here are small, so the plan's budget is patched down until a
48x64 level is beyond it: the finest level of every flow then takes the
tiled path, and each test asserts that it did.

Bars: one level, the JAX suite's bars for its K2 (2e-3 after two blocks,
1e-5 after one iteration); pyramids, mean EPE 0.05 px as
tests/test_torch_flow.py; the slice, the repo's 0.05 dB PSNR bar at the
XLA path's check granularity (10) and 0.1 dB as shipped (K3 blocks of 24,
K2 rounds of 8/24); the CLIs, EPE 0.05 px of the .flo files and 0.1 dB
between the measures files.
"""

import functools
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.cli import nlkalman_seq as j_nlkalman_seq
from bwd_nlkalman_tpu.cli import tvl1flow as j_tvl1flow
from bwd_nlkalman_tpu.flow import tvl1 as j_tvl1
from bwd_nlkalman_tpu.flow.tvl1_fused import fused_level_supported as j_supported
from bwd_nlkalman_tpu.pipeline import sequence as j_seq
from bwd_nlkalman_tpu_torch import convert
from bwd_nlkalman_tpu_torch.cli import nlkalman_seq, tvl1flow
from bwd_nlkalman_tpu_torch.flow import tvl1, tvl1_fused, tvl1_tiled
from bwd_nlkalman_tpu_torch.io import read_flo, write_png, write_tiff
from bwd_nlkalman_tpu_torch.pipeline import sequence as seq

torch.set_num_threads(1)
SIGMA = 20.0


def _smooth_base(rng, h, w, pad=8):
    base = np.cumsum(np.cumsum(rng.normal(size=(h + pad, w + pad)), 0), 1)
    return ((base - base.min()) / (base.max() - base.min()) * 255).astype(np.float32)


def _pair(rng, h=48, w=64, dx=2, dy=1):
    base = _smooth_base(rng, h, w)
    return base[4:4 + h, 4:4 + w], base[4 + dy:4 + dy + h, 4 + dx:4 + dx + w]


def _epe(a, b):
    return float(np.mean(np.linalg.norm(np.asarray(a) - np.asarray(b), axis=-1)))


@pytest.fixture
def tiled_levels(monkeypatch):
    """Route every level of 48x64 or more to the tiled solver; returns the
    list of the level shapes it solved."""
    budget = tvl1_fused._plan(48, 64)[2]
    monkeypatch.setattr(tvl1, "fused_level_supported",
                        lambda h, w: tvl1_fused.fused_level_supported(h, w, budget))
    seen = []

    def record(a, *args, **kw):
        seen.append(tuple(a.shape))
        return tvl1_tiled.tvl1_single_scale_tiled(a, *args, **kw)

    monkeypatch.setattr(tvl1, "tvl1_single_scale_tiled", record)
    return seen


@pytest.mark.parametrize("k,nwarps,max_iters,epsilon,atol,blocks", [
    (24, 2, 48, 0.01, 2e-3, 4),    # two blocks per warp stage
    (1, 1, 1, 0.01, 1e-5, 1),      # one iteration
    (24, 1, 300, 1e-6, 2e-3, 13),  # a cap of 300 runs 13 blocks: 312 iterations
])
def test_tiled_level_matches_xla_single_scale(rng, monkeypatch, k, nwarps,
                                              max_iters, epsilon, atol, blocks):
    h, w = 25, 41
    base = _smooth_base(rng, h, w)
    i0, i1 = base[4:4 + h, 4:4 + w], base[2:2 + h, 5:5 + w]
    u0 = np.zeros((h, w, 2), np.float32)
    ref = j_tvl1.tvl1_flow_single_scale(
        jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(u0), nwarps=nwarps,
        epsilon=epsilon, check_every=k, max_iters=max_iters)
    monkeypatch.setattr(tvl1_tiled, "K_ITERS", k)
    calls = []

    def count(*args, **kw):
        calls.append(args[2])
        return tvl1_tiled.tvl1_block_plain(*args[:6])

    monkeypatch.setattr(tvl1_tiled, "tvl1_block", count)
    got = tvl1_tiled.tvl1_level_tiled_plain(
        torch.from_numpy(i0), torch.from_numpy(i1), torch.from_numpy(u0),
        nwarps=nwarps, epsilon=epsilon, max_iters=max_iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)
    assert len(calls) == blocks and set(calls) == {k}


def test_plan_sends_1080p_level_to_tiled():
    for h, w, fits in ((1080, 1920, False), (540, 960, True), (270, 480, True)):
        assert tvl1_fused.fused_level_supported(h, w) is fits
        assert j_supported(h, w) is fits


def test_fullres_pyramid_flow_epe(rng, tiled_levels):
    i0, i1 = _pair(rng)
    ref, ref_fs = j_tvl1.tvl1_flow(jnp.asarray(i0), jnp.asarray(i1), fscale=0,
                                   lambda_=0.25, backend="xla", return_carry=True)
    got, got_fs = tvl1.tvl1_flow(torch.from_numpy(i0), torch.from_numpy(i1),
                                 fscale=0, lambda_=0.25, return_carry=True)
    assert tiled_levels == [(48, 64)]
    assert got.shape == ref.shape and got_fs.shape == ref_fs.shape
    assert _epe(got, ref) <= 0.05
    assert _epe(got_fs, ref_fs) <= 0.05


@pytest.mark.parametrize("stale", [False, True])
def test_fullres_warm_flow_epe(rng, tiled_levels, stale):
    """Warm step at fscale=0 from the JAX cold carry (the warm solve is the
    tiled level); a stale carry trips the gate and both take the cold
    pyramid, whose finest level is the tiled one too."""
    i0, i1 = _pair(rng)
    j_i0, j_i1 = jnp.asarray(i0), jnp.asarray(i1)
    _, carry = j_tvl1.tvl1_flow(j_i0, j_i1, fscale=0, lambda_=0.25,
                                backend="xla", return_carry=True)
    carry = np.array(carry)
    if stale:
        carry = -carry - 6.0
    a, b = j_tvl1._prep_pair(j_i0, j_i1)
    assert bool(j_tvl1.warm_gate_ok(a, b, jnp.asarray(carry))[0]) == (not stale)
    ref, ref_fs = j_tvl1.tvl1_flow_warm(j_i0, j_i1, jnp.asarray(carry), fscale=0,
                                        lambda_=0.25, backend="xla", warm_nwarps=3)
    got, got_fs = tvl1.tvl1_flow_warm(torch.from_numpy(i0), torch.from_numpy(i1),
                                      torch.from_numpy(carry), fscale=0,
                                      lambda_=0.25, warm_nwarps=3)
    assert tiled_levels == [(48, 64)]
    assert _epe(got, ref) <= 0.05
    assert _epe(got_fs, ref_fs) <= 0.05


def _clip(t=3, h=48, w=64, seed=0):
    """Translating structured scene + AWGN, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(np.cumsum(rng.standard_normal((h + 8, w + 8)), 0), 1)
    base = ((base - base.min()) / (base.max() - base.min()) * 175 + 40).astype(np.float32)
    clean = np.stack([base[i:i + h, i:i + w] for i in range(t)])[..., None]
    noisy = clean + SIGMA * rng.standard_normal(clean.shape).astype(np.float32)
    return clean, noisy


def _psnr(clean, x):
    return float(10 * np.log10(255.0 ** 2 / np.mean((np.asarray(x) - clean) ** 2)))


J_FULLRES = j_seq.FlowConfig(fscale=0)


@functools.lru_cache(maxsize=None)
def _jax_psnr():
    """flt2 and smo1 PSNR of JAX denoise_sequence at fscale=0 on _clip();
    one JAX run serves both slice tests."""
    clean, noisy = _clip()
    _, flt2, smo1 = j_seq.denoise_sequence(jnp.asarray(noisy), SIGMA,
                                           flow_cfg=J_FULLRES)
    return _psnr(clean, flt2), _psnr(clean, smo1)


def _port_psnr(tiled_levels):
    clean, noisy = _clip()
    model = seq.NLKalmanDenoiser(SIGMA, 48, 64, convert.flow_config_from_jax(J_FULLRES),
                                 device="cpu")
    flt1, flt2, smo1 = model(torch.from_numpy(noisy))
    for out in (flt1, flt2, smo1):
        assert out.shape == noisy.shape and torch.isfinite(out).all()
    # two flows per frame pair (filter and smoother), each ends on the tiled level
    assert tiled_levels == [(48, 64)] * 4
    return _psnr(clean, flt2), _psnr(clean, smo1)


def test_fullres_slice_psnr_parity(tiled_levels, monkeypatch):
    """At the XLA path's granularity: K3 blocks and K2 rounds of 10."""
    monkeypatch.setattr(tvl1_tiled, "K_ITERS", 10)
    monkeypatch.setattr(tvl1, "_k_check", lambda npx: 10)
    flt2, smo1 = _port_psnr(tiled_levels)
    j_flt2, j_smo1 = _jax_psnr()
    print(f"fscale=0 slice at granularity 10: flt2 {flt2 - j_flt2:+.4f} dB, "
          f"smo1 {smo1 - j_smo1:+.4f} dB against JAX")
    assert abs(flt2 - j_flt2) <= 0.05
    assert abs(smo1 - j_smo1) <= 0.05


def test_fullres_slice_shipped_granularity(tiled_levels):
    flt2, smo1 = _port_psnr(tiled_levels)
    j_flt2, j_smo1 = _jax_psnr()
    print(f"fscale=0 slice as shipped: flt2 {flt2 - j_flt2:+.4f} dB, "
          f"smo1 {smo1 - j_smo1:+.4f} dB against JAX")
    assert abs(flt2 - j_flt2) <= 0.1
    assert abs(smo1 - j_smo1) <= 0.1


def test_tvl1flow_cli_matches_jax_cli(rng, tmp_path, tiled_levels, monkeypatch):
    """Both tvl1flow commands at their defaults (fscale=0) on one PNG pair.
    The JAX command runs in this process without its JAX set-up, which
    would turn on a persistent compilation cache the suite keeps off."""
    monkeypatch.setattr(j_tvl1flow, "setup_jax", lambda: None)
    monkeypatch.setenv("BNLK_NO_NATIVE", "1")
    i0, i1 = _pair(rng)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    write_png(a, i0)
    write_png(b, i1)
    assert j_tvl1flow.main([a, b, str(tmp_path / "j.flo")]) == 0
    assert tvl1flow.main([a, b, str(tmp_path / "p.flo"), "--device", "cpu"]) == 0
    assert tiled_levels == [(48, 64)]
    got, want = read_flo(str(tmp_path / "p.flo")), read_flo(str(tmp_path / "j.flo"))
    assert got.shape == want.shape == (48, 64, 2)
    assert _epe(got, want) <= 0.05


def _measures(path):
    """{stage: total PSNR} of a measures file."""
    text = open(path).read()
    return {m[0]: float(m[1]) for m in
            re.findall(r"^(\w+)-total RMSE \S+ PSNR (\S+)$", text, re.M)}


def test_nlkalman_seq_cli_fullres_matches_jax_cli(tmp_path, tiled_levels, monkeypatch):
    """Both nlkalman-seq commands at fscale=0 in ground-truth mode (the same
    reference-exact noise) on the slice's clip."""
    monkeypatch.setattr(j_nlkalman_seq, "setup_jax", lambda: None)
    monkeypatch.setenv("BNLK_NO_NATIVE", "1")
    clean, _ = _clip()
    pat = str(tmp_path / "c-%03d.tif")
    for i in range(clean.shape[0]):
        write_tiff(pat % (i + 1), clean[i])
    args = [pat, "1", "3", "20", "--gt-pattern", pat, "--fscale", "0"]
    assert j_nlkalman_seq.main([*args[:4], str(tmp_path / "j"), *args[4:]]) == 0
    assert nlkalman_seq.main([*args[:4], str(tmp_path / "p"), *args[4:],
                              "--device", "cpu"]) == 0
    assert tiled_levels == [(48, 64)] * 4
    got = _measures(os.path.join(tmp_path, "p", "measures"))
    want = _measures(os.path.join(tmp_path, "j", "measures"))
    assert set(got) == set(want) == {"flt1", "flt2", "smo1"}
    for stage in got:
        assert abs(got[stage] - want[stage]) <= 0.1, stage
