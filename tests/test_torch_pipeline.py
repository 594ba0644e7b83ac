"""The port's whole slice against JAX ``denoise_sequence``.

The bar is the repo's parity bar: the PSNR of flt2 and smo1 against the
clean frames within 0.05 dB of the JAX pipeline on the same noisy clip.

On the CPU the JAX pipeline solves TV-L1 levels with its XLA path, which
checks convergence every 10 iterations; the port keeps the TPU kernel's
granularity (8 on fine levels, 24 on coarse ones). That alone moves the
flow by about 0.045 px mean EPE at 48x64 and smo1 by up to 0.06 dB, so
the parity tests run the port at the XLA path's granularity
(monkeypatched ``_k_check``): everything else is then compared like with
like. The shipped granularity is held to its own, looser bar against the
same JAX run, so a change to the stopping rule cannot drift unseen.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu import params as j_params
from bwd_nlkalman_tpu.flow.tvl1 import luma as j_luma
from bwd_nlkalman_tpu.pipeline import sequence as j_seq
from bwd_nlkalman_tpu_torch import convert, kernel_counters
from bwd_nlkalman_tpu_torch.core.engine import dense_pass
from bwd_nlkalman_tpu_torch.flow import tvl1
from bwd_nlkalman_tpu_torch.flow.tvl1_fused import tvl1_single_scale_fused
from bwd_nlkalman_tpu_torch.ops.warp import bicubic_warp
from bwd_nlkalman_tpu_torch.pipeline import sequence as seq
from bwd_nlkalman_tpu_torch.params import FilterMode, default_params

torch.set_num_threads(1)
SIGMA = 20.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clip(t=3, h=48, w=64, seed=0):
    """Translating structured scene + AWGN, made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(np.cumsum(rng.standard_normal((h + 8, w + 8)), 0), 1)
    base = ((base - base.min()) / (base.max() - base.min()) * 175 + 40).astype(np.float32)
    clean = np.stack([base[i:i + h, i:i + w] for i in range(t)])[..., None]
    noisy = clean + SIGMA * rng.standard_normal(clean.shape).astype(np.float32)
    return clean, noisy


@pytest.fixture
def xla_granularity(monkeypatch):
    monkeypatch.setattr(tvl1, "_k_check", lambda npx: 10)


def _psnr(clean, x):
    return float(10 * np.log10(255.0 ** 2 / np.mean((np.asarray(x) - clean) ** 2)))


def _j_cfg(warm):
    return j_seq.FlowConfig(warm_start=True, warm_nwarps=3) if warm else j_seq.FlowConfig()


@functools.lru_cache(maxsize=None)
def _jax_psnr(warm):
    """PSNR of JAX denoise_sequence's flt2 and smo1 on _clip(); one JAX run
    per flow configuration serves every test of this file."""
    clean, noisy = _clip()
    _, j_flt2, j_smo1 = j_seq.denoise_sequence(jnp.asarray(noisy), SIGMA,
                                               flow_cfg=_j_cfg(warm))
    return _psnr(clean, j_flt2), _psnr(clean, j_smo1)


def _port_run(warm):
    clean, noisy = _clip()
    model = seq.NLKalmanDenoiser(SIGMA, 48, 64, convert.flow_config_from_jax(_j_cfg(warm)),
                                 device="cpu")
    flt1, flt2, smo1 = model(torch.from_numpy(noisy))
    for out in (flt1, flt2, smo1):
        assert out.shape == noisy.shape and torch.isfinite(out).all()
    assert _psnr(clean, smo1) > _psnr(clean, noisy) + 6.0
    return _psnr(clean, flt2), _psnr(clean, smo1)


@pytest.mark.parametrize("warm", [False, True])
def test_denoise_sequence_psnr_parity(warm, xla_granularity):
    flt2, smo1 = _port_run(warm)
    j_flt2, j_smo1 = _jax_psnr(warm)
    assert abs(flt2 - j_flt2) <= 0.05
    assert abs(smo1 - j_smo1) <= 0.05


@pytest.mark.parametrize("warm", [False, True])
def test_denoise_sequence_shipped_granularity(warm):
    """The port as it ships (K2's check every 8 or 24 iterations) against
    the same JAX run (every 10). Bar 0.1 dB; the gaps measured at 48x64 on
    the CPU are flt2 +0.021 / smo1 +0.035 dB cold and flt2 +0.024 / smo1
    +0.061 dB warm."""
    flt2, smo1 = _port_run(warm)
    j_flt2, j_smo1 = _jax_psnr(warm)
    assert abs(flt2 - j_flt2) <= 0.1
    assert abs(smo1 - j_smo1) <= 0.1


def test_frame_pair_steps_from_jax_carry(xla_granularity):
    """One warm step and one cold frame-pair step, each started from the
    exact JAX carry through convert.carry_from_numpy."""
    clean, noisy = _clip(t=3)
    p1 = j_params.default_params(SIGMA, j_params.FilterMode.FLT1)
    p2 = j_params.default_params(SIGMA, j_params.FilterMode.FLT2)
    j_cfg = j_seq.FlowConfig(warm_start=True, warm_nwarps=3)
    nj = jnp.asarray(noisy)
    f11, f21 = j_seq.filter_frame_pair(nj[0], None, None, SIGMA, p1, p2, j_cfg)
    flow1, u_fs = j_cfg.flow_cold_carry(j_luma(nj[1]), j_luma(f21))
    f11, f21 = j_seq._filter_with_flow(nj[1], f11, f21, flow1, j_cfg.occ_threshold,
                                       SIGMA, p1, p2)
    # JAX warm step on frame 2 (the scan body, sequence.py:174-181)
    flow2, _ = j_cfg.flow_warm(j_luma(nj[2]), j_luma(f21), u_fs)
    _, j_w2 = j_seq._filter_with_flow(nj[2], f11, f21, flow2, j_cfg.occ_threshold,
                                      SIGMA, p1, p2)
    # JAX cold frame-pair step on frame 2
    _, j_c2 = j_seq.filter_frame_pair(nj[2], f11, f21, SIGMA, p1, p2, j_seq.FlowConfig())

    carry = convert.carry_from_numpy(np.asarray(f11), np.asarray(f21),
                                     np.asarray(u_fs), "cpu")
    frame = torch.from_numpy(noisy[2])
    q1, q2 = convert.params_from_jax(p1), convert.params_from_jax(p2)
    _, (_, w2) = seq.filter_step_warm(frame, carry, SIGMA, q1, q2,
                                      convert.flow_config_from_jax(j_cfg))
    _, c2 = seq.filter_frame_pair(frame, carry[0], carry[1], SIGMA, q1, q2,
                                  seq.FlowConfig())
    for got, want in ((w2, j_w2), (c2, j_c2)):
        assert abs(_psnr(clean[2], got) - _psnr(clean[2], want)) <= 0.05
        assert float(np.mean(np.abs(got.numpy() - np.asarray(want)))) < 0.5


@pytest.mark.parametrize("call", ["module", "pass", "warp", "level"])
def test_unknown_engine_raises(call):
    x = torch.zeros((16, 16, 1))
    run = {
        "module": lambda: seq.NLKalmanDenoiser(SIGMA, 16, 16, engine="pallas",
                                               device="cpu"),
        "pass": lambda: dense_pass(x, x, x[..., 0] > 0, x, SIGMA,
                                   default_params(SIGMA, FilterMode.FLT1), "filter",
                                   False, False, engine="pallas"),
        "warp": lambda: bicubic_warp(x, x.new_zeros((16, 16, 2)), engine="pallas"),
        "level": lambda: tvl1_single_scale_fused(x[..., 0], x[..., 0],
                                                 x.new_zeros((16, 16, 2)),
                                                 engine="pallas"),
    }[call]
    with pytest.raises(ValueError, match="engine must be"):
        run()


def test_port_never_imports_jax(tmp_path):
    """A CPU run of the modules, of a streaming step, of a multiscale call,
    of the row-sharded flow and of the CLIs, with the native io module
    loaded, loads neither JAX nor any module of the JAX package."""
    code = (
        "import sys, numpy as np, torch\n"
        "import bwd_nlkalman_tpu_torch as P\n"
        "from bwd_nlkalman_tpu_torch import convert, models, native, parallel\n"
        "from bwd_nlkalman_tpu_torch.parallel import flow as pflow\n"
        "from bwd_nlkalman_tpu_torch.cli import (msnlkalman_lz3_seq, msnlkalman_seq,"
        " nlkalman_seq, tvl1flow)\n"
        "from bwd_nlkalman_tpu_torch.io import write_png\n"
        "from bwd_nlkalman_tpu_torch.ops import pyramid\n"
        "from bwd_nlkalman_tpu_torch.pipeline import multiscale, stream\n"
        "from bwd_nlkalman_tpu_torch.tools import k1_bench, vpu_probe\n"
        "x = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (2, 24, 32, 1))"
        ".astype(np.float32))\n"
        "out = P.NLKalmanDenoiser(20.0, 24, 32, device='cpu')(x)\n"
        "assert all(torch.isfinite(o).all() for o in out)\n"
        "sd = P.StreamingDenoiser(20.0, smoother='fsmo', device='cpu')\n"
        "assert all(torch.isfinite(o).all() for f in x for o in sd.step(f))\n"
        "out = P.MultiscaleDenoiser(20.0, 24, 32, levels=2, pyramid='lz3', device='cpu')(x)\n"
        "assert all(torch.isfinite(o).all() for o in out)\n"
        "assert set(P.kernel_counters()) == {'K1', 'K2', 'K3', 'K4', 'K4c9', 'K4grp', 'P', 'G'}\n"
        "m = parallel.make_mesh(1, 2, ['cpu'] * 2)\n"
        "y = torch.from_numpy(np.random.default_rng(1).uniform(0, 255, (2, 48, 32))"
        ".astype(np.float32))\n"
        "u = parallel.sharded_tvl1_flow(y[0], y[1], m, fscale=0)\n"
        "assert u.shape == (48, 32, 2) and torch.isfinite(u).all() and pflow.STATS.rounds['k2']\n"
        "assert callable(native.build) and callable(native.FrameLoader)\n"
        "d = sys.argv[1]\n"
        "for i in range(2):\n"
        "    write_png(f'{d}/f-{i}.png', x[i].numpy())\n"
        "assert tvl1flow.main([f'{d}/f-0.png', f'{d}/f-1.png', f'{d}/u.flo',"
        " '--device', 'cpu']) == 0\n"
        "assert nlkalman_seq.main([f'{d}/f-%d.png', '0', '1', '20', f'{d}/out',"
        " '--fscale', '0', '--device', 'cpu']) == 0\n"
        "bad = [m for m in sys.modules if m in ('jax', 'bwd_nlkalman_tpu')"
        " or m.startswith(('jax.', 'bwd_nlkalman_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_denoiser_runs_on_the_card_by_default():
    """Built without a device, the module asks for the card: on a machine
    without one it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        model = seq.NLKalmanDenoiser(SIGMA, 16, 16)
        assert {b.device.type for b in model.buffers()} == {"cuda"}
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            seq.NLKalmanDenoiser(SIGMA, 16, 16)


@pytest.mark.parametrize("mode", list(j_params.FilterMode))
def test_params_from_jax_round_trips(mode):
    """Each package builds its own NLKParams; params_from_jax carries a JAX
    one across field by field, resolved or partly set."""
    port_mode = FilterMode[mode.name]
    jp = j_params.default_params(SIGMA, mode)
    port = convert.params_from_jax(jp)
    assert type(port) is not type(jp)
    assert dataclasses.asdict(port) == dataclasses.asdict(jp)
    assert port == default_params(SIGMA, port_mode)
    base = j_params.NLKParams(patch_sz=8, npatches_t=7, beta_x=1.5)
    assert convert.params_from_jax(j_params.default_params(SIGMA, mode, base)) \
        == default_params(SIGMA, port_mode, convert.params_from_jax(base))


def test_cpu_run_launches_no_kernel():
    for c in kernel_counters().values():
        c.reset()
    _, noisy = _clip(t=2, h=24, w=32)
    seq.denoise_sequence(torch.from_numpy(noisy), SIGMA,
                         flow_cfg=seq.FlowConfig(warm_start=True))
    assert {k: c.count for k, c in kernel_counters().items()} == {
        "K1": 0, "K2": 0, "K3": 0, "K4": 0, "K4c9": 0, "K4grp": 0, "P": 0, "G": 0}


def test_non_cpu_non_cuda_device_raises():
    x = torch.zeros((1, 16, 16, 1), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        seq.filter_sequence(x, SIGMA)
