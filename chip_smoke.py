#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the repository root with ``python3 chip_smoke.py`` (no
arguments, one GPU). Phases, each reported on its own line:

1. device: fails unless CUDA is available; prints the card's name and
   power limit (nvidia-smi) and turns TF32 off for matmuls and convs;
2. build: compiles the hand-written kernels (K1 NLK pass, K2 TV-L1
   level, K4 bicubic warp) from ``bwd_nlkalman_tpu_torch/csrc`` into
   ``build/torch_kernels/`` and prints the seconds it took;
3. parity: each kernel against its plain PyTorch version on the card, on
   the JAX suite's cases and at the slice's shapes, with the tolerance
   stated beside it; then each kernel's time against its plain version's;
4. slice: ``NLKalmanDenoiser`` on 4 frames of 1080p gray at sigma=20
   with warm-started flow; outputs must be finite and denoise, and every
   kernel must have launched during that run;
5. slice against plain: at 128x160, 3 frames, kernels and plain versions
   must give flt2 and smo1 PSNR within 0.05 dB of each other.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failure raises and
the script exits non-zero without that line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

SIGMA = 20.0
FULL = (1080, 1920)     # the slice's frame size: 1080p gray
MID = (270, 480)        # the quarter-size K1 parity case
# bounds at the slice's shapes, each well above what an H100 measured
K1_FULL_SHARE = 5e-5    # share of 1080p pixels beyond rtol 1e-3 / atol 5e-2 (1.3e-5 measured)
K1_FULL_MEAN = 2e-4     # mean abs error of a 1080p pass (3.0e-5 measured)
K2_LEVEL_MAX = 1e-2     # 540x960 level, max abs error (1.9e-3 measured)
K2_LEVEL_EPE = 1e-4     # 540x960 level, mean end-point error (4.6e-6 measured)
HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def make_clip(h, w, frames, sigma, seed=0):
    """Structured translating scene + AWGN (bench.py:make_content's scene,
    same draws): (clean, noisy) as (T, H, W, 1) float32."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(np.cumsum(rng.standard_normal((h + 8, w + 8)), axis=0), axis=1)
    base = ((base - base.min()) / (base.max() - base.min()) * 175 + 40).astype(np.float32)
    clean = np.stack([base[i % 8: i % 8 + h, i % 8: i % 8 + w]
                      for i in range(frames)])[..., None]
    noisy = clean + sigma * rng.standard_normal(clean.shape).astype(np.float32)
    return clean, noisy


def psnr(clean, x) -> float:
    import torch

    d = x.double() - clean.double()
    return float(10 * torch.log10(255.0 ** 2 / torch.mean(d * d)))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call between CUDA events, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_pair(kernel_fn, plain_fn, reps_k, reps_p):
    """Kernel and plain times in turns (plain, kernel, kernel, plain)."""
    p1 = cuda_ms(plain_fn, reps_p)
    k1 = cuda_ms(kernel_fn, reps_k)
    k2 = cuda_ms(kernel_fn, reps_k)
    p2 = cuda_ms(plain_fn, reps_p)
    return (k1 + k2) / 2, (p1 + p2) / 2


def check(ok, msg: str) -> None:
    """Fail the run unless ``ok`` (an ``assert`` would vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def assert_close(name, got, want, rtol, atol):
    import torch

    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{name}: {m}")


# ------------------------------------------------------------------ phases
def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(smi)
    log(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def phase_build():
    import torch
    from bwd_nlkalman_tpu_torch import _build

    lib, secs = _build.build()
    _build.library()
    log(f"[2 build] {lib.relative_to(HERE)} built in {secs:.1f} s from "
        f"{len(list(_build.CSRC.glob('*.cu')))} sources (hash {_build.source_hash()})")
    torch.cuda.synchronize()


PARITY = {}     # kernel id -> largest abs error over its checked cases
TIMES = {}      # kernel id -> (kernel ms, plain ms)


def _nlk_inputs(rng, h, w, ch, sigma=SIGMA):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    clean = (100 + 60 * np.sin(0.1 * xx) + 50 * np.cos(0.13 * yy))[..., None]
    clean = np.repeat(clean, ch, -1).astype(np.float32)
    cur = clean + sigma * rng.standard_normal(clean.shape).astype(np.float32)
    prev = clean + 2 * rng.standard_normal(clean.shape).astype(np.float32)
    valid = np.ones((h, w), bool)
    valid[h // 3: h // 3 + 4, w // 2: w // 2 + 6] = False
    valid[:, :2] = valid[:2] = False
    basic = clean + 4 * rng.standard_normal(clean.shape).astype(np.float32)
    return cur, np.where(valid[..., None], prev, 0.0).astype(np.float32), valid, basic


def phase_k1(smi):
    import torch
    from bwd_nlkalman_tpu_torch.core.engine import dense_pass_v2, nlk_bases
    from bwd_nlkalman_tpu_torch.core.engine_cuda import dense_pass_cuda
    from bwd_nlkalman_tpu_torch.ops.bases import make_bases
    from bwd_nlkalman_tpu_torch.params import FilterMode, NLKParams, default_params

    prms = NLKParams(patch_sz=8, search_sz_x=6, search_sz_t=3, npatches_x=12,
                     npatches_t=8, npatches_tagg=4, dista_lambda=1.0,
                     beta_x=3.0, beta_t=2.0)
    sprms = NLKParams(patch_sz=8, search_sz_x=6, search_sz_t=3, npatches_x=0,
                      npatches_t=8, npatches_tagg=8, dista_lambda=1.0,
                      beta_x=0.0, beta_t=4.0)
    cases = [  # the six cases of tests/test_engine_pallas.py, 32x40
        ("filter", False, False, prms, 1, 32, 40),
        ("filter", True, False, prms, 1, 32, 40),
        ("filter", True, True, prms, 1, 32, 40),
        ("smooth", True, False, sprms, 1, 32, 40),
        ("smooth", False, False, sprms, 1, 32, 40),
        ("filter", True, False, prms, 3, 32, 40),
        # the slice's own parameters at 270x480 gray
        ("filter", True, False, default_params(SIGMA, FilterMode.FLT1), 1, *MID),
        ("filter", True, True, default_params(SIGMA, FilterMode.FLT2), 1, *MID),
        ("smooth", True, False, default_params(SIGMA, FilterMode.SMO1), 1, *MID),
    ]
    rng = np.random.default_rng(0)
    kb = make_bases(nlk_bases(8), "cuda")
    worst = 0.0
    for mode, has_prev, has_basic, p, ch, h, w in cases:
        cur, prev, valid, basic = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                                   for a in _nlk_inputs(rng, h, w, ch))
        if not has_prev:
            prev, valid = torch.zeros_like(cur), torch.zeros_like(valid)
        if not has_basic:
            basic = cur
        args = (cur, prev, valid, basic, SIGMA, p, mode, has_prev, has_basic, kb)
        got = dense_pass_cuda(*args)
        want = dense_pass_v2(*args)
        torch.cuda.synchronize()
        err = max_err(got, want)
        worst = max(worst, err)
        log(f"[3 parity] K1 {mode} prev={has_prev} basic={has_basic} ch={ch} "
            f"{h}x{w}: max abs err {err:.3e} (rtol 1e-3, atol 5e-2)")
        assert_close("K1", got, want, rtol=1e-3, atol=5e-2)
    PARITY["K1"] = worst

    # the slice's own passes at 1080p gray, held to the bar by share: where
    # a distance summed in another order falls on the other side of a
    # selection threshold, a patch group changes and single pixels move
    # past it (on an H100 80GB HBM3 at 700 W: 27 of 2,073,600 pixels on a
    # first frame, 10 with a previous frame); a grid or indexing fault moves
    # far more
    cur, prev, valid, basic = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                               for a in _nlk_inputs(rng, *FULL, 1))
    for name, mode, fm, has_prev, has_basic, timed in (
            ("flt1 first frame", "filter", FilterMode.FLT1, False, False, False),
            ("flt1", "filter", FilterMode.FLT1, True, False, True),
            ("flt2", "filter", FilterMode.FLT2, True, True, False),
            ("smo1", "smooth", FilterMode.SMO1, True, False, True)):
        args = (cur, prev if has_prev else torch.zeros_like(cur),
                valid if has_prev else torch.zeros_like(valid),
                basic if has_basic else cur, SIGMA, default_params(SIGMA, fm),
                mode, has_prev, has_basic, kb)
        if timed:
            k_ms, p_ms = timed_pair(lambda: dense_pass_cuda(*args),
                                    lambda: dense_pass_v2(*args), 5, 1)
            log(f"[3 time] K1 {mode} 1080p gray: kernel {k_ms:.2f} ms, plain "
                f"{p_ms:.2f} ms ({smi})")
            if mode == "filter":
                TIMES["K1"] = (k_ms, p_ms)
        got, want = dense_pass_cuda(*args), dense_pass_v2(*args)
        diff = (got - want).abs()
        share = float(((diff > 5e-2 + 1e-3 * want.abs()).sum())) / want.numel()
        mean = float(diff.mean())
        log(f"[3 parity] K1 {name} 1080p gray: max abs err {float(diff.max()):.3e}, "
            f"mean abs err {mean:.3e} (<= {K1_FULL_MEAN:g}), share beyond rtol 1e-3 "
            f"/ atol 5e-2 {share:.2e} (<= {K1_FULL_SHARE:g})")
        check(share <= K1_FULL_SHARE, f"K1 {name} 1080p: {share} of pixels beyond the bar")
        check(mean <= K1_FULL_MEAN, f"K1 {name} 1080p: mean abs err {mean}")
        del got, want, diff, args
        torch.cuda.empty_cache()


def phase_k2(smi):
    import torch
    from bwd_nlkalman_tpu_torch.flow import tvl1
    from bwd_nlkalman_tpu_torch.flow.tvl1_cuda import tvl1_level_cuda
    from bwd_nlkalman_tpu_torch.flow.tvl1_fused import tvl1_level_plain

    rng = np.random.default_rng(7)
    h, w = 25, 41
    base = np.cumsum(np.cumsum(rng.normal(size=(h + 8, w + 8)), 0), 1)
    base = ((base - base.min()) / (base.max() - base.min()) * 255).astype(np.float32)
    i0 = torch.from_numpy(np.ascontiguousarray(base[4:4 + h, 4:4 + w])).cuda()
    i1 = torch.from_numpy(np.ascontiguousarray(base[2:2 + h, 5:5 + w])).cuda()
    u0 = i0.new_zeros((h, w, 2))
    worst = 0.0
    # the JAX suite's bars for its K2 (tests/test_round3.py:45-61)
    for nwarps, k_check, max_iters, atol in ((2, 8, 32, 2e-3), (1, 1, 1, 1e-5)):
        kw = dict(nwarps=nwarps, k_check=k_check, max_iters=max_iters)
        got = tvl1_level_cuda(i0, i1, u0, **kw)
        want = tvl1_level_plain(i0, i1, u0, **kw)
        torch.cuda.synchronize()
        err = max_err(got, want)
        worst = max(worst, err)
        log(f"[3 parity] K2 {h}x{w} nwarps={nwarps} k_check={k_check} "
            f"max_iters={max_iters}: max abs err {err:.3e} (atol {atol:g})")
        assert_close("K2", got, want, rtol=0.0, atol=atol)
    PARITY["K2"] = worst

    # the slice's finest solved level: 540x960 from a 1080p pair
    _, noisy = make_clip(*FULL, 2, SIGMA)
    nz = torch.from_numpy(noisy).cuda()
    a, b = tvl1._prep_pair(nz[1, ..., 0], nz[0, ..., 0])
    a, b = tvl1.zoom_out(a, 0.5), tvl1.zoom_out(b, 0.5)
    u0 = a.new_zeros(a.shape + (2,))
    kw = dict(lambda_=0.25, nwarps=5, k_check=8, max_iters=300)
    k_ms, p_ms = timed_pair(lambda: tvl1_level_cuda(a, b, u0, **kw),
                            lambda: tvl1_level_plain(a, b, u0, **kw), 3, 1)
    got, want = tvl1_level_cuda(a, b, u0, **kw), tvl1_level_plain(a, b, u0, **kw)
    epe = float(torch.linalg.vector_norm(got - want, dim=-1).mean())
    err = max_err(got, want)
    log(f"[3 time] K2 level {a.shape[0]}x{a.shape[1]} nwarps=5: kernel "
        f"{k_ms:.2f} ms, plain {p_ms:.2f} ms ({smi})")
    log(f"[3 parity] K2 level {a.shape[0]}x{a.shape[1]} nwarps=5: max abs err "
        f"{err:.3e} (<= {K2_LEVEL_MAX:g}), mean EPE {epe:.2e} px (<= {K2_LEVEL_EPE:g})")
    check(err <= K2_LEVEL_MAX, f"K2 540x960 level max abs err {err}")
    check(epe <= K2_LEVEL_EPE, f"K2 540x960 level mean EPE {epe} px")
    TIMES["K2"] = (k_ms, p_ms)


def _warp_flow(rng, h, w):
    f = 1.5 * rng.standard_normal((h, w, 2)).astype(np.float32)
    f[: max(1, h // 5), :, 1] -= 9.0
    f[:, -max(1, w // 6):, 0] += 12.5
    return f


def phase_k4(smi):
    import torch
    from bwd_nlkalman_tpu_torch.ops.warp import bicubic_warp_plain
    from bwd_nlkalman_tpu_torch.ops.warp_cuda import bicubic_warp_cuda

    rng = np.random.default_rng(3)
    worst = 0.0
    for c in (1, 2, 3):
        h, w = 32, 40
        im = torch.from_numpy(rng.uniform(0, 255, (h, w, c)).astype(np.float32)).cuda()
        flow = torch.from_numpy(_warp_flow(rng, h, w)).cuda()
        occl = torch.from_numpy(np.where(rng.uniform(size=(h, w)) < 0.1, 255.0, 0.0)
                                .astype(np.float32)).cuda()
        for oc in (None, occl):
            got, gv = bicubic_warp_cuda(im, flow, oc)
            want, wv = bicubic_warp_plain(im, flow, oc)
            torch.cuda.synchronize()
            err = max_err(got, want)
            worst = max(worst, err)
            log(f"[3 parity] K4 {h}x{w} C={c} occl={oc is not None}: max abs err "
                f"{err:.3e} (atol 1e-3), valid {int(gv.sum())}/{h * w} identical="
                f"{bool(torch.equal(gv, wv))}")
            check(torch.equal(gv, wv), "K4 validity masks differ")
            check(0 < int(gv.sum()) < h * w, "K4 case is all valid or all invalid")
            assert_close("K4", got, want, rtol=0.0, atol=1e-3)
    PARITY["K4"] = worst

    h, w = FULL
    im = torch.from_numpy(rng.uniform(0, 255, (h, w, 2)).astype(np.float32)).cuda()
    flow = torch.from_numpy(_warp_flow(rng, h, w)).cuda()
    k_ms, p_ms = timed_pair(lambda: bicubic_warp_cuda(im, flow),
                            lambda: bicubic_warp_plain(im, flow), 20, 5)
    log(f"[3 time] K4 1080p C=2: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms ({smi})")
    TIMES["K4"] = (k_ms, p_ms)
    # the slice's warps: C=2 (the filter's flt1|flt2) and C=1 with an
    # occlusion mask (the smoother's)
    occl = torch.from_numpy(np.where(rng.uniform(size=(h, w)) < 0.1, 255.0, 0.0)
                            .astype(np.float32)).cuda()
    for c, oc in ((2, None), (1, occl)):
        got, gv = bicubic_warp_cuda(im[..., :c].contiguous(), flow, oc)
        want, wv = bicubic_warp_plain(im[..., :c].contiguous(), flow, oc)
        log(f"[3 parity] K4 1080p C={c} occl={oc is not None}: max abs err "
            f"{max_err(got, want):.3e} (atol 1e-3), valid {int(gv.sum())}/{h * w} "
            f"identical={bool(torch.equal(gv, wv))}")
        check(torch.equal(gv, wv), "K4 1080p validity masks differ")
        assert_close("K4 1080p", got, want, rtol=0.0, atol=1e-3)


def phase_slice(smi):
    import torch
    import bwd_nlkalman_tpu_torch as port
    from bwd_nlkalman_tpu_torch.pipeline import FlowConfig, NLKalmanDenoiser

    t, (h, w) = 4, FULL
    clean_np, noisy_np = make_clip(h, w, t, SIGMA)
    clean = torch.from_numpy(clean_np).cuda()
    noisy = torch.from_numpy(noisy_np).cuda()
    model = NLKalmanDenoiser(SIGMA, h, w, FlowConfig(warm_start=True, warm_nwarps=3)).cuda()
    model(noisy[:2])            # warm-up: allocator, cuBLAS handles
    torch.cuda.synchronize()
    counters = port.kernel_counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    flt1, flt2, smo1 = model(noisy)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: c.count for k, c in counters.items()}
    for name, x in (("flt1", flt1), ("flt2", flt2), ("smo1", smo1)):
        check(x.shape == noisy.shape, f"{name} shape {tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()), f"{name} has non-finite values")
    p_n, p_1, p_2, p_s = (psnr(clean, x) for x in (noisy, flt1, flt2, smo1))
    log(f"[4 slice] 1080p gray T={t} sigma={SIGMA:g} warm flow: PSNR noisy "
        f"{p_n:.3f} flt1 {p_1:.3f} flt2 {p_2:.3f} smo1 {p_s:.3f} dB")
    log(f"[4 slice] {secs:.3f} s, {t / secs:.3f} frames/s ({smi})")
    log(f"[4 slice] launches during the run: {launches}")
    check(p_s >= p_n + 6.0, "smo1 does not denoise by 6 dB")
    check(p_s >= p_2 - 0.1, "smo1 is worse than flt2 by more than 0.1 dB")
    check(all(n > 0 for n in launches.values()), f"a kernel never launched: {launches}")
    check(launches["K1"] >= 3 * t - 1, f"K1 ran {launches['K1']} passes")
    return launches, t / secs


def phase_slice_vs_plain():
    import torch
    from bwd_nlkalman_tpu_torch.pipeline import FlowConfig, NLKalmanDenoiser

    clean_np, noisy_np = make_clip(128, 160, 3, SIGMA, seed=1)
    clean = torch.from_numpy(clean_np).cuda()
    noisy = torch.from_numpy(noisy_np).cuda()
    for cfg in (FlowConfig(), FlowConfig(warm_start=True, warm_nwarps=3)):
        res = {}
        for engine in ("auto", "plain"):
            _, flt2, smo1 = NLKalmanDenoiser(SIGMA, 128, 160, cfg, engine=engine).cuda()(noisy)
            torch.cuda.synchronize()
            res[engine] = (psnr(clean, flt2), psnr(clean, smo1))
        d2 = abs(res["auto"][0] - res["plain"][0])
        ds = abs(res["auto"][1] - res["plain"][1])
        log(f"[5 slice vs plain] 128x160 T=3 warm={cfg.warm_start}: kernels "
            f"flt2/smo1 {res['auto'][0]:.4f}/{res['auto'][1]:.4f} dB, plain "
            f"{res['plain'][0]:.4f}/{res['plain'][1]:.4f} dB, |d| {d2:.4f}/{ds:.4f} (<= 0.05)")
        check(d2 <= 0.05 and ds <= 0.05, "kernels and plain versions disagree")


KERNELS = {
    "K1": ("nlk_pass", "bwd_nlkalman_tpu_torch/csrc/nlk_pass.cu",
           "bwd_nlkalman_tpu/core/engine_pallas.py:128"),
    "K2": ("tvl1_level", "bwd_nlkalman_tpu_torch/csrc/tvl1_level.cu",
           "bwd_nlkalman_tpu/flow/tvl1_fused.py:65"),
    "K4": ("bicubic_warp", "bwd_nlkalman_tpu_torch/csrc/warp.cu",
           "bwd_nlkalman_tpu/ops/warp_pallas.py:59"),
}


def main() -> int:
    smi = phase_device()
    import torch

    sys.path.insert(0, HERE)
    phase_build()
    for phase in (phase_k1, phase_k2, phase_k4):
        phase(smi)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    launches, fps = phase_slice(smi)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    phase_slice_vs_plain()
    torch.cuda.synchronize()
    log(json.dumps({"kernels": [
        {"name": KERNELS[k][0], "route": "cuda", "source": KERNELS[k][1],
         "replaces": KERNELS[k][2], "launches": launches[k],
         "max_abs_err": PARITY[k], "ms": TIMES[k][0], "plain_ms": TIMES[k][1]}
        for k in ("K1", "K2", "K4")]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
