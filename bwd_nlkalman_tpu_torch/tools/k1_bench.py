"""Time K1, the NL-Kalman pass kernel, at 1080p on one card, and compare
two checkouts in turns.

    python3 bwd_nlkalman_tpu_torch/tools/k1_bench.py [--against DIR] [--channels C]

Each turn is a worker process that imports ``bwd_nlkalman_tpu_torch``
from one checkout's root, builds that checkout's kernels and times K1's
four 1080p passes at sigma=20 (flt1 on a first frame, flt1, flt2, smo1),
gray or on frames of ``--channels`` channels (1-7, as K1 takes them):
the whole pass between CUDA events (mean of 10 after a
warm-up), and each stage's device time (the DCT, site, aggregation and
fold kernels) from torch.profiler. With
``--against DIR`` (another checkout, for example the parent commit
unpacked with ``git archive``) the turns run other, this, this, other,
so both are timed on the same card. Every turn prints one JSON line with
the card's name and power limit; the last line is the mean per tree.
Each turn also takes a SHA-256 digest of each pass's output and
per-position weights (the sum of the weights of the sites that chose a
position, so a changed selection shows) and of the float32 DCT bands of
the passes' inputs; with ``--against`` the last line says whether the
two trees' digests are equal.

The timing and profiler helpers (:func:`cuda_ms`, :func:`stage_ms`,
:func:`device_events`, :func:`kernel_ms`, :func:`busy_ms`), the inputs
(:func:`nlk_inputs`, :func:`pass_args`), the table of K1's patch
sizes and channel counts (:func:`widened_cases`) and the parameter
search's extremes (:func:`search_cases`) serve ``chip_smoke.py`` and the
``cuda`` tests too. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SIGMA = 20.0
FULL = (1080, 1920)
REPS = 10
STAGES = ("dct_kernel", "site_kernel", "aggregate_kernel", "fold_kernel")


def device_events(prof):
    """(kernel name, start us, end us) of every device activity of a
    ``torch.profiler`` run; empty where the profiler saw no device time."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if getattr(e, "device_type", None) == cuda]


def short_name(name: str) -> str:
    """A kernel's name without return type, namespaces of its own file
    and arguments: ``site_kernel<2>``."""
    name = name.replace("(anonymous namespace)::", "").replace("bnlk_nlk::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].strip()[:80]


def kernel_ms(events, key=short_name) -> dict:
    """Device milliseconds summed by ``key(kernel name)``."""
    out: dict = {}
    for name, t0, t1 in events:
        k = key(name)
        out[k] = out.get(k, 0.0) + (t1 - t0) / 1e3
    return out


def busy_ms(events) -> float:
    """Milliseconds in which at least one device activity ran (the union
    of their intervals)."""
    total, end = 0.0, None
    for t0, t1 in sorted((e[1], e[2]) for e in events):
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total / 1e3


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def nlk_inputs(rng, h, w, ch, sigma=SIGMA):
    """A smooth scene with noise, a previous frame with an invalid patch
    and border, and a basic estimate (the inputs of chip_smoke.py's K1
    parity cases): (cur, prev, valid, basic) as numpy arrays."""
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


# the four kinds of pass: (mode, trained defaults, has_prev, has_basic)
PASS_KINDS = (("filter", "flt1", False, False), ("filter", "flt1", True, False),
              ("filter", "flt2", True, True), ("smooth", "smo1", True, False))


def fitted_params(prms, c: int, mode: str, window_dtype: str = "float32"):
    """``prms`` with its search radii lowered together, one at a time, until
    K1 plans the pass (a large patch of many channels leaves room for a
    small window only)."""
    import dataclasses

    from bwd_nlkalman_tpu_torch.core.engine_cuda import pass_radius, plan_refusal

    while plan_refusal(c, pass_radius(prms, mode), prms.patch_sz, window_dtype):
        r = pass_radius(prms, mode) - 1
        prms = dataclasses.replace(prms, search_sz_x=min(prms.search_sz_x, r),
                                   search_sz_t=min(prms.search_sz_t, r))
    return prms


def widened_cases(patch_sizes, channels):
    """(psz, c, mode, has_prev, has_basic, NLKParams) for every patch size
    and channel count, the four kinds of pass in turn (so each patch size
    meets each kind when four channel counts are given), at sigma=20's
    defaults with the radii K1 plans in float32 (:func:`fitted_params`)."""
    import dataclasses
    import itertools

    from bwd_nlkalman_tpu_torch.params import FilterMode, default_params

    out = []
    for i, (psz, c) in enumerate(itertools.product(patch_sizes, channels)):
        mode, fm, has_prev, has_basic = PASS_KINDS[i % len(PASS_KINDS)]
        p = dataclasses.replace(default_params(SIGMA, FilterMode(fm)), patch_sz=psz)
        out.append((psz, c, mode, has_prev, has_basic, fitted_params(p, c, mode)))
    return out


def search_cases():
    """(name, mode, has_prev, has_basic, NLKParams) of K1 at the parameter
    search's extremes (the harness of ``train/search.py``): random search's
    group sizes at npx 1 and 98 (nagg min(npx, 20), p=8, w=10, wt=5,
    train.sh:40-102) with its betas at their range's ends (beta_x 0 makes
    a lone patch's gain 0/0), and group sizes above the window's candidate
    count, as coordinate descent reaches them (121 temporal candidates at
    wt=5, 441 spatial ones at w=10)."""
    import dataclasses

    from bwd_nlkalman_tpu_torch.params import FilterMode, NLKParams, default_params

    def rs(npx, bx, bt):
        return NLKParams(patch_sz=8, search_sz_x=10, search_sz_t=5, npatches_x=npx,
                         npatches_t=npx, npatches_tagg=min(npx, 20), dista_lambda=1.0,
                         beta_x=bx, beta_t=bt)

    big = dataclasses.replace(default_params(SIGMA, FilterMode.FLT1), npatches_t=150,
                              npatches_x=500, npatches_tagg=20)
    sbig = dataclasses.replace(default_params(SIGMA, FilterMode.SMO1), npatches_t=150,
                               npatches_tagg=20)
    return [("npx 1", "filter", True, False, rs(1, 0.0, 2.0)),
            ("npx 98", "filter", True, False, rs(98, 7.99, 11.99)),
            ("npx 98 first frame", "filter", False, False, rs(98, 7.99, 11.99)),
            ("k above the candidates", "filter", True, False, big),
            ("k above the candidates, first frame", "filter", False, False, big),
            ("smoother k above the candidates", "smooth", True, False, sbig)]


def k1_order_distances(diff, f: int):
    """:func:`core.engine.squared_distances` summed as K1 sums them: one
    coefficient after the other, f = 0..F-1, each step a fused
    multiply-add (emulated in float64: the product is exact there, and the
    sum is rounded once more to float32), then times 1/F."""
    import torch

    acc = torch.zeros(diff.shape[:-1], dtype=torch.float32, device=diff.device)
    for i in range(f):
        d = diff[..., i].double()
        acc = (acc.double() + d * d).float()
    return acc * (1.0 / f)


@contextlib.contextmanager
def k1_order():
    """Within the block the plain NLK pass sums its distances in K1's
    order (:func:`k1_order_distances`), so that it selects the patches K1
    selects where a tie sits on a float's last bit."""
    from bwd_nlkalman_tpu_torch.core import engine

    plain = engine.squared_distances
    engine.squared_distances = k1_order_distances
    try:
        yield
    finally:
        engine.squared_distances = plain


def pass_args(cur, prev, valid, basic, kb):
    """name -> dense_pass arguments of the slice's four 1080p passes."""
    import torch
    from bwd_nlkalman_tpu_torch.params import FilterMode, default_params

    out = {}
    for name, mode, fm, has_prev, has_basic in (
            ("flt1 first frame", "filter", FilterMode.FLT1, False, False),
            ("flt1", "filter", FilterMode.FLT1, True, False),
            ("flt2", "filter", FilterMode.FLT2, True, True),
            ("smo1", "smooth", FilterMode.SMO1, True, False)):
        out[name] = (cur, prev if has_prev else torch.zeros_like(cur),
                     valid if has_prev else torch.zeros_like(valid),
                     basic if has_basic else cur, SIGMA, default_params(SIGMA, fm),
                     mode, has_prev, has_basic, kb)
    return out


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


def stage_ms(fn, reps: int) -> dict | None:
    """Device milliseconds per call of each K1 stage over ``reps`` profiled
    calls; None where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = device_events(prof)
    if not ev:
        return None
    by = kernel_ms(ev, lambda n: next((k for k in STAGES if k in n), "other"))
    return {k: by.get(k, 0.0) / reps for k in STAGES}


def worker(root: str, channels: int = 1) -> dict:
    """Time one checkout's K1 (imported from ``root``) on the card, on
    frames of ``channels`` channels."""
    sys.path.insert(0, root)
    import torch
    from bwd_nlkalman_tpu_torch import _build
    from bwd_nlkalman_tpu_torch.core.engine import nlk_bases
    from bwd_nlkalman_tpu_torch.core.engine_cuda import dense_pass_cuda, pass_with_weights
    from bwd_nlkalman_tpu_torch.ops.bases import make_bases

    if not torch.cuda.is_available():
        raise SystemExit("k1_bench: no CUDA device")
    _build.library()
    rng = np.random.default_rng(0)
    cur, prev, valid, basic = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                               for a in nlk_inputs(rng, *FULL, channels))
    kb = make_bases(nlk_bases(8), "cuda")
    res = {}
    for name, args in pass_args(cur, prev, valid, basic, kb).items():
        fn = lambda: dense_pass_cuda(*args)  # noqa: E731
        res[name] = {"ms": cuda_ms(fn, REPS), "stages_ms": stage_ms(fn, 3),
                     "digest": digest(*pass_with_weights(*args))}
    res["bands"] = {"digest": digest(*(band_f32(x, 8, kb["dct_8"])
                                       for x in (cur, prev, basic)))}
    return {"root": os.path.relpath(root, ROOT) if root != ROOT else ".",
            "card": card(), "torch": torch.__version__, "channels": channels,
            "passes": res}


def digest(*tensors) -> str:
    """SHA-256 of the tensors' bytes, in turn."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def band_f32(img, psz, dmat):
    """K1's float32 DCT band of every psz x psz patch of ``img``, (H-psz+1,
    W-psz+1, C psz^2): its DCT stage, called through the C entry as the
    wrapper calls it; ``dmat`` the (psz, psz) DCT matrix on the card."""
    import ctypes

    import torch
    from bwd_nlkalman_tpu_torch._build import call, stream_ptr

    h, w, c = img.shape
    img = img.contiguous()
    out = torch.empty((h - psz + 1, w - psz + 1, c * psz * psz), dtype=torch.float32,
                      device=img.device)
    call("bnlk_nlk_dct", img.data_ptr(), None, dmat.data_ptr(), out.data_ptr(),
         None, h, w, c, psz, 0, ctypes.c_void_p(stream_ptr(img.device)))
    return out


@contextlib.contextmanager
def k1_bands():
    """Within the block the plain NLK pass takes K1's float32 DCT bands
    (:func:`band_f32`) in place of its own: where K1's DCT keeps fused
    multiply-adds (psz 8, 1-3 channels, float32) its bands differ from the
    plain ones in the last bits, so that, with :func:`k1_order`, the plain
    pass then selects what K1 selects at a tie. For float32 bands only
    (K1's bf16 bands are the plain ones rounded)."""
    from bwd_nlkalman_tpu_torch.core import engine
    from bwd_nlkalman_tpu_torch.ops.bases import basis
    from bwd_nlkalman_tpu_torch.ops.dct import _ortho_basis_np

    plain = engine.dct_image_all_patches
    engine.dct_image_all_patches = lambda img, psz: band_f32(
        img, psz, basis(None, ("dct", psz), _ortho_basis_np, img.device))
    try:
        yield
    finally:
        engine.dct_image_all_patches = plain


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another checkout's root, timed in turns")
    ap.add_argument("--channels", type=int, default=1, help="channels of the frames (1-7)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker:
        print(json.dumps(worker(os.path.abspath(a.worker), a.channels)), flush=True)
        return 0
    roots = [ROOT] if not a.against else [a.against, ROOT, ROOT, a.against]
    runs = []
    for r in roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                              os.path.abspath(r)]
                             + (["--channels", str(a.channels)] if a.channels != 1 else []),
                             capture_output=True, text=True)
        if out.returncode != 0:
            sys.stderr.write(out.stdout + out.stderr)
            return out.returncode
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    mean = {}
    for run in runs:
        m = mean.setdefault(run["root"], {})
        for name, p in run["passes"].items():
            if "ms" in p:
                m.setdefault(name, []).append(p["ms"])
    digests = {json.dumps({k: p["digest"] for k, p in run["passes"].items()})
               for run in runs}
    print(json.dumps({"card": runs[0]["card"], "mean_ms": {
        root: {k: sum(v) / len(v) for k, v in m.items()} for root, m in mean.items()},
        "digests_equal": len(digests) == 1}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
