#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Run from the repository root with ``python3 chip_smoke.py`` (no
arguments, one GPU). Phases, each reported on its own line:

1. device: fails unless CUDA is available; prints the card's name and
   power limit (nvidia-smi) and turns TF32 off for matmuls and convs;
2. build: compiles the hand-written kernels (K1 NLK pass, K2 TV-L1
   level, K3 TV-L1 tiled stage, K4 bicubic warp, P streaming-rate probe)
   from ``bwd_nlkalman_tpu_torch/csrc``, one nvcc per source, into
   ``build/torch_kernels/`` and prints the seconds it took and the kernel
   instances each source compiled (K1's patch sizes, chunk widths and band
   types);
3. parity: each kernel against its plain PyTorch version on the card, on
   the JAX suite's cases, at the edges of K1's site blocks (a ragged
   3-channel frame, the 961-offset window) and at the slices' shapes,
   with the tolerance stated beside it; then each kernel's time against
   its plain version's and the least time the card could take for the
   same work (its bound): each kernel's time as CUDA-event ms per call
   and as torch.profiler's device ms of every kernel the call launches,
   and K1's device time per stage; K2's and K3's levels must run as many
   iterations / blocks as their plain versions, and run with no host sync
   (torch's sync debug mode set to "error"); the counts are read once
   after; K4 at every channel instance of the main path, with a band of
   flow hundreds of pixels wide, timed along the flow the main path
   computes for the slices' scene with a smooth and a noisy flow beside
   it, its TV-L1 entry at 1080x1920 and, on a line of its own,
   ``grid_sample``'s bicubic as a yardstick; K4 at 4-21 channels (the
   generic instance, 9 for fsmo's warp of an RGB clip, and past 9 in
   channel groups: 10-14 the filter's and fsmo's warps of 4-7-channel
   clips) at those sizes, and at 9, 10, 12 and 14 at 1080p along the main
   path's flow, each timed against its bound; K1 at sigma 10 and 40,
   gray and RGB, at 270x480; K1 widened: at
   psz 2, 4, 6, 10, 12 and 16 with 1, 3, 4 and 7 channels at 48x64 (the
   four kinds of pass in turn), at psz 4 and 12 gray and psz 8 with 4
   channels at 270x480, each with float32 and with bf16 bands against the
   plain pass with the same bands, and the slice's three passes in bf16 at
   270x480; then K1 at 1080p gray, flt1 and smo1, at psz 4, 8 and 16 in
   float32 and psz 8 in bf16: event ms, device ms, each stage's device ms
   and the bound, beside the bound with the bands' own traffic; K2 with
   bfloat16 duals (``state_dtype="bfloat16"``) against its plain version
   with the same duals, on the 25x41 cases and the 540x960 level (as many
   iterations, K2's level bars, the same bits expected: that rule rounds
   every operation as the plain version does), its EPE against the
   float32 level, timed in turns with the float32 level, with the bound
   and the bound with the state through device memory (duals at 2 B);
   G, the flow's blur and zooms, at the 1080p pyramid's shapes (the
   pair's blur, every zoom-out of the pair, every zoom-in of a flow,
   planes last and times 2) against the dense products
   (``engine="plain"``) on the same inputs: one launch a call, every
   output within ``G_GAP_SHARE`` of the rounding bound of any order; the
   blur, the level-0 zoom-out and the 1 -> 0 flow zoom-in timed beside
   the dense products and the bound from bytes; G's counter over the
   benchmark cells' path (cold flow at fscale 1): 15 a flow, alone and in
   a 3-frame request;
4. slice 1: ``NLKalmanDenoiser`` on 4 frames of 1080p gray at sigma=20
   with warm-started half-resolution flow; outputs must be finite and
   denoise, and K1, K2, K4 and G must have launched during that run;
   then one more run under torch.profiler: device busy time, idle share,
   the five kernels that take the most device time, and each of K1-K4's
   and G's device time and kernel count;
4b. slice 1 on the same frames with bf16 bands (``window_dtype``), with
   bf16 duals in K2 (``FlowConfig(state_dtype="bfloat16")``) and with
   both: flt2 and smo1 within 0.05 dB of the float32 run, K1's launches as
   many, none on the plain route; frames/s beside the float32 run's,
   profiled;
5. slice 2: ``NLKalmanDenoiser`` with full-resolution flow (fscale=0) on
   3 frames of 1080p gray; the 1080x1920 flow level runs K3, so K1, K2,
   K3 and K4 must all have launched, and G 15 times a flow; then a
   profiled run as in phase 4;
6. ``python -m bwd_nlkalman_tpu_torch.cli.tvl1flow`` (run in this
   process) on one 1080p PNG pair at its default fscale=0: the .flo must
   read back finite and K3 must have launched;
7. the probe's entry point (``main`` of
   ``bwd_nlkalman_tpu_torch.tools.vpu_probe``, what ``python -m`` runs):
   P's FMA rates against the published peaks;
8. slice against plain: at 128x160, 3 frames, kernels and plain versions
   must give flt2 and smo1 PSNR within 0.05 dB of each other; so must
   fsmo and lsmo (RGB), streaming fsmo (RGB) and both multiscale
   pyramids (2 levels) on every output; ``get_model`` runs each of its
   six variants to finite frames;
9. streaming fsmo: ``run_streaming`` over 4 frames of 1080p RGB at
   sigma=20 with warm-started flow, checkpoints every 2 frames written
   in the background; a second run stopped after frame 1 and resumed
   from its checkpoint must give frames 2-3 as the first run did (max
   abs diff <= 1e-4); K1, K2, K4 and K4's 9-channel warp must have
   launched; frames/s and a profiled run;
10. ``python -m bwd_nlkalman_tpu_torch.cli.nlkalman_seq --smoother lsmo``
   (run in this process) on 3 frames of 1080p gray PNGs in ground-truth
   mode: the measures file, smo1 >= flt2 - 0.3 dB, K1, K2 and K4;
11. multiscale: ``MultiscaleDenoiser`` with the DCT and the Lanczos-3
   pyramid, each on 3 frames of 1080p gray at sigma=20 with the
   automatic 3 levels: finite, smo1 >= noisy + 6 dB, K1 launched on
   every level; frames/s and a profiled run;
12. the per-frame commands in this process on 1080p RGB PNGs:
   ``tvl1flow`` (backward and forward flows, occlusion masks written
   beside them), ``nlkalman-flt`` (frame 0, then frame 1's two passes
   along the backward flow) and ``nlkalman-smo``: finite, flt21 at least
   6 dB above the noisy frame, K1 3 launches, K4 (C=3) 3, no plain-route
   pass; ``--f1_p 7 --f2_p 0`` on a 270x480 crop takes the plain route
   with its warning (K1 0, one plain pass); ``--f1_p 4`` at 1080p runs K1;
   ``awgn``, ``psnr``, ``decompose`` and ``recompose`` once each;
13. the parameter-search harness at the training protocol's size: 2 gray
   clips of 400x400, 20 frames, sigma=20 (PSNR from frame 11, a 10-pixel
   border): K1 at the searches' extreme parameters (npx 1 and 98, nagg 20,
   group sizes above the window's candidates) against its plain pass by
   share and mean error; ``cached_fixtures`` (K2 only; read back from the
   cache with no launch); the default trial on the fixtures, without and
   with smoothing, timed, and on one clip within 0.05 dB of the plain
   versions; ``random_search`` (4 trials) on the fixtures; one
   ``respect_lambda`` trial on the plain route with its warning;
   ``line_search``, ``coordinate_descent``, ``gradient_descent`` and
   ``grid_search_2d`` without fixtures, timed; a profiled trial with and
   one without fixtures; every K1, K2 and K4 count equal to its formula
   and K3 none; ``view_results`` on the table the searches wrote (each row
   one trial that ran) and ``plambda`` (``-c`` on a trial's MSE, and on
   two 400x400 PNGs);
14. the row-sharded passes (``bwd_nlkalman_tpu_torch.parallel``) on one
   card: K1 with ``site_rows`` / ``qy_bounds`` / ``return_accum`` on every
   shard of sp=2 and sp=4 at 272x480, gray and RGB, f32 and bf16 bands,
   flt2 and smo1, against the plain pass at K1's bars (elementwise where
   the plain pass takes K1's bands; by share and mean error with its own),
   and the folded shards against K1's whole-frame pass (rtol 1e-4, atol
   2e-3); the
   sharded 1080p gray flt1 and smo1 passes at sp 1, 2 and 3 on
   ``[cuda:0] * sp``: ms per pass beside the whole-frame pass, the
   difference from it, K1 launches = sp; the row-sharded 1080p gray flow
   (``parallel/flow.py``) at sp 1-4 on ``[cuda:0] * sp``, slice 1's warm
   fscale=1 step and slice 2's cold fscale=0 flow, against the whole-frame
   flow: mean EPE <= 1e-4 px and max abs <= 1e-2, the iteration (K2) and
   block (K3) counts of both, the levels run whole, K2 and K4 launches
   equal to their formulas, the occlusion masks of both flows differing at
   no more than 1e-4 of the pixels, K4's shard warps against the
   whole-frame warp (atol 1e-3, the same masks), and ms per flow, sharded
   against whole; slice 1's warm step with bf16 duals at sp 2, the same
   bits as the whole-frame bf16 step; the shard forms against their plain
   versions on every shard of sp 2-4 (K2's round in float32 and with bf16
   duals, K3's, K4's TV-L1 entry and shard warp, the warp at C=2 and
   C=12);
   ``denoise_sequence_sharded`` on slice 1's clip and flow at sp 2 and 3,
   the flow sharded too: frames/s, flt2 and smo1 within
   0.05 dB of slice 1, K1 = 11 sp, K2 = the levels run whole + sp x the
   rounds issued, K3 = 0, K4 = sp x (6 warps + the warm gates + the warp
   stages of the sharded levels), the levels run whole, profiled with its
   idle share (and across cards where more than one is visible; else it
   says that scaling was not measured); ``denoise_batch`` over dp=2
   against the unsharded batch; ``dryrun_multichip(4)``;
15. the native io library (``bwd_nlkalman_tpu_torch/native``): built
   from the checkout with g++, its build seconds and the codecs compiled
   in (a codec whose header the compiler does not find is left out and
   named; a source that fails to compile with its headers there fails the
   run); 1080p RGB round trips of every format it has (PNG 8/16-bit, TIFF,
   PFM, FLO, JPEG) against the pure-numpy codecs, identical arrays (JPEG
   against its own decode), ms per frame native and pure; ``FrameLoader``
   over 8 frames of 1080p (PNG where built, else PFM), frames/s against a
   loop of ``read_image``; ``nlkalman-seq`` on JPEG frames where libjpeg
   is built in;
16. clips of 4-7 channels, whose stacked priors K4 warps in channel
   groups: ``nlkalman-seq --smoother fsmo`` (``main``, in this process)
   on 3 frames of 1080p RGBA PNGs in ground-truth mode (K1 on every pass
   at 4 channels, none on the plain route; one 12-channel warp a frame),
   profiled (idle share, K1/K2/K4 device time); ``run_streaming`` with
   fsmo on a 1080p 4-channel clip against ``fsmo_sequence`` on the same
   frames, within 0.05 dB; ``filter_sequence`` + ``smooth_sequence`` on
   a 1080p 5-channel clip of 3 frames (warps of 10 and 5 channels), timed
   by ``utils.StageTimer`` (its report printed), frames/s and a profiled
   run (idle share, K1's device time a pass, K4's), then
   ``denoise_sequence_sharded`` on it at sp=2 against the unsharded
   outputs within 0.05 dB; a 270x480 7-channel clip (a 14-channel warp)
   through the kernels against the plain versions, every output within
   0.05 dB; K1's 1080p passes at 4 and 5 channels (the first frame's
   flt1, flt1, flt2, smo1) against the plain pass in K1's order on K1's
   bands by phase 3's 1080p rule and against the plain pass's own by
   phase 14's rule for that comparison, flt1 and smo1 timed
   (event, device and plain ms, each kernel's device ms) against their
   bounds.

Every phase prints its seconds. Every launch counter is set to 0 just
before each of the paths 4-7, 9-13, 14's sharded flows and sharded
sequence, 15's command and 16's runs and read just after. The
second-to-last line is a JSON object with one entry
per kernel (K1's with a ``variants`` list: each widened case held, with
its max abs error; K2's: each bf16-dual case, with the 540x960 level's
times and bounds); the last line is ``{"ok": true, "device": {...}}``. Any
failure raises and the script exits non-zero without that line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
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
K3_LEVEL_MAX = 1e-2     # 1080x1920 level, max abs error (2.4e-3 measured)
K3_LEVEL_EPE = 1e-4     # 1080x1920 level, mean end-point error (1.2e-5 measured)
G_GAP_SHARE = 0.5       # G against the dense products, as a share of the any-order
                        # rounding bound of each output (0.09-0.25 measured)
HERE = os.path.dirname(os.path.abspath(__file__))

# the card's published peaks (NVIDIA H100 SXM data sheet; at 700 W)
HBM_BYTES_S = 3.35e12   # device memory
F32_FLOPS_S = 67e12     # float32 outside the tensor cores
# FLOPs per pixel, counted from the kernels' arithmetic (an FMA is 2)
K2_FLOPS_ITER = 49      # one K2 iteration (K2Rule of csrc/tvl1_tile.cuh)
K2_FLOPS_WARP = 280     # one K2 warp stage: 3-channel bicubic + constants
K3_FLOPS_ITER = 50      # one K3 iteration (K3Rule of csrc/tvl1_tile.cuh)
K4_FLOPS_CH = 96        # one K4 channel: 5 Catmull-Rom cubics + coordinates


def log(msg: str) -> None:
    print(msg, flush=True)


def make_clip(h, w, frames, sigma, seed=0, channels=1):
    """Structured translating scene + AWGN (bench.py:make_content's scene,
    same draws; one field per channel): (clean, noisy) as (T, H, W, C)
    float32."""
    rng = np.random.default_rng(seed)
    fields = []
    for _ in range(channels):
        base = np.cumsum(np.cumsum(rng.standard_normal((h + 8, w + 8)), axis=0), axis=1)
        fields.append((base - base.min()) / (base.max() - base.min()) * 175 + 40)
    base = np.stack(fields, -1).astype(np.float32)
    clean = np.stack([base[i % 8: i % 8 + h, i % 8: i % 8 + w] for i in range(frames)])
    noisy = clean + sigma * rng.standard_normal(clean.shape).astype(np.float32)
    return clean, noisy


def psnr(clean, x) -> float:
    import torch

    d = x.double() - clean.double()
    return float(10 * torch.log10(255.0 ** 2 / torch.mean(d * d)))


def timed_pair(kernel_fn, plain_fn, reps_k, reps_p):
    """Kernel and plain times in turns (plain, kernel, kernel, plain)."""
    from bwd_nlkalman_tpu_torch.tools.k1_bench import cuda_ms

    p1 = cuda_ms(plain_fn, reps_p)
    k1 = cuda_ms(kernel_fn, reps_k)
    k2 = cuda_ms(kernel_fn, reps_k)
    p2 = cuda_ms(plain_fn, reps_p)
    return (k1 + k2) / 2, (p1 + p2) / 2


def device_ms(fn, reps):
    """torch.profiler's device ms per call of every kernel ``fn`` launches;
    None where the profiler saw no device time."""
    from bwd_nlkalman_tpu_torch.tools.warp_bench import per_call

    return per_call(fn, reps)[2]


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def check(ok, msg: str) -> None:
    """Fail the run unless ``ok`` (an ``assert`` would vanish under -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def no_host_sync(fn):
    """fn() with torch's sync debug mode at "error": a host sync inside
    raises. The kernels' C entries read nothing back by construction."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def assert_close(name, got, want, rtol, atol):
    import torch

    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{name}: {m}")


def bound(flops: float, nbytes: float, peak: float = F32_FLOPS_S):
    """(ms, what binds): the least time the card could take for work of
    ``flops`` operations moving ``nbytes`` bytes (each input read once,
    each output written once)."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k1_work(cur, prev_valid, p, mode, has_prev, has_basic, window_dtype="float32",
            site_rows=None, qy_bounds=None):
    """(FLOPs, bytes, band bytes) of one NLK pass on these inputs: the
    separable psz x psz DCT of each band (4 psz^3 FLOPs a patch), the
    distances of every site's candidates (sites every psz/2; within the
    temporal radius where the site's previous patch is valid, as the pass
    restricts them; a shard's own sites with candidates in its patch-row
    bounds, ``site_rows`` and ``qy_bounds`` as the pass takes them), the
    separable inverse DCT and the window fold. The
    group statistics and gains, which depend on the selection, are not
    counted, so this is a lower bound of the work. The bytes are the
    function's own (the frames read once, the output written once); the
    band bytes add each DCT band written once and read once at its type's
    size (4 or 2 B a value), the traffic K1's design keeps in device
    memory."""
    import torch
    from bwd_nlkalman_tpu_torch.core.engine import patch_validity
    from bwd_nlkalman_tpu_torch.core.engine_cuda import pass_radius, site_range

    h, w, c = cur.shape
    psz, step = p.patch_sz, p.patch_sz // 2
    hh, ww, f = h - psz + 1, w - psz + 1, psz * psz * c
    rad = pass_radius(p, mode)
    r0, r1, qlo, qhi = site_range(h, psz, site_rows, qy_bounds)
    py = step * torch.arange(r0, r1, device=cur.device)
    px = torch.arange(0, ww, step, device=cur.device)

    def cands(r):
        span = lambda q, lo, hi: (torch.clamp(q - lo, max=r) + torch.clamp(hi - 1 - q, max=r)
                                  + 1)
        return span(py, qlo, qhi)[:, None] * span(px, 0, ww)[None, :]

    n_cand = cands(rad)
    if mode == "filter" and has_prev:
        n_cand = torch.where(patch_validity(prev_valid, psz)[step * r0:step * r1:step, ::step],
                             cands(p.search_sz_t), n_cand)
    n_bands = 1 + int(has_basic) + int(has_prev)
    flops = (n_bands + 1) * hh * ww * c * 4 * psz ** 3 + int(n_cand.sum()) * f * 3 \
        + h * w * c * psz * psz * 2
    nbytes = h * w * (4 * c * (2 + int(has_basic) + int(has_prev)) + int(has_prev))
    band = 2 if window_dtype == "bfloat16" else 4
    return flops, nbytes, nbytes + 2 * n_bands * hh * ww * f * band


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
    # kernel instances each source compiled, from its ptxas report
    counts = {p.name[:-4]: p.read_text().count("Compiling entry function")
              for p in sorted(lib.parent.glob("*.cu.log"))}
    log("[2 build] kernel instances by source: " + ", ".join(
        f"{k} {v}" for k, v in counts.items()) + f"; K1 (nlk_pass*) "
        f"{sum(v for k, v in counts.items() if k.startswith('nlk_pass'))}")
    torch.cuda.synchronize()


PARITY = {}     # kernel id -> largest abs error over its checked cases
TIMES = {}      # kernel id -> (kernel event ms, plain event ms, kernel device ms)
BOUNDS = {}     # kernel id -> (least ms, "bytes" or "operations") of the timed call


def phase_k1(smi):
    import torch
    from bwd_nlkalman_tpu_torch.core.engine import dense_pass_v2, nlk_bases
    from bwd_nlkalman_tpu_torch.core.engine_cuda import (dense_pass_cuda, pass_radius,
                                                         pass_with_weights)
    from bwd_nlkalman_tpu_torch.ops.bases import make_bases
    from bwd_nlkalman_tpu_torch.params import FilterMode, NLKParams, default_params
    from bwd_nlkalman_tpu_torch.tools.k1_bench import nlk_inputs, pass_args, stage_ms

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
    # the edges of the site blocks, drawn from their own generator so that
    # the 1080p inputs below stay those of earlier runs: a ragged frame
    # (hh - 1 no multiple of 4, a partial last run of sites) at 3 channels,
    # and the largest window K1 takes (rad 15, 961 offsets)
    edges = [
        ("filter", True, False, default_params(SIGMA, FilterMode.FLT1), 3, 37, 53),
        ("filter", True, False, NLKParams(patch_sz=8, search_sz_x=15, search_sz_t=5,
                                          npatches_x=50, npatches_t=30, npatches_tagg=20,
                                          dista_lambda=1.0, beta_x=3.1, beta_t=1.95),
         1, 64, 96),
    ]
    rng, rng_edges = np.random.default_rng(0), np.random.default_rng(1)
    kb = make_bases(nlk_bases(8), "cuda")
    worst = 0.0
    for i, (mode, has_prev, has_basic, p, ch, h, w) in enumerate(cases + edges):
        cur, prev, valid, basic = (
            torch.from_numpy(np.ascontiguousarray(a)).cuda()
            for a in nlk_inputs(rng if i < len(cases) else rng_edges, h, w, ch))
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
            f"rad={pass_radius(p, mode)} "
            f"{h}x{w}: max abs err {err:.3e} (rtol 1e-3, atol 5e-2)")
        assert_close("K1", got, want, rtol=1e-3, atol=5e-2)
    # other noise levels than the slices' (the multiscale levels' sigma/2
    # and sigma/4 are below 20; at 40 the smoother keeps 105 of its radius-5
    # window's 121 candidates), gray and RGB, each of the three passes, at
    # the bars of the 270x480 cases above; from their own generator too
    rng_sigma = np.random.default_rng(2)
    for sigma, ch, (mode, fm, has_basic) in itertools.product(
            (10.0, 40.0), (1, 3), (("filter", FilterMode.FLT1, False),
                                   ("filter", FilterMode.FLT2, True),
                                   ("smooth", FilterMode.SMO1, False))):
        cur, prev, valid, basic = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                                   for a in nlk_inputs(rng_sigma, *MID, ch, sigma))
        p = default_params(sigma, fm)
        args = (cur, prev, valid, basic if has_basic else cur, sigma, p, mode, True,
                has_basic, kb)
        got = dense_pass_cuda(*args)
        want = dense_pass_v2(*args)
        torch.cuda.synchronize()
        err = max_err(got, want)
        worst = max(worst, err)
        log(f"[3 parity] K1 {mode} {fm.value} sigma={sigma:g} ch={ch} "
            f"npatches_t={p.npatches_t} {MID[0]}x{MID[1]}: max abs err {err:.3e} "
            "(rtol 1e-3, atol 5e-2)")
        assert_close("K1", got, want, rtol=1e-3, atol=5e-2)
    PARITY["K1"] = worst

    # the slice's own passes at 1080p gray, held to the bar by share: where
    # a distance summed in another order falls on the other side of a
    # selection threshold, a patch group changes and single pixels move
    # past it (on an H100 80GB HBM3 at 700 W: 27 of 2,073,600 pixels on a
    # first frame, 10 with a previous frame); a grid or indexing fault moves
    # far more
    cur, prev, valid, basic = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                               for a in nlk_inputs(rng, *FULL, 1))
    for name, args in pass_args(cur, prev, valid, basic, kb).items():
        mode, has_prev, has_basic = args[6:9]
        if name in ("flt1", "smo1"):
            k_ms, p_ms = timed_pair(lambda: dense_pass_cuda(*args),
                                    lambda: dense_pass_v2(*args), 5, 1)
            d_ms = device_ms(lambda: dense_pass_cuda(*args), 3)
            b_ms, b_by = bound(*k1_work(cur, valid, args[5], mode, has_prev, has_basic)[:2])
            log(f"[3 time] K1 {mode} 1080p gray: kernel {k_ms:.2f} ms between events, "
                f"device {fmt_ms(d_ms)}, plain {p_ms:.2f} ms, bound {b_ms:.3f} ms ({b_by}) "
                f"({smi})")
            st = stage_ms(lambda: dense_pass_cuda(*args), 3)
            log(f"[3 stages] K1 {name} 1080p gray, device ms per pass by kernel "
                "(torch.profiler, 3 passes): " + (
                    ", ".join(f"{k} {v:.3f}" for k, v in st.items()) if st
                    else "not measured") + f" ({smi})")
            if mode == "filter":
                TIMES["K1"] = (k_ms, p_ms, d_ms)
                BOUNDS["K1"] = (b_ms, b_by)
        got, wq = pass_with_weights(*args)
        want = dense_pass_v2(*args)
        diff = (got - want).abs()
        share = float(((diff > 5e-2 + 1e-3 * want.abs()).sum())) / want.numel()
        mean = float(diff.mean())
        log(f"[3 parity] K1 {name} 1080p gray: max abs err {float(diff.max()):.3e}, "
            f"mean abs err {mean:.3e} (<= {K1_FULL_MEAN:g}), share beyond rtol 1e-3 "
            f"/ atol 5e-2 {share:.2e} (<= {K1_FULL_SHARE:g}); patch positions "
            f"chosen by a site {float((wq != 0).float().mean()):.4f}")
        check(share <= K1_FULL_SHARE, f"K1 {name} 1080p: {share} of pixels beyond the bar")
        check(mean <= K1_FULL_MEAN, f"K1 {name} 1080p: mean abs err {mean}")
        del got, want, diff, args, wq
        torch.cuda.empty_cache()


K1_VARIANTS = []    # K1's widened cases held against plain: psz, c, dtype, max abs err


def phase_k1_widened(smi):
    """K1 over the patch sizes and channel counts beyond psz 8 and 1-3
    channels, and its bf16 window path, each against the plain pass with
    the same bands, at phase 3's K1 bars; then timed at 1080p gray."""
    import torch
    from bwd_nlkalman_tpu_torch.core.engine import dense_pass_v2, nlk_bases
    from bwd_nlkalman_tpu_torch.core.engine_cuda import dense_pass_cuda, pass_radius
    from bwd_nlkalman_tpu_torch.ops.bases import make_bases
    from bwd_nlkalman_tpu_torch.params import FilterMode, default_params
    from bwd_nlkalman_tpu_torch.tools.k1_bench import (cuda_ms, fitted_params, k1_order,
                                                       nlk_inputs, pass_args, stage_ms,
                                                       widened_cases)

    def held(tag, args, wdt, h, w):
        """K1 against the plain pass at K1's bar (rtol 1e-3, atol 5e-2). At
        270x480 the plain pass sums its distances in K1's order
        (``k1_order``): there, with as many sites as a 540x960 frame has at
        psz 8, a distance summed in another order flips a selection tie
        (at psz 4 gray, 9 of 129,600 values past the bar, max 0.153, which
        the plain pass in K1's order reproduces on the CPU); the plain pass
        as it is is printed beside it."""
        psz, c = args[5].patch_sz, args[0].shape[2]
        got = dense_pass_cuda(*args, window_dtype=wdt)
        want = dense_pass_v2(*args, window_dtype=wdt)
        name = f"K1 psz={psz} c={c} {wdt} {h}x{w}"
        head = (f"[3 parity] K1 psz={psz} ch={c} {tag} rad={pass_radius(args[5], args[6])} "
                f"{wdt} {h}x{w}: max abs err")
        if (h, w) == (48, 64):
            err = max_err(got, want)
            log(f"{head} {err:.3e} (rtol 1e-3, atol 5e-2)")
        else:
            diff = (got - want).abs()
            share = float((diff > 5e-2 + 1e-3 * want.abs()).sum()) / want.numel()
            with k1_order():
                want = dense_pass_v2(*args, window_dtype=wdt)
            err = max_err(got, want)
            log(f"{head} {err:.3e} against the plain pass in K1's distance order (rtol "
                f"1e-3, atol 5e-2); against the plain pass as it is {float(diff.max()):.3e}, "
                f"share beyond the bar {share:.2e}")
        K1_VARIANTS.append({"psz": psz, "c": c, "mode": tag, "window_dtype": wdt,
                            "size": f"{h}x{w}", "max_abs_err": err})
        assert_close(name, got, want, rtol=1e-3, atol=5e-2)

    rng = np.random.default_rng(4)
    bases = {}
    for wdt in ("float32", "bfloat16"):
        for psz, c, mode, has_prev, has_basic, p in widened_cases((2, 4, 6, 10, 12, 16),
                                                                  (1, 3, 4, 7)):
            cur, prev, valid, basic = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                                       for a in nlk_inputs(rng, 48, 64, c))
            if not has_prev:
                prev, valid = torch.zeros_like(cur), torch.zeros_like(valid)
            kb = bases.setdefault(psz, make_bases(nlk_bases(psz), "cuda"))
            tag = f"{mode} prev={has_prev} basic={has_basic}"
            held(tag, (cur, prev, valid, basic if has_basic else cur, SIGMA, p, mode,
                       has_prev, has_basic, kb), wdt, 48, 64)
    # quarter size: psz 4 and 12 gray, psz 8 at 4 channels, and the slice's
    # three passes in bf16 (their float32 cases are phase 3's)
    mids = [(4, 1, "flt1"), (12, 1, "flt1"), (8, 4, "flt1")]
    for wdt in ("float32", "bfloat16"):
        for psz, c, name in mids + ([(8, 1, n) for n in ("flt1", "flt2", "smo1")]
                                     if wdt == "bfloat16" else []):
            fm = FilterMode(name)
            mode = "smooth" if name == "smo1" else "filter"
            has_basic = name == "flt2"
            p = fitted_params(dataclasses.replace(default_params(SIGMA, fm), patch_sz=psz),
                              c, mode)
            cur, prev, valid, basic = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                                       for a in nlk_inputs(rng, *MID, c))
            kb = bases.setdefault(psz, make_bases(nlk_bases(psz), "cuda"))
            held(f"{name} prev=True basic={has_basic}",
                 (cur, prev, valid, basic if has_basic else cur, SIGMA, p, mode, True,
                  has_basic, kb), wdt, *MID)
    PARITY["K1"] = max([PARITY["K1"]] + [v["max_abs_err"] for v in K1_VARIANTS])

    # 1080p gray, flt1 and smo1: psz 4, 8 and 16 in float32, psz 8 in bf16
    cur, prev, valid, basic = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                               for a in nlk_inputs(np.random.default_rng(0), *FULL, 1))
    for psz, wdt in ((8, "float32"), (8, "bfloat16"), (4, "float32"), (16, "float32")):
        kb = bases.setdefault(psz, make_bases(nlk_bases(psz), "cuda"))
        for name, args in pass_args(cur, prev, valid, basic, kb).items():
            if name not in ("flt1", "smo1"):
                continue
            mode, has_prev, has_basic = args[6:9]
            p = dataclasses.replace(args[5], patch_sz=psz)
            args = args[:5] + (p,) + args[6:]
            run = lambda: dense_pass_cuda(*args, window_dtype=wdt)  # noqa: E731
            k_ms = cuda_ms(run, 5)
            d_ms = device_ms(run, 3)
            st = stage_ms(run, 3)
            flops, nbytes, band_bytes = k1_work(cur, valid, p, mode, has_prev, has_basic, wdt)
            b_ms, b_by = bound(flops, nbytes)
            bb_ms, bb_by = bound(flops, band_bytes)
            log(f"[3 time] K1 {name} psz={psz} {wdt} 1080p gray: kernel {k_ms:.3f} ms between "
                f"events, device {fmt_ms(d_ms)}; stages " + (
                    ", ".join(f"{k} {v:.3f}" for k, v in st.items()) if st
                    else "not measured") + f"; bound {b_ms:.3f} ms ({b_by}), with the "
                f"bands in device memory {bb_ms:.3f} ms ({bb_by}) ({smi})")
            torch.cuda.empty_cache()


def small_level():
    """The JAX suite's 25x41 level (tests/test_round3.py:26-60) on the card:
    i0, i1 and a zero flow."""
    import torch

    rng = np.random.default_rng(7)
    h, w = 25, 41
    base = np.cumsum(np.cumsum(rng.normal(size=(h + 8, w + 8)), 0), 1)
    base = ((base - base.min()) / (base.max() - base.min()) * 255).astype(np.float32)
    i0 = torch.from_numpy(np.ascontiguousarray(base[4:4 + h, 4:4 + w])).cuda()
    i1 = torch.from_numpy(np.ascontiguousarray(base[2:2 + h, 5:5 + w])).cuda()
    return i0, i1, i0.new_zeros((h, w, 2))


def half_level():
    """The slice's finest solved level, 540x960 from a 1080p pair of
    make_clip, prepared as the flow prepares it: i0, i1 and a zero flow."""
    import torch
    from bwd_nlkalman_tpu_torch.flow import tvl1

    _, noisy = make_clip(*FULL, 2, SIGMA)
    nz = torch.from_numpy(noisy).cuda()
    a, b = tvl1._prep_pair(nz[1, ..., 0], nz[0, ..., 0])
    a, b = tvl1.zoom_out(a, 0.5), tvl1.zoom_out(b, 0.5)
    return a, b, a.new_zeros(a.shape + (2,))


def phase_k2(smi):
    import torch
    from bwd_nlkalman_tpu_torch.flow import tvl1_fused
    from bwd_nlkalman_tpu_torch.flow.tvl1_cuda import ITERATIONS, tvl1_level_cuda
    from bwd_nlkalman_tpu_torch.flow.tvl1_fused import tvl1_level_plain

    h, w = 25, 41
    i0, i1, u0 = small_level()
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
    a, b, u0 = half_level()
    kw = dict(lambda_=0.25, nwarps=5, k_check=8, max_iters=300)
    k_ms, p_ms = timed_pair(lambda: tvl1_level_cuda(a, b, u0, **kw),
                            lambda: tvl1_level_plain(a, b, u0, **kw), 3, 1)
    d_ms = device_ms(lambda: tvl1_level_cuda(a, b, u0, **kw), 3)
    ITERATIONS.reset()
    got = no_host_sync(lambda: tvl1_level_cuda(a, b, u0, **kw))
    iters = ITERATIONS.count          # the one host read of the level
    plain_iters = []
    one_iter = tvl1_fused._one_iter
    tvl1_fused._one_iter = lambda *args: plain_iters.append(1) or one_iter(*args)
    try:
        want = tvl1_level_plain(a, b, u0, **kw)
    finally:
        tvl1_fused._one_iter = one_iter
    epe = float(torch.linalg.vector_norm(got - want, dim=-1).mean())
    err = max_err(got, want)
    npx = a.numel()
    b_ms, b_by = bound(iters * npx * K2_FLOPS_ITER + 5 * npx * K2_FLOPS_WARP, 24 * npx)
    BOUNDS["K2"] = (b_ms, b_by)
    log(f"[3 time] K2 level {a.shape[0]}x{a.shape[1]} nwarps=5: kernel "
        f"{k_ms:.2f} ms between events, device {fmt_ms(d_ms)}, plain {p_ms:.2f} ms, "
        f"bound {b_ms:.3f} ms ({b_by}; {iters} iterations) ({smi})")
    log(f"[3 counts] K2 level {a.shape[0]}x{a.shape[1]}: iterations kernel {iters}, "
        f"plain {len(plain_iters)}; host reads in the level 0 (sync debug mode "
        f"'error'), after it 1 (the iteration counter)")
    check(iters == len(plain_iters), "K2 540x960 level iteration count differs from plain")
    log(f"[3 parity] K2 level {a.shape[0]}x{a.shape[1]} nwarps=5: max abs err "
        f"{err:.3e} (<= {K2_LEVEL_MAX:g}), mean EPE {epe:.2e} px (<= {K2_LEVEL_EPE:g})")
    check(err <= K2_LEVEL_MAX, f"K2 540x960 level max abs err {err}")
    check(epe <= K2_LEVEL_EPE, f"K2 540x960 level mean EPE {epe} px")
    TIMES["K2"] = (k_ms, p_ms, d_ms)


K2_VARIANTS = []    # K2 with bfloat16 duals, each case held against plain


def phase_k2_bf16(smi):
    """K2 with bfloat16 dual planes (``state_dtype="bfloat16"``) against its
    plain version with the same duals: the 25x41 pair at rounds of one
    iteration (2 and 3; u depends on the rounded duals from the second on)
    and at nwarps=2, k_check=8, max_iters=32, at the bars of
    tests/test_torch_tvl1_state_dtype.py's short cases and the JAX suite's
    (1e-5, 5e-4, 2e-3); then the 540x960 level: as many iterations as
    plain, max abs <= K2_LEVEL_MAX and mean EPE <= K2_LEVEL_EPE (the
    float32 level's bars), no host sync; its EPE against the float32
    level; event ms, device ms, plain ms and the bound (the duals never
    leave the kernel, so their type does not enter it)."""
    import torch
    from bwd_nlkalman_tpu_torch.flow import tvl1_fused
    from bwd_nlkalman_tpu_torch.flow.tvl1_cuda import ITERATIONS, tvl1_level_cuda
    from bwd_nlkalman_tpu_torch.flow.tvl1_fused import tvl1_level_plain
    from bwd_nlkalman_tpu_torch.tools.k1_bench import cuda_ms

    sd = dict(state_dtype="bfloat16")
    h, w = 25, 41
    i0, i1, u0 = small_level()
    for nwarps, k_check, max_iters, atol in ((1, 1, 2, 1e-5), (1, 1, 3, 5e-4),
                                             (2, 8, 32, 2e-3)):
        kw = dict(nwarps=nwarps, k_check=k_check, max_iters=max_iters, **sd)
        got = tvl1_level_cuda(i0, i1, u0, **kw)
        want = tvl1_level_plain(i0, i1, u0, **kw)
        err = max_err(got, want)
        case = f"{h}x{w} nwarps={nwarps} k_check={k_check} max_iters={max_iters}"
        K2_VARIANTS.append({"case": case, "state_dtype": "bfloat16", "max_abs_err": err})
        log(f"[3 parity] K2 bf16 duals {case}: max abs err {err:.3e} (atol {atol:g}), "
            f"same bits {bool(torch.equal(got, want))}")
        assert_close("K2 bf16", got, want, rtol=0.0, atol=atol)

    a, b, u0 = half_level()
    kw = dict(lambda_=0.25, nwarps=5, k_check=8, max_iters=300)
    # bf16 and float32 in turns (float32, bf16, bf16, float32), then plain
    k_ms, f_ms = timed_pair(lambda: tvl1_level_cuda(a, b, u0, **kw, **sd),
                            lambda: tvl1_level_cuda(a, b, u0, **kw), 3, 3)
    p_ms = cuda_ms(lambda: tvl1_level_plain(a, b, u0, **kw, **sd), 1)
    d_ms = device_ms(lambda: tvl1_level_cuda(a, b, u0, **kw, **sd), 3)
    ITERATIONS.reset()
    got = no_host_sync(lambda: tvl1_level_cuda(a, b, u0, **kw, **sd))
    iters = ITERATIONS.count
    plain_iters = []
    one_iter = tvl1_fused._one_iter
    tvl1_fused._one_iter = lambda *args: plain_iters.append(1) or one_iter(*args)
    try:
        want = tvl1_level_plain(a, b, u0, **kw, **sd)
    finally:
        tvl1_fused._one_iter = one_iter
    f32 = tvl1_level_cuda(a, b, u0, **kw)
    epe = float(torch.linalg.vector_norm(got - want, dim=-1).mean())
    err = max_err(got, want)
    epe32 = float(torch.linalg.vector_norm(got - f32, dim=-1).mean())
    npx = a.numel()
    b_ms, b_by = bound(iters * npx * K2_FLOPS_ITER + 5 * npx * K2_FLOPS_WARP, 24 * npx)
    case = f"level {a.shape[0]}x{a.shape[1]} nwarps=5"
    K2_VARIANTS.append({"case": case, "state_dtype": "bfloat16", "max_abs_err": err,
                        "mean_epe": epe, "iterations": iters, "ms": k_ms, "device_ms": d_ms,
                        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "float32_ms": f_ms})
    log(f"[3 time] K2 bf16 duals {case}: kernel {k_ms:.3f} ms between events (float32 "
        f"{f_ms:.3f} ms in the same turns), device {fmt_ms(d_ms)}, plain {p_ms:.2f} ms, "
        f"bound {b_ms:.3f} ms ({b_by}; {iters} iterations) ({smi})")
    log(f"[3 counts] K2 bf16 duals {case}: iterations kernel {iters}, plain "
        f"{len(plain_iters)}; host reads in the level 0 (sync debug mode 'error')")
    check(iters == len(plain_iters), "K2 bf16 540x960 level iteration count differs from plain")
    log(f"[3 parity] K2 bf16 duals {case}: max abs err {err:.3e} (<= {K2_LEVEL_MAX:g}), "
        f"mean EPE {epe:.2e} px (<= {K2_LEVEL_EPE:g}), same bits "
        f"{bool(torch.equal(got, want))}; against the float32 level mean EPE {epe32:.3e} px")
    check(err <= K2_LEVEL_MAX, f"K2 bf16 540x960 level max abs err {err}")
    check(epe <= K2_LEVEL_EPE, f"K2 bf16 540x960 level mean EPE {epe} px")


def phase_k3(smi):
    import torch
    from bwd_nlkalman_tpu_torch.flow import tvl1, tvl1_tiled
    from bwd_nlkalman_tpu_torch.flow.tvl1_block_cuda import LAUNCHES, tvl1_block_cuda

    h, w = 25, 41
    i0, i1, u0 = small_level()
    worst = 0.0
    # the JAX suite's bars for its K2, at K3's block (two blocks per warp
    # stage) and at one iteration
    for k, nwarps, max_iters, atol in ((24, 2, 48, 2e-3), (1, 1, 1, 1e-5)):
        tvl1_tiled.K_ITERS = k
        kw = dict(nwarps=nwarps, max_iters=max_iters)
        got = tvl1_tiled.tvl1_single_scale_tiled(i0, i1, u0, **kw)
        want = tvl1_tiled.tvl1_level_tiled_plain(i0, i1, u0, **kw)
        torch.cuda.synchronize()
        err = max_err(got, want)
        worst = max(worst, err)
        log(f"[3 parity] K3 {h}x{w} k_iters={k} nwarps={nwarps} "
            f"max_iters={max_iters}: max abs err {err:.3e} (atol {atol:g})")
        assert_close("K3", got, want, rtol=0.0, atol=atol)
    tvl1_tiled.K_ITERS = 24
    PARITY["K3"] = worst

    # the slice's 1080x1920 level: a full-resolution pair from make_clip
    _, noisy = make_clip(*FULL, 2, SIGMA)
    nz = torch.from_numpy(noisy).cuda()
    a, b = tvl1._prep_pair(nz[1, ..., 0], nz[0, ..., 0])
    u0 = a.new_zeros(a.shape + (2,))
    kw = dict(lambda_=0.25, nwarps=5, max_iters=300)
    lk_ms, lp_ms = timed_pair(lambda: tvl1_tiled.tvl1_single_scale_tiled(a, b, u0, **kw),
                              lambda: tvl1_tiled.tvl1_level_tiled_plain(a, b, u0, **kw),
                              2, 1)
    LAUNCHES.reset()
    got = no_host_sync(lambda: tvl1_tiled.tvl1_single_scale_tiled(a, b, u0, **kw))
    blocks = LAUNCHES.count           # the one host read of the level
    plain_blocks = []
    block = tvl1_tiled.tvl1_block
    tvl1_tiled.tvl1_block = lambda *args, **k: plain_blocks.append(1) or block(*args, **k)
    try:
        want = tvl1_tiled.tvl1_level_tiled_plain(a, b, u0, **kw)
    finally:
        tvl1_tiled.tvl1_block = block
    epe = float(torch.linalg.vector_norm(got - want, dim=-1).mean())
    err = max_err(got, want)
    log(f"[3 time] K3 level {a.shape[0]}x{a.shape[1]} nwarps=5 (K4 warps, constants, "
        f"one K3 launch per warp stage): kernel {lk_ms:.2f} ms ({blocks} blocks of 24 "
        f"iterations), plain {lp_ms:.2f} ms ({smi})")
    log(f"[3 counts] K3 level {a.shape[0]}x{a.shape[1]}: blocks kernel {blocks}, plain "
        f"{len(plain_blocks)}; host reads in the level 0 (sync debug mode 'error'), "
        f"after it 1 (the block counter)")
    check(blocks == len(plain_blocks), "K3 1080x1920 level block count differs from plain")
    log(f"[3 parity] K3 level {a.shape[0]}x{a.shape[1]} nwarps=5: max abs err "
        f"{err:.3e} (<= {K3_LEVEL_MAX:g}), mean EPE {epe:.2e} px (<= {K3_LEVEL_EPE:g})")
    check(err <= K3_LEVEL_MAX, f"K3 1080x1920 level max abs err {err}")
    check(epe <= K3_LEVEL_EPE, f"K3 1080x1920 level mean EPE {epe} px")

    # one block at that level, from its first warp stage's constants
    i1s = torch.stack([b, *tvl1_tiled.centered_gradient(b)], -1)
    state = a.new_zeros((6,) + a.shape)
    consts = tvl1_tiled.tvl1_stage_consts(i1s, state, a)
    k_ms, p_ms = timed_pair(lambda: tvl1_block_cuda(state, consts, 24),
                            lambda: tvl1_tiled.tvl1_block_plain(state, consts, 24),
                            10, 2)
    d_ms = device_ms(lambda: tvl1_block_cuda(state, consts, 24), 10)
    npx = a.numel()
    BOUNDS["K3"] = bound(24 * npx * K3_FLOPS_ITER + 6 * npx, (6 + 4 + 6) * 4 * npx)
    TIMES["K3"] = (k_ms, p_ms, d_ms)
    log(f"[3 time] K3 block of 24 iterations at {a.shape[0]}x{a.shape[1]}: kernel {k_ms:.3f} ms "
        f"between events ({1e3 * k_ms / 24:.1f} us per iteration; the level above "
        f"{lk_ms:.2f} ms), device {fmt_ms(d_ms)}, plain {p_ms:.3f} ms, bound "
        f"{BOUNDS['K3'][0]:.4f} ms ({BOUNDS['K3'][1]}) ({smi})")


def phase_k4(smi):
    import torch
    import torch.nn.functional as F
    from bwd_nlkalman_tpu_torch.flow import tvl1, tvl1_tiled
    from bwd_nlkalman_tpu_torch.ops.warp import bicubic_warp_plain
    from bwd_nlkalman_tpu_torch.ops.warp_cuda import (bicubic_warp_cuda, channel_groups,
                                                      warp_tvl1_consts_cuda)
    from bwd_nlkalman_tpu_torch.tools.k1_bench import cuda_ms
    from bwd_nlkalman_tpu_torch.tools.warp_bench import noisy_flow, smooth_flow, tvl1_flows

    rng = np.random.default_rng(3)
    worst = 0.0
    # every channel instance at the JAX suite's size, a ragged frame, and a
    # quarter-size frame with a band of wide flow; past 9 channels, launches
    # in channel groups: the filter's (10-14) and fsmo's (12) warps of
    # 4-7-channel clips, and 21
    for c in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 21):
        for h, w, band in ((32, 40, False), (37, 53, False), (270, 480, True)):
            im = torch.from_numpy(rng.uniform(0, 255, (h, w, c)).astype(np.float32)).cuda()
            flow = torch.from_numpy(noisy_flow(rng, h, w, band)).cuda()
            occl = torch.from_numpy(np.where(rng.uniform(size=(h, w)) < 0.1, 255.0, 0.0)
                                    .astype(np.float32)).cuda()
            for oc in (None, occl):
                got, gv = bicubic_warp_cuda(im, flow, oc)
                want, wv = bicubic_warp_plain(im, flow, oc)
                err = max_err(got, want)
                worst = max(worst, err)
                log(f"[3 parity] K4 {h}x{w} C={c} occl={oc is not None} band={band}: max abs "
                    f"err {err:.3e} (atol 1e-3), valid {int(gv.sum())}/{h * w} identical="
                    f"{bool(torch.equal(gv, wv))}")
                check(torch.equal(gv, wv), "K4 validity masks differ")
                check(0 < int(gv.sum()) < h * w, "K4 case is all valid or all invalid")
                assert_close("K4", got, want, rtol=0.0, atol=1e-3)
            # past 9 channels, each group of the launch against the one-group
            # launch of its channels: the same mask; the same bits where
            # that launch is the generic instance too (4, 5, 7, 8 channels)
            if h == 270 and c > 9:
                for c0, n in channel_groups(c):
                    one, ov = bicubic_warp_cuda(im[..., c0:c0 + n].contiguous(), flow, occl)
                    part = got[..., c0:c0 + n]
                    log(f"[3 parity] K4 {h}x{w} C={c} group {c0}..{c0 + n - 1} against the "
                        f"one-group launch of its {n} channels: masks equal "
                        f"{bool(torch.equal(gv, ov))}, same bits {bool(torch.equal(part, one))},"
                        f" max abs diff {max_err(part, one):.3e}")
                    check(torch.equal(gv, ov), "K4 group and one-group masks differ")
                    check(n in (1, 2, 3, 6) or torch.equal(part, one),
                          "K4 group changed the bits of the generic instance")
                    check(max_err(part, one) <= 1e-3, "K4 group off the one-group launch")

    # the slice's warps at 1080p: C=2 (the filter's flt1|flt2) and C=1 with
    # an occlusion mask (the smoother's), along the flow the main path
    # computes for the slices' scene, a smooth flow and a noisy one
    h, w = FULL
    im = torch.from_numpy(rng.uniform(0, 255, (h, w, 2)).astype(np.float32)).cuda()
    occl = torch.from_numpy(np.where(rng.uniform(size=(h, w)) < 0.1, 255.0, 0.0)
                            .astype(np.float32)).cuda()
    flows = {"the main path's TV-L1": tvl1_flows()[0],
             "a smooth": torch.from_numpy(smooth_flow(h, w)).cuda(),
             "a noisy": torch.from_numpy(noisy_flow(rng, h, w)).cuda()}
    for (c, oc), (kind, fl) in itertools.product(((2, None), (1, occl)), flows.items()):
        got, gv = bicubic_warp_cuda(im[..., :c].contiguous(), fl, oc)
        want, wv = bicubic_warp_plain(im[..., :c].contiguous(), fl, oc)
        err = max_err(got, want)
        worst = max(worst, err)
        log(f"[3 parity] K4 1080p C={c} occl={oc is not None} along {kind} flow: max abs "
            f"err {err:.3e} (atol 1e-3), valid {int(gv.sum())}/{h * w} "
            f"identical={bool(torch.equal(gv, wv))}")
        check(torch.equal(gv, wv), "K4 1080p validity masks differ")
        assert_close("K4 1080p", got, want, rtol=0.0, atol=1e-3)
    # fsmo's warp of an RGB clip, flt1|flt2|smo: 9 channels; the filter's
    # warp of a 5-channel clip (10) and of a 7-channel one (14), fsmo's of
    # a 4-channel clip (12), in channel groups: each with and without
    # occlusion along the main path's flow, timed with the occlusion mask,
    # as fsmo and the filter warp
    flow = flows["the main path's TV-L1"]
    for c in (9, 10, 12, 14):
        imc = torch.from_numpy(rng.uniform(0, 255, (h, w, c)).astype(np.float32)).cuda()
        for oc in (None, occl):
            got, gv = bicubic_warp_cuda(imc, flow, oc)
            want, wv = bicubic_warp_plain(imc, flow, oc)
            err = max_err(got, want)
            worst = max(worst, err)
            log(f"[3 parity] K4 1080p C={c} occl={oc is not None} along the main path's TV-L1 "
                f"flow: max abs err {err:.3e} (atol 1e-3), valid {int(gv.sum())}/{h * w} "
                f"identical={bool(torch.equal(gv, wv))}")
            check(torch.equal(gv, wv), f"K4 1080p C={c} validity masks differ")
            assert_close(f"K4 1080p C={c}", got, want, rtol=0.0, atol=1e-3)
        del got, want
        kc_ms, pc_ms = timed_pair(lambda: bicubic_warp_cuda(imc, flow, occl),
                                  lambda: bicubic_warp_plain(imc, flow, occl), 20, 3)
        dc_ms = device_ms(lambda: bicubic_warp_cuda(imc, flow, occl), 20)
        px = 4 * c + 8 + 4 + 4 * c + 1
        bc_ms, bc_by = bound(h * w * c * K4_FLOPS_CH, h * w * px)
        log(f"[3 time] K4 1080p C={c} with occlusion ({len(channel_groups(c))} channel "
            f"group(s)) along the main path's TV-L1 flow: kernel {kc_ms:.4f} ms between "
            f"events, device {fmt_ms(dc_ms)}, plain {pc_ms:.3f} ms, bound {bc_ms:.4f} ms "
            f"({bc_by}; {px} B a pixel) ({smi})")
        del imc
    # the timed call: the filter's warp along the main path's flow
    k_ms, p_ms = timed_pair(lambda: bicubic_warp_cuda(im, flow),
                            lambda: bicubic_warp_plain(im, flow), 20, 5)
    d_ms = device_ms(lambda: bicubic_warp_cuda(im, flow), 20)
    BOUNDS["K4"] = bound(h * w * 2 * K4_FLOPS_CH, h * w * (4 * 2 + 8 + 4 * 2 + 1))
    TIMES["K4"] = (k_ms, p_ms, d_ms)
    beside = {kind: (cuda_ms(lambda: bicubic_warp_cuda(im, fl), 20),
                     device_ms(lambda: bicubic_warp_cuda(im, fl), 20))
              for kind, fl in flows.items() if kind != "the main path's TV-L1"}
    log(f"[3 time] K4 1080p C=2 along the main path's TV-L1 flow: kernel {k_ms:.4f} ms "
        f"between events, device {fmt_ms(d_ms)}, plain {p_ms:.3f} ms, bound "
        f"{BOUNDS['K4'][0]:.4f} ms ({BOUNDS['K4'][1]}); " + "; ".join(
            f"along {kind} flow {e:.4f} ms between events, device {fmt_ms(d)}"
            for kind, (e, d) in beside.items()) + f" ({smi})")
    # the yardstick: the same amount of work in PyTorch's own bicubic
    # sampler, which is another function (a=-0.75, other borders)
    planar = im.permute(2, 0, 1)[None].contiguous()
    xs = torch.arange(w, device="cuda", dtype=torch.float32)
    ys = torch.arange(h, device="cuda", dtype=torch.float32)
    grid = torch.stack([2 * (xs[None, :] + flow[..., 0]) / (w - 1) - 1,
                        2 * (ys[:, None] + flow[..., 1]) / (h - 1) - 1], -1)[None]

    def yardstick():
        return F.grid_sample(planar, grid, mode="bicubic", padding_mode="zeros",
                             align_corners=True)

    g_ms = cuda_ms(yardstick, 20)
    log(f"[3 yardstick] grid_sample(mode='bicubic', padding_mode='zeros', align_corners="
        f"True), another function that the port never calls, on the same 1080p C=2 "
        f"input in its planar layout: {g_ms:.4f} ms between events, device "
        f"{fmt_ms(device_ms(yardstick, 20))} ({smi})")
    del im, planar, grid, flows, flow

    # the TV-L1 entry at the slice's 1080x1920 level: (I1, I1x, I1y) of a
    # full-resolution pair warped along a smooth flow that leaves the frame
    # at the borders, to the four constant planes. Bars: the warped planes
    # to 1e-3 as every warp, grad and rho_c to 2e-2 (products with the
    # gradients and the flow), exactly 0 and -i0 out of the frame.
    _, noisy = make_clip(*FULL, 2, SIGMA)
    nz = torch.from_numpy(noisy).cuda()
    a, b = tvl1._prep_pair(nz[1, ..., 0], nz[0, ..., 0])
    i1s = torch.stack([b, *tvl1_tiled.centered_gradient(b)], -1)
    state = torch.zeros((6, h, w), device="cuda")
    state[:2] = torch.from_numpy(smooth_flow(h, w)).cuda().permute(2, 0, 1)
    got = warp_tvl1_consts_cuda(i1s, state, a)
    want = tvl1_tiled.tvl1_stage_consts_plain(i1s, state, a)
    _, valid = bicubic_warp_plain(i1s, state[:2].permute(1, 2, 0).contiguous())
    out = ~valid
    e_w, e_c = max_err(got[:2], want[:2]), max_err(got[2:], want[2:])
    k_ms, p_ms = timed_pair(lambda: warp_tvl1_consts_cuda(i1s, state, a),
                            lambda: tvl1_tiled.tvl1_stage_consts_plain(i1s, state, a), 20, 5)
    d_ms = device_ms(lambda: warp_tvl1_consts_cuda(i1s, state, a), 20)
    b_ms, b_by = bound(h * w * (3 * K4_FLOPS_CH + 7), 40 * h * w)
    log(f"[3 parity] K4 TV-L1 entry {h}x{w}: max abs err i1wx, i1wy {e_w:.3e} (atol 1e-3), "
        f"grad, rho_c {e_c:.3e} (atol 2e-2); out of the frame {int(out.sum())} pixels, "
        f"exactly 0 / -i0: {bool(not got[:3, out].any() and torch.equal(got[3, out], -a[out]))}")
    assert_close("K4 TV-L1 entry", got[:2], want[:2], rtol=0.0, atol=1e-3)
    assert_close("K4 TV-L1 entry", got[2:], want[2:], rtol=0.0, atol=2e-2)
    check(bool(out.any()) and not got[:3, out].any() and torch.equal(got[3, out], -a[out]),
          "K4 TV-L1 entry out of the frame is not 0 / -i0")
    log(f"[3 time] K4 TV-L1 entry {h}x{w} (a warp stage's constants): kernel {k_ms:.4f} ms "
        f"between events, device {fmt_ms(d_ms)}, plain {p_ms:.3f} ms, bound {b_ms:.4f} ms "
        f"({b_by}; 40 B a pixel) ({smi})")
    PARITY["K4"] = max(worst, e_w)


def phase_p(smi):
    import torch
    from bwd_nlkalman_tpu_torch.tools import vpu_probe as vp

    worst = 0.0
    for h, w in vp.SIZES.values():
        a = vp.probe_input(h, w, "cuda")
        for name, (nchains, op, dtype) in vp.VARIANTS.items():
            got = vp.probe_cuda(a, nchains, op, dtype, k=8)
            want = vp.probe_plain(a, nchains, op, dtype, k=8)
            rtol = 1e-6 if dtype == torch.float32 else 2e-2
            rel = float(((got - want).abs() / want.abs()).max())
            worst = max(worst, max_err(got, want))
            log(f"[3 parity] P {name} {h}x{w} K=8: max rel err {rel:.2e} (rtol {rtol:g})")
            assert_close("P", got, want, rtol=rtol, atol=0.0)
    PARITY["P"] = worst
    h, w = vp.SIZES[""]
    a = vp.probe_input(h, w, "cuda")
    k_ms, p_ms = timed_pair(lambda: vp.probe_cuda(a, 8, "fma", torch.float32),
                            lambda: vp.probe_plain(a, 8, "fma", torch.float32), 20, 1)
    d_ms = device_ms(lambda: vp.probe_cuda(a, 8, "fma", torch.float32), 20)
    BOUNDS["P"] = bound(vp.flops(h, w, 8, "fma"), 8 * h * w)
    TIMES["P"] = (k_ms, p_ms, d_ms)
    log(f"[3 time] P fma8 {h}x{w} K={vp.K} GRID={vp.GRID}: kernel {k_ms:.4f} ms between "
        f"events, device {fmt_ms(d_ms)}, plain {p_ms:.2f} ms, bound {BOUNDS['P'][0]:.4f} ms "
        f"({BOUNDS['P'][1]}) ({smi})")


def g_products(h, w):
    """(what, input shape, output (H, W)) of each of G's calls in a flow on
    (h, w) frames: the pair's blur, each zoom-out of the pair and each
    zoom-in of the (h, w, 2) flow, finest first."""
    from bwd_nlkalman_tpu_torch.flow import tvl1

    sizes = tvl1._pyramid_sizes(w, h, tvl1.num_scales(w, h, 100, 0.5), 0.5)
    out = [("blur", (2, h, w), (h, w))]
    for s, ((pw, ph), (nw, nh)) in enumerate(zip(sizes, sizes[1:])):
        out.append((f"zoom-out {s}", (2, ph, pw), (nh, nw)))
        out.append((f"zoom-in {s + 1} -> {s}", (nh, nw, 2), (ph, pw)))
    return out


def g_per_flow(h, w):
    """G's launches in a cold flow on (h, w) frames at any fscale: the
    pair's blur, then a zoom-out of the pair and a zoom-in of the flow a
    level past the first (15 at 1080p: 8 levels)."""
    from bwd_nlkalman_tpu_torch.flow import tvl1

    return 2 * tvl1.num_scales(w, h, 100, 0.5) - 1


def g_call(what, x, size, bases, engine):
    """The flow's call ``what`` of :func:`g_products` on x, with the keys
    and build of its axis matrices and its scale."""
    from bwd_nlkalman_tpu_torch.flow import tvl1
    from bwd_nlkalman_tpu_torch.ops import gaussian, zoom

    sigma = tvl1.PRESMOOTHING_SIGMA
    if what == "blur":
        keys = [("blur", n, sigma) for n in x.shape[1:]]
        return (gaussian.gaussian_blur(x, sigma, bases, engine), keys,
                gaussian.blur_matrix_np, 1.0)
    if what.startswith("zoom-out"):
        return (zoom.zoom_out(x, 0.5, bases, engine), zoom.zoom_out_keys(*x.shape[1:], 0.5),
                zoom._zoom_out_matrix_np, 1.0)
    h, w = size
    return (tvl1._zoom_flow(x, w, h, 0.5, bases, engine),
            zoom.zoom_in_keys(*x.shape[:2], w, h), zoom._resample_matrix_np, 2.0)


def g_rounding_bound(x, keys, build, scale):
    """(P, H', W') float64: twice gamma(Ty + Tx) times the sum of absolute
    terms of each output of scale * ay @ x_p @ ax^T, the most that rounding
    in any order of the same sums moves it (x (P, H, W))."""
    import torch
    from bwd_nlkalman_tpu_torch.ops.band_cuda import band_of, band_parts

    ay, ax = (torch.as_tensor(build(*k[1:]), dtype=torch.float64, device=x.device).abs()
              for k in keys)
    n = sum(band_parts(band_of(build, *k))[1].shape[1] for k in keys)
    u = 2.0 ** -24
    return 2 * n * u / (1 - n * u) * abs(scale) * (ay @ (x.double().abs() @ ax.T))


def g_work(x, out, keys, build):
    """(operations, bytes) of one call of G on the planes x (P, H, W) to out
    (P, H', W'): two a tap of each pass, each input, output and band moved
    once."""
    from bwd_nlkalman_tpu_torch.ops.band_cuda import band_of

    (p, h, _), (_, ho, wo) = x.shape, out.shape
    forms = [band_of(build, *k) for k in keys]
    ty, tx = (f.shape[1] - 1 for f in forms)
    return (2 * p * (h * wo * tx + ho * wo * ty),
            4 * (x.numel() + out.numel()) + sum(f.nbytes for f in forms))


def phase_g(smi):
    """G (ops/band_cuda.py) at the 1080p pyramid's shapes against the dense
    products (engine="plain") on the same inputs: the pair's blur, every
    zoom-out of the pair and every zoom-in of a flow in [-8, 8] (planes
    last, times 1/zfactor), one launch a call, every output within
    ``G_GAP_SHARE`` of the rounding bound of any order; the blur, the
    level-0 zoom-out and the level 1 -> 0 flow zoom-in timed against the
    dense products and their bounds; then G's counter over the benchmark
    cells' path (cold TV-L1 at fscale 1): 15 a lone flow (``g_per_flow``),
    15 a flow over a request of 3 frames (4 flows)."""
    import torch
    from bwd_nlkalman_tpu_torch.flow import tvl1
    from bwd_nlkalman_tpu_torch.ops import band_cuda
    from bwd_nlkalman_tpu_torch.ops.bases import make_bases
    from bwd_nlkalman_tpu_torch.pipeline import FlowConfig, NLKalmanDenoiser

    h, w = FULL
    bases = make_bases(tvl1.flow_bases(h, w), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(20)
    ab = 255 * torch.rand((2, h, w), generator=gen, device="cuda")
    worst, timed = 0.0, {}
    for what, shape, size in g_products(h, w):
        x = ab if not what.startswith("zoom-in") else \
            16 * torch.rand(shape, generator=gen, device="cuda") - 8
        band_cuda.LAUNCHES.reset()
        got, keys, build, scale = g_call(what, x, size, bases, "auto")
        check(band_cuda.LAUNCHES.count == 1, f"G {what}: {band_cuda.LAUNCHES.count} launches")
        want = g_call(what, x, size, bases, "plain")[0]
        check(got.shape == want.shape, f"G {what}: shape {tuple(got.shape)}")
        last = what.startswith("zoom-in")
        xp, gp, wp = ((t.permute(2, 0, 1) for t in (x, got, want)) if last
                      else (x, got, want))
        gap = (gp.double() - wp.double()).abs()
        b = g_rounding_bound(xp, keys, build, scale)
        share = float((gap / b.clamp(min=1e-300)).max())
        worst = max(worst, float(gap.max()))
        log(f"[3 parity] G {what} {tuple(x.shape)} -> {tuple(got.shape)}: max abs "
            f"{float(gap.max()):.3e}, differs at {float((gap > 0).double().mean()):.3f} of "
            f"the outputs, at most {share:.3f} of the rounding bound (<= {G_GAP_SHARE})")
        check(bool((gap <= G_GAP_SHARE * b).all()), f"G {what}: beyond the rounding bound")
        if what in ("blur", "zoom-out 0", "zoom-in 1 -> 0"):
            timed[what] = (x, size, g_work(xp, gp, keys, build))
        if not last:
            ab = got
    PARITY["G"] = worst
    for what, (x, size, (ops, nbytes)) in timed.items():
        k_ms, p_ms = timed_pair(lambda: g_call(what, x, size, bases, "auto"),
                                lambda: g_call(what, x, size, bases, "plain"), 40, 10)
        d_ms = device_ms(lambda: g_call(what, x, size, bases, "auto"), 40)
        pd_ms = device_ms(lambda: g_call(what, x, size, bases, "plain"), 10)
        b_ms, b_by = bound(ops, nbytes)
        if what == "blur":
            TIMES["G"], BOUNDS["G"] = (k_ms, p_ms, d_ms), (b_ms, b_by)
        log(f"[3 time] G {what} {tuple(x.shape)}: kernel {k_ms:.4f} ms between events, "
            f"device {fmt_ms(d_ms)}, dense products (plain, the library call) {p_ms:.4f} ms, "
            f"device {fmt_ms(pd_ms)}, bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB) "
            f"({smi})")
    t = 3
    _, noisy_np = make_clip(h, w, t, SIGMA)
    noisy = torch.from_numpy(noisy_np).cuda()
    cfg = FlowConfig()
    model = NLKalmanDenoiser(SIGMA, h, w, cfg).cuda()
    model(noisy)                # warm-up
    torch.cuda.synchronize()
    counters = reset_counters()
    cfg.flow(noisy[0, ..., 0], noisy[1, ..., 0], bases=model.bases(noisy))
    lone = read_counters(counters, "3 G cells' flow", ("K2", "G"))["G"]
    counters = reset_counters()
    model(noisy)
    launches = read_counters(counters, "3 G cells' request", ("K1", "K2", "K4", "G"))
    n = g_per_flow(h, w)
    log(f"[3 launches] G over the cells' path (cold flow at fscale 1, {h}x{w} gray): "
        f"{lone} a lone flow, {launches['G']} over a request of {t} frames "
        f"({2 * (t - 1)} flows; {n} a flow expected)")
    check(lone == n and launches["G"] == n * 2 * (t - 1), f"G: not {n} launches a flow")


def reset_counters():
    import bwd_nlkalman_tpu_torch as port

    counters = port.kernel_counters()
    for c in counters.values():
        c.reset()
    return counters


def read_counters(counters, path, must):
    """The launch counts after a path's run; fails unless every kernel in
    ``must`` launched."""
    launches = {k: c.count for k, c in counters.items()}
    log(f"[{path}] launches during the run: {launches}")
    check(all(launches[k] > 0 for k in must), f"{path}: a kernel of {must} never launched")
    return launches


def phase_slice(smi):
    import torch
    from bwd_nlkalman_tpu_torch.pipeline import FlowConfig, NLKalmanDenoiser

    t, (h, w) = 4, FULL
    clean_np, noisy_np = make_clip(h, w, t, SIGMA)
    clean = torch.from_numpy(clean_np).cuda()
    noisy = torch.from_numpy(noisy_np).cuda()
    model = NLKalmanDenoiser(SIGMA, h, w, FlowConfig(warm_start=True, warm_nwarps=3)).cuda()
    model(noisy[:2])            # warm-up: allocator, cuBLAS handles
    torch.cuda.synchronize()
    counters = reset_counters()
    t0 = time.perf_counter()
    flt1, flt2, smo1 = model(noisy)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counters(counters, "4 slice", ("K1", "K2", "K4", "G"))
    for name, x in (("flt1", flt1), ("flt2", flt2), ("smo1", smo1)):
        check(x.shape == noisy.shape, f"{name} shape {tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()), f"{name} has non-finite values")
    p_n, p_1, p_2, p_s = (psnr(clean, x) for x in (noisy, flt1, flt2, smo1))
    log(f"[4 slice] 1080p gray T={t} sigma={SIGMA:g} warm flow: PSNR noisy "
        f"{p_n:.3f} flt1 {p_1:.3f} flt2 {p_2:.3f} smo1 {p_s:.3f} dB")
    log(f"[4 slice] {secs:.3f} s, {t / secs:.3f} frames/s ({smi})")
    check(p_s >= p_n + 6.0, "smo1 does not denoise by 6 dB")
    check(p_s >= p_2 - 0.1, "smo1 is worse than flt2 by more than 0.1 dB")
    check(launches["K1"] >= 3 * t - 1, f"K1 ran {launches['K1']} passes")
    profile_slice(lambda: model(noisy), "4 slice profile", smi)
    return {"psnr": (p_2, p_s), "fps": t / secs, "launches": launches}


def phase_slice_bf16(smi, f32):
    """Slice 1 on the same 4 frames in bfloat16: with bf16 bands
    (``window_dtype="bfloat16"``), with bf16 duals in K2
    (``FlowConfig(..., state_dtype="bfloat16")``), and with both (the
    nearest the port comes to ``bench.py:35-36``, which also sets JAX's
    warp taps to bf16, a deviation the port records). Each: flt2 and smo1
    within 0.05 dB of the float32 run (the JAX package's bf16 gate), K1
    launched as often as in the float32 run and never on the plain route,
    K2 and K4 launched; frames/s beside the float32 run's and a profiled
    run."""
    import torch
    from bwd_nlkalman_tpu_torch.core.nlkalman import PLAIN_PASSES
    from bwd_nlkalman_tpu_torch.pipeline import FlowConfig, NLKalmanDenoiser

    t, (h, w) = 4, FULL
    clean_np, noisy_np = make_clip(h, w, t, SIGMA)
    clean = torch.from_numpy(clean_np).cuda()
    noisy = torch.from_numpy(noisy_np).cuda()
    for what, window_dtype, state_dtype in (("bands", "bfloat16", "float32"),
                                            ("duals", "float32", "bfloat16"),
                                            ("bands and duals", "bfloat16", "bfloat16")):
        tag = f"4b slice bf16 {what}"
        model = NLKalmanDenoiser(SIGMA, h, w, FlowConfig(warm_start=True, warm_nwarps=3,
                                                         state_dtype=state_dtype),
                                 window_dtype=window_dtype)
        model(noisy[:2])            # warm-up
        torch.cuda.synchronize()
        counters = reset_counters()
        PLAIN_PASSES.reset()
        t0 = time.perf_counter()
        flt1, flt2, smo1 = model(noisy)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counters(counters, tag, ("K1", "K2", "K4", "G"))
        for name, x in (("flt1", flt1), ("flt2", flt2), ("smo1", smo1)):
            check(x.shape == noisy.shape and bool(torch.isfinite(x).all()),
                  f"{tag}: {name} bad")
        p_2, p_s = psnr(clean, flt2), psnr(clean, smo1)
        d2, ds = p_2 - f32["psnr"][0], p_s - f32["psnr"][1]
        log(f"[{tag}] 1080p gray T={t} window {window_dtype}, duals {state_dtype}: PSNR "
            f"flt2 {p_2:.3f} smo1 {p_s:.3f} dB (float32 {f32['psnr'][0]:.3f} / "
            f"{f32['psnr'][1]:.3f}; d {d2:+.4f} / {ds:+.4f}, |d| <= 0.05); plain-route "
            f"passes {PLAIN_PASSES.count}")
        log(f"[{tag}] {secs:.3f} s, {t / secs:.3f} frames/s (float32 {f32['fps']:.3f}) "
            f"({smi})")
        check(abs(d2) <= 0.05 and abs(ds) <= 0.05, f"{tag}: PSNR off float32 by > 0.05 dB")
        check(launches["K1"] == f32["launches"]["K1"], f"{tag}: K1 ran {launches['K1']}")
        check(PLAIN_PASSES.count == 0, f"{tag}: a pass took the plain route")
        profile_slice(lambda: model(noisy), f"{tag} profile", smi)


def profile_slice(run, tag, smi):
    """One more run under torch.profiler: device busy time (the union of
    the device activities), the idle share of the run's host wall time, the
    five kernels that take the most device time, and the device time and
    kernel count of each of K1-K4 and G (``KERNEL_NAMES``). Returns (idle share,
    kernel id -> device ms), or None where the profiler saw no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bwd_nlkalman_tpu_torch.tools.k1_bench import (busy_ms, device_events, kernel_ms,
                                                       short_name)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    ev = device_events(prof)
    if not ev:
        log(f"[{tag}] device busy, idle share and top kernels: not measured "
            f"(the profiler saw no device time); wall {wall:.1f} ms ({smi})")
        return
    busy = busy_ms(ev)
    top = sorted(kernel_ms(ev).items(), key=lambda kv: -kv[1])[:5]
    log(f"[{tag}] device busy {busy:.1f} ms of {wall:.1f} ms wall under the profiler, "
        f"idle {100 * (1 - busy / wall):.1f}%; top kernels by device time: " +
        ", ".join(f"{k} {v:.1f} ms ({100 * v / busy:.1f}%)" for k, v in top) + f" ({smi})")
    ids = {k: [short_name(n).startswith(KERNEL_NAMES[k]) for n, _, _ in ev]
           for k in KERNEL_NAMES}
    by = {k: sum(t1 - t0 for (_, t0, t1), m in zip(ev, mine) if m) / 1e3
          for k, mine in ids.items()}
    log(f"[{tag}] device time by kernel: " + ", ".join(
        f"{k} {by[k]:.3f} ms in {sum(mine)} kernels" for k, mine in ids.items()) + f" ({smi})")
    return 1 - busy / wall, by


def phase_slice_fullres(smi):
    import torch
    from bwd_nlkalman_tpu_torch.pipeline import FlowConfig, NLKalmanDenoiser

    t, (h, w) = 3, FULL
    clean_np, noisy_np = make_clip(h, w, t, SIGMA)
    clean = torch.from_numpy(clean_np).cuda()
    noisy = torch.from_numpy(noisy_np).cuda()
    model = NLKalmanDenoiser(SIGMA, h, w, FlowConfig(fscale=0))
    model(noisy[:2])            # warm-up
    torch.cuda.synchronize()
    counters = reset_counters()
    t0 = time.perf_counter()
    flt1, flt2, smo1 = model(noisy)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counters(counters, "5 slice fscale=0", ("K1", "K2", "K3", "K4", "G"))
    for name, x in (("flt1", flt1), ("flt2", flt2), ("smo1", smo1)):
        check(x.shape == noisy.shape, f"{name} shape {tuple(x.shape)}")
        check(bool(torch.isfinite(x).all()), f"{name} has non-finite values")
    p_n, p_1, p_2, p_s = (psnr(clean, x) for x in (noisy, flt1, flt2, smo1))
    log(f"[5 slice fscale=0] 1080p gray T={t} sigma={SIGMA:g} cold full-resolution "
        f"flow: PSNR noisy {p_n:.3f} flt1 {p_1:.3f} flt2 {p_2:.3f} smo1 {p_s:.3f} dB")
    log(f"[5 slice fscale=0] {secs:.3f} s, {t / secs:.3f} frames/s ({smi})")
    check(p_s >= p_n + 6.0, "fscale=0 smo1 does not denoise by 6 dB")
    check(launches["K1"] >= 3 * t - 1, f"K1 ran {launches['K1']} passes")
    check(launches["G"] == g_per_flow(h, w) * 2 * (t - 1),
          f"G ran {launches['G']} times, not {g_per_flow(h, w)} a flow")
    profile_slice(lambda: model(noisy), "5 slice fscale=0 profile", smi)
    return launches


def phase_cli_tvl1flow(smi):
    import runpy
    import tempfile

    from bwd_nlkalman_tpu_torch.io import read_flo, write_png

    _, noisy = make_clip(*FULL, 2, SIGMA)
    with tempfile.TemporaryDirectory() as d:
        i0, i1, out = (os.path.join(d, n) for n in ("i0.png", "i1.png", "u.flo"))
        write_png(i0, noisy[1])
        write_png(i1, noisy[0])
        argv = sys.argv
        sys.argv = ["tvl1flow", i0, i1, out]
        counters = reset_counters()
        t0 = time.perf_counter()
        try:
            runpy.run_module("bwd_nlkalman_tpu_torch.cli.tvl1flow", run_name="__main__")
        except SystemExit as e:
            check(e.code == 0, f"tvl1flow exited {e.code}")
        finally:
            sys.argv = argv
        secs = time.perf_counter() - t0
        launches = read_counters(counters, "6 tvl1flow", ("K2", "K3", "K4"))
        u = read_flo(out)
    check(u.shape == FULL + (2,), f"tvl1flow wrote a {u.shape} flow")
    check(bool(np.isfinite(u).all()), "tvl1flow wrote non-finite flow")
    log(f"[6 tvl1flow] 1080p PNG pair, fscale=0: {secs:.3f} s with io, mean flow "
        f"({u[..., 0].mean():.3f}, {u[..., 1].mean():.3f}) px ({smi})")
    return launches


def phase_probe():
    """The probe's entry point (``main``, what ``python -m`` runs)."""
    from bwd_nlkalman_tpu_torch.tools import vpu_probe

    counters = reset_counters()
    vpu_probe.main()
    return read_counters(counters, "7 probe", ("P",))


def phase_slice_vs_plain():
    import torch
    from bwd_nlkalman_tpu_torch import models
    from bwd_nlkalman_tpu_torch.pipeline import (FlowConfig, MultiscaleDenoiser,
                                                 NLKalmanDenoiser, StreamingDenoiser)

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
        log(f"[8 slice vs plain] 128x160 T=3 warm={cfg.warm_start}: kernels "
            f"flt2/smo1 {res['auto'][0]:.4f}/{res['auto'][1]:.4f} dB, plain "
            f"{res['plain'][0]:.4f}/{res['plain'][1]:.4f} dB, |d| {d2:.4f}/{ds:.4f} (<= 0.05)")
        check(d2 <= 0.05 and ds <= 0.05, "kernels and plain versions disagree")

    # this slice's paths, each kernels against plain on every output: the
    # causal smoothers and the stream on RGB (fsmo's warp is 9 channels),
    # the multiscale pyramids at 2 levels on gray
    rgb_clean_np, rgb_noisy_np = make_clip(128, 160, 3, SIGMA, seed=2, channels=3)
    rgb_clean = torch.from_numpy(rgb_clean_np).cuda()
    rgb_noisy = torch.from_numpy(rgb_noisy_np).cuda()

    def stream(engine):
        sd = StreamingDenoiser(SIGMA, smoother="fsmo", engine=engine)
        outs = [sd.step(f) + (sd.smo,) for f in rgb_noisy]
        return tuple(torch.stack(x) for x in zip(*outs))

    runs = {
        "fsmo RGB": (rgb_clean, lambda e: NLKalmanDenoiser(
            SIGMA, 128, 160, engine=e, smoother="fsmo")(rgb_noisy)),
        "lsmo RGB": (rgb_clean, lambda e: NLKalmanDenoiser(
            SIGMA, 128, 160, engine=e, smoother="lsmo")(rgb_noisy)),
        "streaming fsmo RGB": (rgb_clean, stream),
        "multiscale dct": (clean, lambda e: MultiscaleDenoiser(
            SIGMA, 128, 160, levels=2, engine=e)(noisy)),
        "multiscale lz3": (clean, lambda e: MultiscaleDenoiser(
            SIGMA, 128, 160, levels=2, pyramid="lz3", engine=e)(noisy)),
    }
    for name, (ref, run) in runs.items():
        res = {}
        for engine in ("auto", "plain"):
            res[engine] = [psnr(ref, x) for x in run(engine)]
            torch.cuda.synchronize()
        d = [abs(a - b) for a, b in zip(res["auto"], res["plain"])]
        log(f"[8 {name} vs plain] 128x160 T=3: kernels flt1/flt2/smo1 "
            + "/".join(f"{x:.4f}" for x in res["auto"]) + " dB, plain "
            + "/".join(f"{x:.4f}" for x in res["plain"]) + " dB, |d| "
            + "/".join(f"{x:.4f}" for x in d) + " (<= 0.05)")
        check(max(d) <= 0.05, f"{name}: kernels and plain versions disagree")
    for name in sorted(models.MODELS):
        out = models.get_model(name, SIGMA)(noisy)
        p_out = psnr(clean, out)
        log(f"[8 get_model] {name} 128x160 T=3: {tuple(out.shape)}, PSNR {p_out:.4f} dB")
        check(out.shape == noisy.shape and bool(torch.isfinite(out).all()),
              f"get_model({name!r}) gave non-finite frames or a wrong shape")


def phase_stream(smi):
    """Streaming fsmo on 1080p RGB with checkpoints, a stop and a resume."""
    import tempfile

    import torch
    from bwd_nlkalman_tpu_torch.pipeline import FlowConfig, run_streaming

    t, (h, w) = 4, FULL
    clean_np, noisy_np = make_clip(h, w, t, SIGMA, channels=3)
    kw = dict(smoother="fsmo", flow_cfg=FlowConfig(warm_start=True, warm_nwarps=3))

    def read(i):
        return noisy_np[i]

    def collect(into):
        return lambda name, i, a: into.__setitem__((name, i), a)

    run_streaming(read, 0, 1, SIGMA, **kw)      # warm-up
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        full, resumed = {}, {}
        counters = reset_counters()
        t0 = time.perf_counter()
        run_streaming(read, 0, t - 1, SIGMA, checkpoint_path=os.path.join(d, "full.npz"),
                      write_frame=collect(full), checkpoint_every=2,
                      async_checkpoint=True, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counters(counters, "9 stream", ("K1", "K2", "K4", "K4c9"))
        ck = os.path.join(d, "stopped.npz")
        run_streaming(read, 0, 1, SIGMA, checkpoint_path=ck, checkpoint_every=2, **kw)
        index = int(np.load(ck)["index"])
        run_streaming(read, 0, t - 1, SIGMA, checkpoint_path=ck,
                      write_frame=collect(resumed), checkpoint_every=2, **kw)
    check(index == 1, f"the stopped run's checkpoint holds frame {index}, not 1")
    check(sorted({i for _, i in resumed}) == [2, 3], "the resumed run did not start at frame 2")
    diff = max(float(np.abs(resumed[k] - full[k]).max()) for k in resumed)
    stacks = {n: np.stack([full[(n, i)] for i in range(t)]) for n in ("flt1", "flt2", "smo1")}
    for name, x in stacks.items():
        check(x.shape == noisy_np.shape and np.isfinite(x).all(), f"stream {name} bad")
    clean = torch.from_numpy(clean_np)
    p_n, p_1, p_2, p_s = (psnr(clean, torch.from_numpy(x)) for x in
                          (noisy_np, stacks["flt1"], stacks["flt2"], stacks["smo1"]))
    log(f"[9 stream] 1080p RGB T={t} sigma={SIGMA:g} fsmo, warm flow, checkpoints every 2 "
        f"frames in the background: PSNR noisy {p_n:.3f} flt1 {p_1:.3f} flt2 {p_2:.3f} "
        f"smo1 {p_s:.3f} dB; resumed after frame 1: frames 2-3 max abs diff {diff:.3e} "
        f"(<= 1e-4)")
    log(f"[9 stream] {secs:.3f} s with io and checkpoints, {t / secs:.3f} frames/s ({smi})")
    check(diff <= 1e-4, "the resumed stream differs from the uninterrupted one")
    check(p_2 >= p_n + 6.0, "streaming flt2 does not denoise by 6 dB")
    check(p_s >= p_2 - 0.3, "streaming smo1 is worse than flt2 by more than 0.3 dB")
    profile_slice(lambda: run_streaming(read, 0, t - 1, SIGMA, **kw), "9 stream profile", smi)
    return launches


def phase_cli_lsmo(smi):
    """``nlkalman-seq --smoother lsmo`` in this process on 1080p gray PNGs."""
    import re
    import runpy
    import tempfile

    from bwd_nlkalman_tpu_torch.io import write_png

    t = 3
    clean, _ = make_clip(*FULL, t, SIGMA)
    with tempfile.TemporaryDirectory() as d:
        pat = os.path.join(d, "c-%03d.png")
        for i in range(t):
            write_png(pat % (i + 1), clean[i])
        argv = sys.argv
        sys.argv = ["nlkalman-seq", pat, "1", str(t), f"{SIGMA:g}", os.path.join(d, "out"),
                    "--gt-pattern", pat, "--smoother", "lsmo"]
        counters = reset_counters()
        t0 = time.perf_counter()
        try:
            runpy.run_module("bwd_nlkalman_tpu_torch.cli.nlkalman_seq", run_name="__main__")
        except SystemExit as e:
            check(e.code == 0, f"nlkalman-seq exited {e.code}")
        finally:
            sys.argv = argv
        secs = time.perf_counter() - t0
        launches = read_counters(counters, "10 nlkalman-seq lsmo", ("K1", "K2", "K4"))
        path = os.path.join(d, "out", "measures")
        check(os.path.exists(path), "nlkalman-seq wrote no measures file")
        text = open(path).read()
    total = {m[0]: float(m[1]) for m in
             re.findall(r"^(\w+)-total RMSE \S+ PSNR (\S+)$", text, re.M)}
    log(f"[10 nlkalman-seq lsmo] 1080p gray PNGs T={t}, ground-truth mode: PSNR " +
        " ".join(f"{k} {v:.3f}" for k, v in total.items()) +
        f" dB; {secs:.3f} s with io, {t / secs:.3f} frames/s ({smi})")
    check(set(total) == {"flt1", "flt2", "smo1"}, f"measures hold {sorted(total)}")
    check(total["smo1"] >= total["flt2"] - 0.3, "lsmo smo1 is worse than flt2 by 0.3 dB")
    return launches


def dct_share(model, noisy, t, smi):
    """The whole-image DCT's matrix products in the DCT pyramid's run: a
    decompose and a recompose of 1080p gray timed alone (CUDA events), and
    the run's count of each: 3T - 2 decomposes (the noisy frame, and flt1
    and flt2 after the first) and 3T recomposes (flt1, flt2, smo1)."""
    from bwd_nlkalman_tpu_torch.ops.dct import dct2_image
    from bwd_nlkalman_tpu_torch.ops.pyramid import dct_decompose, dct_recompose
    from bwd_nlkalman_tpu_torch.tools.k1_bench import cuda_ms

    bases = dict(model.named_buffers())
    frame = noisy[0]
    levels = dct_decompose(frame, model.levels, bases=bases)
    dec_ms = cuda_ms(lambda: dct_decompose(frame, model.levels, bases=bases), 10)
    rec_ms = cuda_ms(lambda: dct_recompose(levels, model.rec, bases), 10)
    one_ms = cuda_ms(lambda: dct2_image(frame, bases), 10)
    h, w = frame.shape[:2]
    run_ms = (3 * t - 2) * dec_ms + 3 * t * rec_ms
    log(f"[11 multiscale dct] whole-image DCT of {h}x{w} gray: {one_ms:.3f} ms "
        f"({2 * h * w * (h + w) / one_ms / 1e9:.1f} TFLOP/s of fp32 matmul); a "
        f"{model.levels}-level decompose {dec_ms:.3f} ms, a recompose {rec_ms:.3f} ms; "
        f"the run's {3 * t - 2} decomposes and {3 * t} recomposes {run_ms:.1f} ms ({smi})")


def phase_multiscale(smi):
    """Both multiscale pyramids on 1080p gray at the automatic 3 levels."""
    import torch
    from bwd_nlkalman_tpu_torch.pipeline import MultiscaleDenoiser

    t, (h, w) = 3, FULL
    clean_np, noisy_np = make_clip(h, w, t, SIGMA)
    clean = torch.from_numpy(clean_np).cuda()
    noisy = torch.from_numpy(noisy_np).cuda()
    out = {}
    for pyramid in ("dct", "lz3"):
        model = MultiscaleDenoiser(SIGMA, h, w, pyramid=pyramid)
        check(model.levels == 3, f"{model.levels} levels at 1080p")
        model(noisy[:2])        # warm-up
        torch.cuda.synchronize()
        counters = reset_counters()
        t0 = time.perf_counter()
        flt1, flt2, smo1 = model(noisy)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        tag = f"11 multiscale {pyramid}"
        launches = read_counters(counters, tag, ("K1", "K2", "K4", "G"))
        for name, x in (("flt1", flt1), ("flt2", flt2), ("smo1", smo1)):
            check(x.shape == noisy.shape and bool(torch.isfinite(x).all()),
                  f"{tag} {name} bad")
        p_n, p_1, p_2, p_s = (psnr(clean, x) for x in (noisy, flt1, flt2, smo1))
        # two filter passes per level and frame, one smoother pass per level
        # and frame but the last
        want_k1 = 2 * model.levels * t + model.levels * (t - 1)
        log(f"[{tag}] 1080p gray T={t} sigma={SIGMA:g} {model.levels} levels: PSNR noisy "
            f"{p_n:.3f} flt1 {p_1:.3f} flt2 {p_2:.3f} smo1 {p_s:.3f} dB; K1 passes "
            f"{launches['K1']} (3 levels: {want_k1})")
        log(f"[{tag}] {secs:.3f} s, {t / secs:.3f} frames/s ({smi})")
        check(p_s >= p_n + 6.0, f"{tag} smo1 does not denoise by 6 dB")
        check(launches["K1"] == want_k1, f"{tag}: K1 ran {launches['K1']} passes")
        profile_slice(lambda: model(noisy), f"{tag} profile", smi)
        if pyramid == "dct":
            dct_share(model, noisy, t, smi)
        out[pyramid] = launches
        del model, flt1, flt2, smo1
        torch.cuda.empty_cache()
    return out


def phase_cli_frame(smi):
    """The per-frame commands at full width, in this process through each
    command's ``main`` (what ``python -m`` runs), on 1080p RGB PNG frames:
    ``tvl1flow`` writes the backward and forward flows and their occlusion
    masks are written beside them; ``nlkalman-flt`` filters frame 0, then
    frame 1 with both passes along the backward flow (``--flt10``,
    ``--flt20``, ``-o``, ``-k``), then ``nlkalman-smo`` smooths frame 0 along
    the forward flow. Then ``--f1_p 7 --f2_p 0`` on a 270x480 crop must take
    the plain route with its warning, and ``--f1_p 4`` at 1080p must run
    K1; ``awgn``, ``psnr``, ``decompose`` and ``recompose`` run once each."""
    import tempfile
    import warnings

    import torch
    from bwd_nlkalman_tpu_torch.cli import (awgn, decompose, nlkalman_flt, nlkalman_smo,
                                            recompose, tvl1flow)
    from bwd_nlkalman_tpu_torch.cli import psnr as psnr_cli
    from bwd_nlkalman_tpu_torch.core.nlkalman import PLAIN_PASSES
    from bwd_nlkalman_tpu_torch.flow import occlusion_mask
    from bwd_nlkalman_tpu_torch.io import read_flo, read_image, write_png

    def run(main, argv):
        rc = main(argv)
        check(rc == 0, f"{main.__module__} {' '.join(argv)} exited {rc}")

    def reset():
        PLAIN_PASSES.reset()
        return reset_counters()

    clean, noisy = make_clip(*FULL, 2, SIGMA, channels=3)
    with tempfile.TemporaryDirectory() as d:
        f = lambda n: os.path.join(d, n)  # noqa: E731
        for i in range(2):
            write_png(f(f"n{i}.png"), noisy[i])
        write_png(f("c1.png"), clean[1])
        t0 = time.perf_counter()
        run(tvl1flow.main, [f("n1.png"), f("n0.png"), f("b.flo")])
        run(tvl1flow.main, [f("n0.png"), f("n1.png"), f("f.flo")])
        for flo, occ in (("b.flo", "b.png"), ("f.flo", "f.png")):
            u = torch.from_numpy(read_flo(f(flo))).cuda()
            write_png(f(occ), occlusion_mask(u, 0.75).cpu().numpy())
        run(nlkalman_flt.main, ["-i", f("n0.png"), "--flt11", f("f10.tif"),
                                "--flt21", f("f20.tif"), "-s", f"{SIGMA:g}"])
        t_prep = time.perf_counter() - t0
        counters = reset()
        t0 = time.perf_counter()
        run(nlkalman_flt.main, ["-i", f("n1.png"), "-o", f("b.flo"), "-k", f("b.png"),
                                "--flt10", f("f10.tif"), "--flt20", f("f20.tif"),
                                "--flt11", f("f11.tif"), "--flt21", f("f21.tif"),
                                "-s", f"{SIGMA:g}"])
        t_flt = time.perf_counter() - t0
        run(nlkalman_smo.main, ["--flt1", f("f20.tif"), "--smo0", f("f21.tif"),
                                "-o", f("f.flo"), "-k", f("f.png"), "--smo1", f("s10.tif"),
                                "-s", f"{SIGMA:g}"])
        t_smo = time.perf_counter() - t0 - t_flt
        launches = read_counters(counters, "12 per-frame commands", ("K1", "K4"))
        flt21, smo10 = read_image(f("f21.tif")), read_image(f("s10.tif"))
        n1 = read_image(f("n1.png"))
        for name, x in (("flt21", flt21), ("smo10", smo10)):
            check(x.shape == FULL + (3,) and np.isfinite(x).all(), f"{name} bad")
        c1 = torch.from_numpy(clean[1])
        p_n, p_f = psnr(c1, torch.from_numpy(n1)), psnr(c1, torch.from_numpy(flt21))
        log(f"[12 per-frame commands] 1080p RGB PNGs: tvl1flow x2 with occlusion masks and "
            f"nlkalman-flt on frame 0 {t_prep:.3f} s; nlkalman-flt on frame 1 (both passes, "
            f"flt10/flt20 warped along -o with -k) {t_flt:.3f} s, nlkalman-smo {t_smo:.3f} s, "
            f"with io; PSNR noisy {p_n:.3f} flt21 {p_f:.3f} dB; K1 {launches['K1']} (3), K4 "
            f"{launches['K4']} (3, C=3), plain-route passes {PLAIN_PASSES.count} ({smi})")
        check(p_f >= p_n + 6.0, "nlkalman-flt flt21 does not denoise by 6 dB")
        check(launches["K1"] == 3 and launches["K4"] == 3, "per-frame K1 / K4 launches")
        check(PLAIN_PASSES.count == 0, "a default per-frame pass took the plain route")

        # an odd patch size: the plain route, by rule and warned
        write_png(f("crop.png"), noisy[1][:MID[0], :MID[1]])
        counters = reset()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run(nlkalman_flt.main, ["-i", f("crop.png"), "--f1_p", "7", "--f2_p", "0",
                                    "--flt11", f("c11.tif"), "-s", f"{SIGMA:g}"])
        said = [str(w.message) for w in caught if "plain PyTorch" in str(w.message)]
        k1 = counters["K1"].count
        log(f"[12 per-frame commands] --f1_p 7 --f2_p 0 on {MID[0]}x{MID[1]}: K1 {k1} (0), "
            f"plain-route passes {PLAIN_PASSES.count} (1); warning: {said}")
        check(k1 == 0 and PLAIN_PASSES.count == 1 and said, "psz 7 did not take the plain route")
        check(np.isfinite(read_image(f("c11.tif"))).all(), "psz 7 output bad")
        # an even patch size K1 takes now
        counters = reset()
        run(nlkalman_flt.main, ["-i", f("n1.png"), "-o", f("b.flo"), "-k", f("b.png"),
                                "--flt10", f("f10.tif"), "--flt20", f("f20.tif"),
                                "--f1_p", "4", "--flt21", f("p4.tif"), "-s", f"{SIGMA:g}"])
        k1 = counters["K1"].count
        p_4 = psnr(c1, torch.from_numpy(read_image(f("p4.tif"))))
        log(f"[12 per-frame commands] --f1_p 4 at 1080p RGB: K1 {k1} (2), plain-route passes "
            f"{PLAIN_PASSES.count} (0), PSNR flt21 {p_4:.3f} dB")
        check(k1 == 2 and PLAIN_PASSES.count == 0, "--f1_p 4 did not run K1")
        # the io and measure commands, once each
        t0 = time.perf_counter()
        run(awgn.main, [f"{SIGMA:g}", f("c1.png"), f("a.tif"), "--seed", "1"])
        run(psnr_cli.main, [f("c1.png"), f("a.tif")])
        run(decompose.main, [f("n1.png"), f("lv"), "3", ".tif"])
        run(recompose.main, [f("lv"), "3", ".tif", f("r.tif")])
        rec = read_image(f("r.tif"))
        log(f"[12 per-frame commands] awgn, psnr, decompose (3 levels), recompose on one "
            f"1080p RGB frame: {time.perf_counter() - t0:.3f} s with io; recomposed PSNR "
            f"against the noisy frame {psnr(torch.from_numpy(n1), torch.from_numpy(rec)):.3f} dB")
        check(rec.shape == FULL + (3,) and np.isfinite(rec).all(), "recompose output bad")


PROTO = (400, 400)      # the training protocol's crops (SURVEY.md:370): 400x400 gray
PROTO_T = 20            # frames a clip, PSNR from frame 11 (first_frame=10)


def protocol_clip(seed):
    """A 400x400 gray clip of 20 frames (T, H, W, 1): bench.py's structured
    field translated by (2, 1) pixels a frame, which never wraps."""
    (h, w), t = PROTO, PROTO_T
    rng = np.random.default_rng(seed)
    base = np.cumsum(np.cumsum(rng.standard_normal((h + 2 * t, w + t)), axis=0), axis=1)
    base = ((base - base.min()) / (base.max() - base.min()) * 175 + 40).astype(np.float32)
    return np.stack([base[2 * i: 2 * i + h, i: i + w] for i in range(t)])[..., None]


def phase_search(smi):
    """The parameter-search harness (``bwd_nlkalman_tpu_torch.train``) at the
    training protocol's size: 2 gray clips of 400x400, 20 frames, sigma=20,
    PSNR from frame 11 with a 10-pixel border. Fixtures into a temporary
    cache (then read back, no K2); random search on them; one trial with
    LAMBDA_DISTANCE on the plain route; the line, coordinate, gradient and
    2-D grid searches without fixtures; ``view_results`` and ``plambda`` on
    what they wrote. Every K1, K2 and K4 count must equal its formula, K3
    none; the default trial with the kernels within 0.05 dB of the plain
    versions; K1 at the searches' extreme parameters against its plain pass;
    each table row must parse back to the parameters that ran."""
    import contextlib
    import io
    import tempfile
    import warnings

    import torch
    from bwd_nlkalman_tpu_torch.cli import plambda as plambda_cli
    from bwd_nlkalman_tpu_torch.core.engine import dense_pass_v2
    from bwd_nlkalman_tpu_torch.core.engine_cuda import dense_pass_cuda
    from bwd_nlkalman_tpu_torch.core.nlkalman import PLAIN_PASSES
    from bwd_nlkalman_tpu_torch.flow.tvl1 import num_scales
    from bwd_nlkalman_tpu_torch.io import write_png
    from bwd_nlkalman_tpu_torch.params import FilterMode, default_params
    from bwd_nlkalman_tpu_torch.tools.k1_bench import nlk_inputs, search_cases
    from bwd_nlkalman_tpu_torch.train import (Fixtures, ascii_landscape, best_rows,
                                              cached_fixtures, coordinate_descent, evaluate,
                                              gradient_descent, grid_search_2d, line_search,
                                              load_table, random_search)
    from bwd_nlkalman_tpu_torch.train.view_results import COLUMNS

    (h, w), t, n_clips = PROTO, PROTO_T, 2
    tag = "13 search"
    clips = [protocol_clip(seed) for seed in range(n_clips)]
    seeds = [[1000 * si + i for i in range(t)] for si in range(n_clips)]
    defaults = [default_params(SIGMA, m) for m in (FilterMode.FLT1, FilterMode.FLT2,
                                                   FilterMode.SMO1)]
    levels = num_scales(w, h, 100, 0.5) - 1      # K2 levels of an fscale=1 flow
    # launches a clip: a filtered frame 2 K1 and, after frame 0, 1 K4 (C=2);
    # a smoothed frame 1 K1 and 1 K4; without fixtures a flow per K4 warp
    k1_flt, k1_smo, k4_flt = 2 * t, t - 1, t - 1

    def expect(launches, what, k1, k4, k2):
        want = {"K1": k1, "K2": k2, "K3": 0, "K4": k4}
        got = {k: launches[k] for k in want}
        log(f"[{tag}] {what}: launches {got}, formula {want}")
        check(got == want, f"{what}: launches {got}, formula {want}")

    # K1 at the searches' extreme parameters, against its plain pass
    rng = np.random.default_rng(40)
    cur, prev, valid, basic = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                               for a in nlk_inputs(rng, h, w, 1))
    for name, mode, has_prev, has_basic, p in search_cases():
        args = (cur, prev if has_prev else torch.zeros_like(cur),
                valid if has_prev else torch.zeros_like(valid),
                basic if has_basic else cur, SIGMA, p, mode, has_prev, has_basic)
        got, want = dense_pass_cuda(*args), dense_pass_v2(*args)
        diff = (got - want).abs()
        share = float((diff > 5e-2 + 1e-3 * want.abs()).sum()) / want.numel()
        mean = float(diff.mean())
        log(f"[{tag}] K1 {name} ({mode}, np_x {p.npatches_x}, np_t {p.npatches_t}, nagg "
            f"{p.npatches_tagg}, beta_x {p.beta_x:g}, beta_t {p.beta_t:g}) {h}x{w} gray: "
            f"max abs err {float(diff.max()):.3e}, mean {mean:.3e} (<= {K1_FULL_MEAN:g}), "
            f"share beyond rtol 1e-3 / atol 5e-2 {share:.2e} (<= {K1_FULL_SHARE:g})")
        check(share <= K1_FULL_SHARE and mean <= K1_FULL_MEAN, f"K1 {name} off its plain pass")
    del cur, prev, valid, basic, got, want, diff

    with tempfile.TemporaryDirectory() as d:
        cache, table = os.path.join(d, "fixtures"), os.path.join(d, "results.txt")
        ran = []        # every TrialResult whose row was written to the table

        # fixtures: the noisy-frame flows both ways, then the cache read back
        counters = reset_counters()
        secs = []
        for si in range(n_clips):
            t0 = time.perf_counter()
            cached_fixtures(cache, f"clip{si}", clips[si], SIGMA, seeds[si])
            secs.append(time.perf_counter() - t0)
        expect(read_counters(counters, tag, ("K2",)), "fixtures of 2 clips", 0, 0,
               n_clips * 2 * (t - 1) * levels)
        counters = reset_counters()
        fxs = [cached_fixtures(cache, f"clip{si}", clips[si], SIGMA, seeds[si])
               for si in range(n_clips)]
        expect({k: c.count for k, c in counters.items()}, "fixtures read from the cache",
               0, 0, 0)
        check(all(f.bflow.shape == (t, h, w, 2) and np.isfinite(f.bflow).all()
                  and f.focc.shape == (t, h, w) for f in fxs), "fixtures bad")
        log(f"[{tag}] fixtures of one {h}x{w}x{t} clip ({2 * (t - 1)} TV-L1 flows at lambda "
            f"0.2, fscale 1, and their masks, to the host): {secs[0]:.3f} s, the second clip "
            f"{secs[1]:.3f} s; mean |bflow| {float(np.abs(fxs[0].bflow).mean()):.3f} px, "
            f"occluded {100 * float((fxs[0].bocc > 0).mean()):.2f}% ({smi})")
        fx_dev = [Fixtures.to(f, "cuda") for f in fxs]     # one upload per search

        # the default parameters on the fixtures, without and with smoothing
        evaluate(clips[:1], SIGMA, *defaults, fixtures=fx_dev[:1], smoothing=False)
        torch.cuda.synchronize()    # warm-up at this size
        trial = {}
        for smoothing in (False, True):
            counters = reset_counters()
            t0 = time.perf_counter()
            r = evaluate(clips, SIGMA, *defaults, fixtures=fx_dev, smoothing=smoothing)
            trial[smoothing] = (time.perf_counter() - t0, r)
            expect(read_counters(counters, tag, ("K1", "K4")),
                   f"a fixtures trial, smoothing={smoothing}",
                   n_clips * (k1_flt + smoothing * k1_smo),
                   n_clips * k4_flt * (1 + smoothing), 0)
        for smoothing, (s, r) in trial.items():
            log(f"[{tag}] fixtures trial of the defaults, smoothing={smoothing}: {s:.3f} s, "
                f"{n_clips * t / s:.2f} frames/s inside the trial; PSNR flt1 "
                f"{r.psnr['flt1']:.3f} flt2 {r.psnr['flt2']:.3f} smo1 {r.psnr['smo1']:.3f} "
                f"dB ({smi})")
        r_def = trial[True][1]
        noisy_psnr = 10 * np.log10(255.0 ** 2 / SIGMA ** 2)
        check(r_def.psnr["smo1"] >= noisy_psnr + 6.0, "the default trial does not denoise")

        # the same trial on one clip with the kernels and with the plain versions
        res = {e: evaluate(clips[:1], SIGMA, *defaults, fixtures=fx_dev[:1], engine=e)
               for e in ("auto", "plain")}
        d_db = {k: abs(res["auto"].psnr[k] - res["plain"].psnr[k]) for k in res["auto"].psnr}
        log(f"[{tag} vs plain] default trial on one clip, fixtures: kernels " + "/".join(
            f"{res['auto'].psnr[k]:.4f}" for k in d_db) + " dB, plain " + "/".join(
            f"{res['plain'].psnr[k]:.4f}" for k in d_db) + " dB (flt1/flt2/smo1), |d| " +
            "/".join(f"{v:.4f}" for v in d_db.values()) + " (<= 0.05)")
        check(max(d_db.values()) <= 0.05, "the search trial's kernels and plain versions disagree")

        # random search on the fixtures
        counters = reset_counters()
        t0 = time.perf_counter()
        rs = random_search(clips, SIGMA, 4, table_path=table, fixtures=fx_dev)
        s_rs = time.perf_counter() - t0
        expect(read_counters(counters, tag, ("K1", "K4")), "random search, 4 trials",
               4 * n_clips * k1_flt, 4 * n_clips * k4_flt, 0)
        ran += rs
        log(f"[{tag}] random search, 4 trials on the fixtures: {s_rs / 4:.3f} s a trial; best "
            f"np {rs[0].p1.npatches_x}, beta_x {rs[0].p1.beta_x:.3f}, beta_t "
            f"{rs[0].p1.beta_t:.3f}: flt2 {rs[0].psnr['flt2']:.3f} dB ({smi})")

        # one LAMBDA_DISTANCE trial: the first pass on the plain route, warned
        counters = reset_counters()
        PLAIN_PASSES.reset()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            rl = random_search(clips[:1], SIGMA, 1, rng=np.random.default_rng(5),
                               table_path=table, fixtures=fx_dev[:1], respect_lambda=True)
        said = [str(x.message) for x in caught if "dista_lambda" in str(x.message)]
        expect({k: c.count for k, c in counters.items()}, "a respect_lambda trial, one clip",
               k1_flt - t, k4_flt, 0)
        ran += rl
        log(f"[{tag}] respect_lambda trial (lambda {rl[0].p1.dista_lambda:.3f}): plain-route "
            f"passes {PLAIN_PASSES.count} ({t}), warning {said[:1]}")
        check(PLAIN_PASSES.count == t and said, "the LAMBDA_DISTANCE pass did not take the plain route")

        # the searches without fixtures: every trial runs its flows
        per_trial = dict(k1=n_clips * (k1_flt + k1_smo), k4=n_clips * 2 * k4_flt,
                         k2=n_clips * 2 * (t - 1) * levels)

        def searched(what, run, n_trials):
            counters = reset_counters()
            t0 = time.perf_counter()
            out = run()
            secs = time.perf_counter() - t0
            n = n_trials(out)
            expect(read_counters(counters, tag, ("K1", "K2", "K4", "G")), f"{what}, {n} trials",
                   n * per_trial["k1"], n * per_trial["k4"], n * per_trial["k2"])
            log(f"[{tag}] {what}: {n} trials without fixtures, {secs / n:.3f} s a trial, "
                f"{n * n_clips * t / secs:.2f} frames/s ({smi})")
            return out

        ls = searched("line search over s1_bt", lambda: line_search(
            clips, SIGMA, "s1_bt", [3.0, 6.0], table_path=table), len)
        ran += [r for _, r in ls]
        best, hist = searched("coordinate descent over s1_nt, 1 round", lambda: (
            coordinate_descent(clips, SIGMA, fields=("s1_nt",), max_rounds=1,
                               table_path=table)), lambda out: len(out[1]))
        ran += hist[1:]
        gd, betas = searched("gradient descent over f1_bx and s1_bt, 1 step", lambda: (
            gradient_descent(clips, SIGMA, fields=("f1_bx", "s1_bt"), n_iters=1,
                             table_path=table)), lambda out: 3)
        ran += gd
        grid = searched("2-D grid over fflow_lambda x f1_bx", lambda: grid_search_2d(
            clips, SIGMA, "fflow_lambda", [0.2, 0.3], "f1_bx", [2.5, 3.5],
            table_path=table), len)
        ran += [r for _, r in grid]
        log(f"[{tag}] line search best s1_bt {ls[0][0]:g} (smo1 {ls[0][1].psnr['smo1']:.3f} "
            f"dB); coordinate descent best s1_nt {best.ps.npatches_t} (smo1 "
            f"{best.psnr['smo1']:.3f} dB); gradient step f1_bx {betas['f1_bx']:.4f}, s1_bt "
            f"{betas['s1_bt']:.4f}; grid best {grid[0][0]} (flt2 "
            f"{grid[0][1].psnr['flt2']:.3f} dB)")
        profile_slice(lambda: evaluate(clips, SIGMA, *defaults, fixtures=fx_dev),
                      f"{tag} profile, a fixtures trial with smoothing", smi)
        profile_slice(lambda: evaluate(clips, SIGMA, *defaults), f"{tag} profile, a trial "
                      "without fixtures", smi)

        # view_results and plambda on what the searches wrote
        tab = load_table(table)
        check(tab.shape == (len(ran), 16), f"table holds {tab.shape[0]} rows, {len(ran)} ran")
        for row in tab:     # each row is one trial that ran, in any order
            hit = next((r for r in ran if np.allclose(row[:13], table_params(r), rtol=0,
                                                      atol=5e-4)
                        and np.allclose(row[13:], [r.mse[k] for k in ("flt1", "flt2", "smo1")],
                                        rtol=0, atol=5e-5, equal_nan=True)), None)
            check(hit is not None, f"a table row {row.tolist()} is no trial that ran")
            ran = [r for r in ran if r is not hit]
        (sig, row, best_db), = best_rows(tab, "f2_mse")
        land = ascii_landscape(tab, "f1_nx", "f1_bx", "f2_mse", bins=8)
        log(f"[{tag}] view_results: {tab.shape[0]} rows parse back to the parameters that "
            f"ran; best f2_mse at sigma {sig:g}: {row[COLUMNS.index('f2_mse')]:.4f} "
            f"({best_db:.3f} dB); landscape: {land.splitlines()[0]}")
        check(len(land.splitlines()) == 10, "ascii_landscape gave no 8-bin map")

        def cli(argv):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                check(plambda_cli.main(argv) == 0, f"plambda {argv} failed")
            return buf.getvalue().split()

        m = r_def.mse["smo1"]
        calc = float(cli(["-c", "255", repr(m), "sqrt", "/", "log10", "20", "*"])[0])
        write_png(os.path.join(d, "clean.png"), clips[0][t - 1])
        write_png(os.path.join(d, "noisy.png"), fxs[0].noisy[t - 1])
        sq = cli([os.path.join(d, "clean.png"), os.path.join(d, "noisy.png"), "x y - 2 ^"])
        q = lambda a: np.clip(np.round(a.astype(np.float64)), 0, 255)  # noqa: E731
        mse_png = float(np.mean((q(clips[0][t - 1]) - q(fxs[0].noisy[t - 1])) ** 2))
        log(f"[{tag}] plambda -c on the default trial's smo1 MSE {m:.4f}: {calc:g} dB "
            f"(trial {r_def.psnr['smo1']:.4f}, one sequence: {10 * np.log10(255 ** 2 / m):.4f}); "
            f"plambda 'x y - 2 ^' on two {h}x{w} PNGs: mean {sq[0]} (numpy {mse_png:.4f})")
        check(abs(calc - 10 * np.log10(255.0 ** 2 / m)) <= 1e-3, "plambda -c disagrees")
        check(abs(float(sq[0]) - mse_png) <= 1e-3 * mse_png, "plambda on the PNGs disagrees")


def table_params(r):
    """The 13 parameter columns of ``r``'s results-table row, as numbers."""
    return [r.sigma, r.p1.npatches_x, r.p1.beta_x, r.p1.npatches_t, r.p1.npatches_tagg,
            r.p1.beta_t, r.p2.npatches_x, r.p2.beta_x, r.p2.npatches_t,
            r.p2.npatches_tagg, r.p2.beta_t, r.ps.npatches_t, r.ps.beta_t]


SHARD_MID = (272, 480)  # 136- and 68-row blocks at sp 2 and 4
# K1's shard passes against the plain pass with its own bands, by the
# shares of the sums (or of the whole frame's pixels) beyond K1's bar and
# their mean abs error: selection ties there move a group of the RGB
# float32 flt2 pass
K1_SHARD_SHARE = 1e-3   # 3.2e-4 at most measured
K1_SHARD_MEAN = 2e-4    # 8.6e-5 at most measured


def phase_sharded(smi, slice1):
    """14. The row-sharded passes on one card: K1's sharded arguments against
    the plain pass on every shard, the sharded 1080p passes against K1's
    whole-frame pass and timed, the sharded flows against the whole-frame
    flows and K2's, K3's and K4's shard forms against their plain versions
    (``sharded_flows``), the sharded sequence against slice 1, the batch
    over dp, and the multichip dry run."""
    import torch
    from bwd_nlkalman_tpu_torch.core.engine import dense_pass_v2, nlk_bases
    from bwd_nlkalman_tpu_torch.core.engine_cuda import dense_pass_cuda
    from bwd_nlkalman_tpu_torch.core.nlkalman import PLAIN_PASSES
    from bwd_nlkalman_tpu_torch.ops.bases import make_bases
    from bwd_nlkalman_tpu_torch.parallel import (denoise_sequence_sharded, dryrun_multichip,
                                                 make_mesh, spatial_filter_frame,
                                                 spatial_smooth_frame)
    from bwd_nlkalman_tpu_torch.parallel.flow import STATS as FLOW_STATS
    from bwd_nlkalman_tpu_torch.parallel.spatial import (_halo_extend, _halo_fold,
                                                         shard_bounds, shard_halo)
    from bwd_nlkalman_tpu_torch.params import FilterMode, default_params
    from bwd_nlkalman_tpu_torch.pipeline import FlowConfig, denoise_batch
    from bwd_nlkalman_tpu_torch.pipeline.sequence import pipeline_bases
    from bwd_nlkalman_tpu_torch.tools.k1_bench import (cuda_ms, k1_bands, k1_order, nlk_inputs,
                                                       pass_args)

    # (a) K1 with site_rows / qy_bounds / return_accum on every shard's
    # halo-extended block against the plain pass with the same arguments,
    # the sums scaled by the largest weight (so in pixel units) and the
    # weights by it, at K1's bar (rtol 1e-3; atol 5e-2 on the sums,
    # 5e-2/255 on the weights). The plain pass sums its distances in K1's
    # order and, for float32 bands, takes K1's bands (k1_order, k1_bands).
    # Against the plain pass with its own bands, the psz-8 RGB float32 pass
    # (whose K1 bands keep fused multiply-adds) has selection ties at this
    # size that move a group, so that comparison is held by share and mean
    # (K1_SHARD_SHARE, K1_SHARD_MEAN), for each shard's sums and for the
    # whole frame. Then the folded shards against K1's whole-frame pass at
    # the JAX package's sharded bar (rtol 1e-4, atol 2e-3,
    # tests/test_parallel.py): the same kernel on the same bands, so only
    # the order of the fold's sums differs
    def plain(args, wdt, own_bands=False, **kw):
        with k1_order(), (k1_bands() if wdt == "float32" and not own_bands
                          else contextlib.nullcontext()):
            return dense_pass_v2(*args, window_dtype=wdt, **kw)

    def past(got, want):
        """(share of ``got`` past K1's bar around ``want``, max abs error,
        mean abs error)."""
        d = (got - want).abs()
        return (float((d > 5e-2 + 1e-3 * want.abs()).sum()) / d.numel(), float(d.max()),
                float(d.mean()))

    rng = np.random.default_rng(14)
    kb = make_bases(nlk_bases(8), "cuda")
    h, w = SHARD_MID
    worst, worst_fold, worst_own = 0.0, 0.0, [0.0, 0.0]
    for ch in (1, 3):
        cur, prev, valid, basic = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                                   for a in nlk_inputs(rng, h, w, ch))
        for name, args in pass_args(cur, prev, valid, basic, kb).items():
            if name not in ("flt2", "smo1"):
                continue
            p, mode, has_prev, has_basic = args[5:9]
            halo = shard_halo(p, mode)
            for wdt, sp in itertools.product(("float32", "bfloat16"), (2, 4)):
                block = h // sp
                ext = [_halo_extend([x[i * block:(i + 1) * block] for i in range(sp)], halo)
                       for x in args[:4]]
                outs, aggs, errs, own = [], [], [], []
                for i in range(sp):
                    site_rows, qy = shard_bounds(i, block, halo, h, p.patch_sz)
                    sargs = tuple(e[i].contiguous() for e in ext) + args[4:]
                    kw = dict(site_rows=site_rows, qy_bounds=qy, return_accum=True)
                    out, agg = dense_pass_cuda(*sargs, window_dtype=wdt, **kw)
                    want_out, want_agg = plain(sargs, wdt, **kw)
                    sc = float(want_agg.max())
                    check(sc > 0.0, f"K1 shard {i}/{sp}: no weight at all")
                    own.append(past(out / sc, plain(sargs, wdt, True, **kw)[0] / sc))
                    errs.append((max_err(out / sc, want_out / sc),
                                 max_err(agg / sc, want_agg / sc)))
                    tag = f"K1 {name} ch={ch} {wdt} shard {i}/{sp}"
                    assert_close(f"{tag} out_acc", out / sc, want_out / sc, rtol=1e-3,
                                 atol=5e-2)
                    assert_close(f"{tag} agg", agg / sc, want_agg / sc, rtol=1e-3,
                                 atol=5e-2 / 255)
                    outs.append(out)
                    aggs.append(agg)
                outs, aggs = _halo_fold(outs, halo), _halo_fold(aggs, halo)
                got = torch.cat([torch.where((a > 1e-6)[..., None],
                                             o / torch.clamp(a, min=1e-6)[..., None],
                                             args[0][i * block:(i + 1) * block])
                                 for i, (o, a) in enumerate(zip(outs, aggs))])
                whole = dense_pass_cuda(*args, window_dtype=wdt)
                own.append(past(whole, plain(args, wdt, True)))
                fold_err = max_err(got, whole)
                worst = max([worst] + [e for pair in errs for e in pair])
                worst_fold = max(worst_fold, fold_err)
                log(f"[14 K1 shards] {name} ch={ch} {wdt} {h}x{w} sp={sp} (block {block}, "
                    f"halo {halo}): each shard's out_acc / agg against the plain pass, max "
                    f"abs err scaled by the largest weight " + ", ".join(
                        f"{a:.2e} / {b:.2e}" for a, b in errs) + " (rtol 1e-3, atol 5e-2 / "
                    f"5e-2/255); the whole frame's K1 against the plain pass "
                    f"{max_err(whole, plain(args, wdt)):.3e}; against the plain pass with its "
                    f"own bands, share past the bar / max / mean of each shard's out_acc "
                    + ", ".join(f"{a:.1e} / {b:.2e} / {c:.2e}" for a, b, c in own[:-1])
                    + ", the whole frame's %.1e / %.2e / %.2e" % own[-1]
                    + f" (share <= {K1_SHARD_SHARE:g}, mean <= {K1_SHARD_MEAN:g}); folded "
                    f"shards against K1's whole pass {fold_err:.3e} (rtol 1e-4, atol 2e-3)")
                worst_own = [max(a, b) for a, b in zip(worst_own, (max(o[0] for o in own),
                                                                   max(o[2] for o in own)))]
                check(worst_own[0] <= K1_SHARD_SHARE and worst_own[1] <= K1_SHARD_MEAN,
                      f"K1 {name} ch={ch} {wdt} sp={sp} off the plain pass with its own bands")
                assert_close(f"K1 {name} ch={ch} {wdt} sp={sp} folded", got, whole,
                             rtol=1e-4, atol=2e-3)
    log(f"[14 K1 shards] largest error against the plain pass {worst:.3e}, of the folded "
        f"shards against K1's whole pass {worst_fold:.3e}; against the plain pass with its "
        f"own bands, largest share past the bar {worst_own[0]:.2e}, largest mean error "
        f"{worst_own[1]:.2e}")

    # (b) 1080p gray at the production parameters: the sharded filter
    # (flt1 with a previous frame and its validity) and smoother passes on
    # [cuda:0] * sp, against and timed beside K1's whole-frame pass
    cur, prev, valid, basic = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                               for a in nlk_inputs(np.random.default_rng(0), *FULL, 1))
    p1, ps = default_params(SIGMA, FilterMode.FLT1), default_params(SIGMA, FilterMode.SMO1)
    counters = reset_counters()
    runs = {"flt1": (lambda m: spatial_filter_frame(cur, prev, valid, None, SIGMA, p1, m,
                                                    bases=kb),
                     lambda: dense_pass_cuda(cur, prev, valid, cur, SIGMA, p1, "filter",
                                             True, False, kb)),
            "smo1": (lambda m: spatial_smooth_frame(cur, prev, valid, SIGMA, ps, m, bases=kb),
                     lambda: dense_pass_cuda(cur, prev, valid, cur, SIGMA, ps, "smooth",
                                             True, False, kb))}
    for name, (sharded, whole) in runs.items():
        want = whole()
        w_ms = cuda_ms(whole, 5)
        p = p1 if name == "flt1" else ps
        mode = "filter" if name == "flt1" else "smooth"
        for sp in (1, 2, 3):
            mesh = make_mesh(1, sp, ["cuda:0"] * sp)
            counters["K1"].reset()
            got = sharded(mesh)
            torch.cuda.synchronize()
            n_k1 = counters["K1"].count
            err = max_err(got, want)
            s_ms = cuda_ms(lambda: sharded(mesh), 5)
            # the bound of each shard's K1 launch: its own sites over its
            # halo-extended block (the DCT and the fold cover the block)
            halo, block = shard_halo(p, mode), FULL[0] // sp
            ext = [_halo_extend([x[i * block:(i + 1) * block] for i in range(sp)], halo)
                   for x in (cur, valid)]
            sb = [shard_bounds(i, block, halo, FULL[0], p.patch_sz) for i in range(sp)]
            work = [k1_work(ext[0][i], ext[1][i], p, mode, True, False,
                            site_rows=sb[i][0], qy_bounds=sb[i][1]) for i in range(sp)]
            b_ms = [bound(fl, nb)[0] for fl, nb, _ in work]
            bb_ms = [bound(fl, nbb)[0] for fl, _, nbb in work]
            log(f"[14 sharded 1080p] {name} sp={sp} on cuda:0 x {sp}: {s_ms:.3f} ms per "
                f"sharded pass between events (whole-frame K1 pass {w_ms:.3f} ms), max abs "
                f"diff from it {err:.3e} (rtol 1e-4, atol 2e-3), K1 launches {n_k1} "
                f"(= sp); bound of each shard's launch " + ", ".join(
                    f"{b:.3f}" for b in b_ms) + f" ms ({bound(*work[0][:2])[1]}), with the "
                f"bands in device memory " + ", ".join(f"{b:.3f}" for b in bb_ms)
                + f" ms, {sum(b_ms):.3f} / {sum(bb_ms):.3f} ms a pass ({smi})")
            check(n_k1 == sp, f"sharded {name} sp={sp}: K1 ran {n_k1} times")
            assert_close(f"sharded {name} sp={sp}", got, want, rtol=1e-4, atol=2e-3)
        del want, got
    del cur, prev, valid, basic
    torch.cuda.empty_cache()

    sharded_flows(smi)

    # (c) the sharded sequence on slice 1's clip and flow configuration
    t, (h, w) = 4, FULL
    clean_np, noisy_np = make_clip(h, w, t, SIGMA)
    clean = torch.from_numpy(clean_np).cuda()
    noisy = torch.from_numpy(noisy_np).cuda()
    cfg = FlowConfig(warm_start=True, warm_nwarps=3)
    # the constants built once, as slice 1's module holds them
    seq_bases = make_bases(pipeline_bases(h, w, (cfg,), [default_params(SIGMA, m) for m in
                                                         FilterMode]), "cuda")
    n_cards = torch.cuda.device_count()
    layouts = [(sp, ["cuda:0"] * sp) for sp in (2, 3)]
    if n_cards > 1:
        layouts += [(sp, [f"cuda:{i}" for i in range(sp)]) for sp in (2, 3) if sp <= n_cards]
    for sp, devs in layouts:
        mesh = make_mesh(1, sp, devs)
        where = "cuda:0 x %d" % sp if len(set(devs)) == 1 else f"{sp} cards"
        run = lambda: denoise_sequence_sharded(noisy, SIGMA, mesh, flow_cfg=cfg,  # noqa: E731
                                               bases=seq_bases)
        run()                   # warm-up: the shards' constants, allocator
        torch.cuda.synchronize()
        counters = reset_counters()
        PLAIN_PASSES.reset()
        FLOW_STATS.reset()
        t0 = time.perf_counter()
        flt1, flt2, smo1 = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counters(counters, f"14 sharded sequence sp={sp}", ("K1", "K2", "K4"))
        st = FLOW_STATS
        for name, x in (("flt1", flt1), ("flt2", flt2), ("smo1", smo1)):
            check(x.shape == noisy.shape and bool(torch.isfinite(x).all()),
                  f"sharded {name} is not finite frames of the clip's shape")
        p_2, p_s = psnr(clean, flt2), psnr(clean, smo1)
        d2, ds = p_2 - slice1["psnr"][0], p_s - slice1["psnr"][1]
        log(f"[14 sharded sequence] 1080p gray T={t} warm flow, sp={sp} on {where}: PSNR "
            f"flt2 {p_2:.4f} smo1 {p_s:.4f} dB (slice 1 {slice1['psnr'][0]:.4f} / "
            f"{slice1['psnr'][1]:.4f}; d {d2:+.4f} / {ds:+.4f}, |d| <= 0.05); "
            f"{secs:.3f} s, {t / secs:.3f} frames/s (slice 1 {slice1['fps']:.3f}) ({smi})")
        check(abs(d2) <= 0.05 and abs(ds) <= 0.05, "sharded sequence PSNR off slice 1's")
        # every NLK pass a K1 launch a shard; a level solved whole one K2
        # launch (every level of slice 1's flow takes K2's rule), a sharded
        # one a K2 launch a shard each round issued; a warp (one a frame
        # forward and backward), a warm gate and a sharded level's warp
        # stage a K4 launch a shard
        want = {"K1": (3 * t - 1) * sp, "K2": len(st.levels_whole) + sp * st.rounds["k2"],
                "K3": 0, "K4": sp * (2 * (t - 1) + st.gates + st.stages)}
        log(f"[14 sharded sequence] sp={sp}: flow levels sharded "
            f"{sorted(set(st.levels_sharded))}, run whole by the small-level rule "
            f"{sorted(set(st.levels_whole))} ({len(st.levels_whole)} solves); rounds issued "
            f"{st.rounds['k2']} (K2), warm gates {st.gates}, sharded warp stages {st.stages}; "
            f"launches "
            f"{ {k: launches[k] for k in want} } against the formulas {want}")
        check(all(launches[k] == v for k, v in want.items()) and PLAIN_PASSES.count == 0,
              f"sharded sequence launches {launches}, expected {want} and no plain pass")
        check(st.rounds["k3"] == 0 and st.levels_sharded, "slice 1's sharded flow ran no "
              "sharded level, or a K3 round")
        profile_slice(run, f"14 sharded sequence sp={sp} profile", smi)
        del flt1, flt2, smo1
        torch.cuda.empty_cache()
    if n_cards < 2:
        log(f"[14 sharded sequence] {n_cards} card{'s' if n_cards != 1 else ''} visible: "
            "scaling across cards not measured")

    # (d) the batch over dp against the unsharded batch, and the dry run
    clips = torch.from_numpy(np.stack([make_clip(128, 160, 3, SIGMA, seed=s)[1]
                                       for s in (3, 4)])).cuda()
    got = denoise_batch(clips, SIGMA, mesh=make_mesh(2, 1, ["cuda:0"] * 2))
    want = denoise_batch(clips, SIGMA)
    err = max(max_err(g, r) for g, r in zip(got, want))
    log(f"[14 denoise_batch] 2 clips of 3 x 128x160 over dp=2 (cuda:0 x 2): max abs diff "
        f"from the unsharded batch {err:.3e} (<= 1e-4)")
    check(err <= 1e-4, "denoise_batch over dp disagrees with the unsharded batch")
    t0 = time.perf_counter()
    line = dryrun_multichip(4)
    log(f"[14 dryrun] {time.perf_counter() - t0:.1f} s ({smi})")
    check(line.startswith("dryrun_multichip OK") and "k1" in line, "dryrun_multichip failed")


SHARD_EPE = 1e-4        # the sharded flow against the whole-frame flow: K2_LEVEL_EPE's bar
SHARD_MAX = 1e-2        # and K2_LEVEL_MAX's
OCC_SHARE = 1e-4        # share of pixels whose occlusion differs between the two flows


def sharded_flows(smi):
    """14 (e). The row-sharded 1080p gray flow (``parallel/flow.py``) on
    ``[cuda:0] * sp``, sp 1-4, against the whole-frame flow: slice 1's warm
    fscale=1 step (the 540x960 level, K2's rule, after the warm gate) and
    slice 2's cold fscale=0 flow (the 1080x1920 level in K3 blocks, the
    coarser ones K2): mean EPE and max abs, the iterations (K2's device
    count) and blocks (K3's) of both, the levels run whole, K2 and K4
    launches against their formulas, the occlusion masks of both flows,
    K4's shard warps of a 2-channel frame along the whole flow against
    the whole-frame warp, and ms per flow (CUDA events, sharded beside
    whole). Then (f), the shard forms against their plain versions
    (``shard_kernels``) from the whole flows."""
    import torch
    from bwd_nlkalman_tpu_torch.flow import tvl1
    from bwd_nlkalman_tpu_torch.flow.occlusion import occlusion_mask
    from bwd_nlkalman_tpu_torch.flow.tvl1_cuda import ITERATIONS
    from bwd_nlkalman_tpu_torch.ops.bases import make_bases
    from bwd_nlkalman_tpu_torch.ops.warp import bicubic_warp
    from bwd_nlkalman_tpu_torch.parallel import make_mesh, sharded_occlusion_mask, sharded_warp
    from bwd_nlkalman_tpu_torch.parallel.flow import STATS
    from bwd_nlkalman_tpu_torch.pipeline import FlowConfig
    from bwd_nlkalman_tpu_torch.tools.k1_bench import cuda_ms

    _, noisy = make_clip(*FULL, 3, SIGMA)
    nz = torch.from_numpy(noisy[..., 0]).cuda()
    prevs = torch.from_numpy(np.ascontiguousarray(np.moveaxis(noisy[:2, ..., 0], 0, -1))).cuda()
    warm, cold = FlowConfig(warm_start=True, warm_nwarps=3), FlowConfig(fscale=0)
    fb = make_bases(tvl1.flow_bases(*FULL), "cuda")    # built once, as the modules hold them
    _, carry = warm.flow_cold_carry(nz[1], nz[0], bases=fb)
    cases = {"slice 1 warm fscale=1":
             lambda m: warm.flow_warm(nz[2], nz[1], carry, bases=fb, mesh=m)[0],
             "slice 2 cold fscale=0": lambda m: cold.flow(nz[1], nz[0], bases=fb, mesh=m)}
    flows = []
    for name, run in cases.items():
        counters = reset_counters()
        ITERATIONS.reset()
        want = run(None)
        flows.append(want)
        torch.cuda.synchronize()
        w_iters, w_blocks = ITERATIONS.count, counters["K3"].count
        w_ms = cuda_ms(lambda: run(None), 5)
        occ_w = occlusion_mask(want, 0.75)
        warp_w, valid_w = bicubic_warp(prevs, want, occ_w)
        for sp in (1, 2, 3, 4):
            mesh = make_mesh(1, sp, ["cuda:0"] * sp)
            counters = reset_counters()
            ITERATIONS.reset()
            STATS.reset()
            got = run(mesh)
            torch.cuda.synchronize()
            n = {k: counters[k].count for k in ("K2", "K3", "K4")}
            iters = ITERATIONS.count
            # a level run whole is one K2 launch (none takes K3's rule at
            # 1080p: the 1080x1920 level's shards own 270 rows or more); a
            # sharded level a K2 launch a shard each round issued; a warp
            # stage of a sharded level and a warm gate a K4 launch a shard
            check(all(tvl1.fused_level_supported(*lv) for lv in STATS.levels_whole),
                  f"sharded flow {name} sp={sp} ran a K3 level whole")
            formula = {"K2": len(STATS.levels_whole) + sp * STATS.rounds["k2"],
                       "K4": sp * (STATS.stages + STATS.gates)}
            epe = float(torch.linalg.vector_norm(got - want, dim=-1).mean())
            err = max_err(got, want)
            occ_share = float((sharded_occlusion_mask(got, mesh, 0.75) != occ_w).float().mean())
            warp_s, valid_s = sharded_warp(prevs, want, occ_w, mesh)
            warp_err = max_err(warp_s, warp_w)
            levels = (sorted(set(STATS.levels_sharded)), sorted(set(STATS.levels_whole)))
            rounds = dict(STATS.rounds)
            s_ms = cuda_ms(lambda: run(mesh), 5)
            log(f"[14 sharded flow] 1080p gray {name} sp={sp} on cuda:0 x {sp}: mean EPE "
                f"{epe:.2e} px (<= {SHARD_EPE:g}), max abs {err:.3e} (<= {SHARD_MAX:g}); "
                f"iterations K2 {iters} (whole {w_iters}), blocks K3 {n['K3']} (whole "
                f"{w_blocks}); levels sharded {levels[0]}, run whole {levels[1]}; rounds issued "
                f"{rounds}; launches K2 "
                f"{n['K2']} K4 {n['K4']} (formulas {formula}); occlusion differs at "
                f"{occ_share:.2e} of pixels (<= {OCC_SHARE:g}); K4 shard warps C=2 max abs "
                f"{warp_err:.3e} (atol 1e-3), masks equal {bool(torch.equal(valid_s, valid_w))}; "
                f"{s_ms:.3f} ms per flow sharded, {w_ms:.3f} ms whole ({smi})")
            check(epe <= SHARD_EPE and err <= SHARD_MAX, f"sharded flow {name} sp={sp} off")
            check(all(n[k] == v for k, v in formula.items()),
                  f"sharded flow {name} sp={sp}: launches {n}, formulas {formula}")
            check(occ_share <= OCC_SHARE, f"sharded occlusion {name} sp={sp} differs")
            check(warp_err <= 1e-3 and torch.equal(valid_s, valid_w),
                  f"K4 shard warps {name} sp={sp} off the whole-frame warp")
    # slice 1's warm step with bf16 duals: K2's rounds and K4's constants in
    # the bf16 rule's form on every shard, the same bits as the whole level
    warm16 = dataclasses.replace(warm, state_dtype="bfloat16")
    ITERATIONS.reset()
    want = warm16.flow_warm(nz[2], nz[1], carry, bases=fb)[0]
    w_iters = ITERATIONS.count
    mesh = make_mesh(1, 2, ["cuda:0"] * 2)
    ITERATIONS.reset()
    STATS.reset()
    got = warm16.flow_warm(nz[2], nz[1], carry, bases=fb, mesh=mesh)[0]
    iters = ITERATIONS.count
    epe32 = float(torch.linalg.vector_norm(want - flows[0], dim=-1).mean())
    log(f"[14 sharded flow] 1080p gray slice 1 warm fscale=1 with bf16 duals sp=2 on cuda:0 "
        f"x 2: same bits as the whole-frame bf16 step {bool(torch.equal(got, want))} (max abs "
        f"{max_err(got, want):.3e}); iterations K2 {iters} (whole {w_iters}); levels sharded "
        f"{sorted(set(STATS.levels_sharded))}; the bf16 step against the float32 step mean "
        f"EPE {epe32:.3e} px ({smi})")
    check(bool(torch.equal(got, want)), "sharded bf16 warm step differs from the whole frame's")
    check(STATS.rounds["k2"] > 0, "sharded bf16 warm step ran no K2 round")
    shard_kernels(nz, fb, prevs, flows, smi)
    torch.cuda.empty_cache()


SHARD_OWN_ATOL = 2e-3   # a round's owned rows against its plain version (k iterations)
SHARD_SUM_RTOL = 1e-3   # and the owned rows' sum


def _nig_as_grad(cs):
    """K2's constants with nig = -1/|grad|^2 held as the |grad|^2 it comes
    from: a small gradient's last bits move its inverse by more than any
    fixed bar (tests/test_torch_kernels_cuda.py does the same)."""
    import torch

    return torch.cat([cs[:2], torch.where(cs[2:3] != 0, -1.0 / cs[2:3], 0.0), cs[3:]])


def shard_kernels(nz, fb, prevs, flows, smi):
    """14 (f). The shard forms on the card against their plain versions at
    the main path's shapes, on every shard of sp 2-4, from a real
    mid-level state: the level's flow (slice 1's warm flow halved onto the
    540x960 level, for K2's round of 8; slice 2's cold flow on the
    1080x1920 level, for K3's round of 24) with the duals of k whole-level
    plain iterations from it. Per shard, K4's TV-L1 entry on the block
    (K2's form, nig, and K3's; y0 > 0 but on the first shard) against its
    plain version (rtol 1e-5, atol 1e-3; nig held as |grad|^2), then the
    round entry on the block with the kernel's constants against the plain
    round (owned rows atol SHARD_OWN_ATOL, the owned sum rtol
    SHARD_SUM_RTOL), and K4's shard warp (C=2, the cold flow and its
    occlusion) against the plain warp with the same y0 (atol 1e-3, equal
    masks). Then one launch of each at sp=2's first shard, timed beside the
    plain version and the bound (each input read once, each output written
    once)."""
    import torch
    from bwd_nlkalman_tpu_torch.flow import tvl1
    from bwd_nlkalman_tpu_torch.flow.occlusion import occlusion_mask
    from bwd_nlkalman_tpu_torch.flow.tvl1_block_cuda import tvl1_stage_round_cuda
    from bwd_nlkalman_tpu_torch.flow.tvl1_cuda import tvl1_level_round_cuda
    from bwd_nlkalman_tpu_torch.flow.tvl1_fused import tvl1_level_round_plain
    from bwd_nlkalman_tpu_torch.flow.tvl1_tile import RoundCtl
    from bwd_nlkalman_tpu_torch.flow.tvl1_tiled import (centered_gradient, tvl1_stage_consts,
                                                        tvl1_stage_round_plain)
    from bwd_nlkalman_tpu_torch.ops.warp import bicubic_warp, bicubic_warp_plain
    from bwd_nlkalman_tpu_torch.parallel.flow import row_bounds

    a, b = tvl1._prep_pair(nz[1], nz[0], fb)
    warm, cold = flows
    rows = {}
    half = (tvl1.zoom_out(a, 0.5, fb), tvl1.zoom_out(b, 0.5, fb))
    for name, (img0, img1), u, k, k2, sd in (
            ("K2 round of 8, 540x960 level", half, 0.5 * warm[::2, ::2], 8, True, "float32"),
            ("K2 round of 8 with bf16 duals, 540x960 level", half, 0.5 * warm[::2, ::2], 8,
             True, "bfloat16"),
            ("K3 round of 24, 1080x1920 level", (a, b), cold, 24, False, "float32")):
        h, w = img0.shape
        kern, plain = ((tvl1_level_round_cuda, tvl1_level_round_plain) if k2 else
                       (tvl1_stage_round_cuda, tvl1_stage_round_plain))
        if sd == "bfloat16":
            kern, plain = (functools.partial(f, state_dtype=sd) for f in (kern, plain))
        i1s = torch.stack([img1, *centered_gradient(img1)], -1)
        st0 = torch.cat([u.permute(2, 0, 1).contiguous(), img0.new_zeros((4, h, w))])
        state = plain(st0, tvl1_stage_consts(i1s, st0, img0, "plain", nig=k2), k, 0, h,
                      (0, 0))[0]
        errs = {"consts": 0.0, "own": 0.0, "sum": 0.0}
        same = {"consts": True, "own": True}
        for sp in (2, 3, 4):
            ctl = RoundCtl(sp, a.device, 0.01, h, w)
            for i, (r0, r1) in enumerate(row_bounds(h, sp)):
                e0, e1 = max(0, r0 - k), min(h, r1 + k)
                halo = (r0 - e0, e1 - r1)
                blk, i0b = state[:, e0:e1].contiguous(), img0[e0:e1].contiguous()
                cs = tvl1_stage_consts(i1s, blk, i0b, y0=e0, nig=k2, state_dtype=sd)
                cs_p = tvl1_stage_consts(i1s, blk, i0b, "plain", y0=e0, nig=k2)
                if k2:
                    cs_h, cs_ph = _nig_as_grad(cs), _nig_as_grad(cs_p)
                else:
                    cs_h, cs_ph = cs, cs_p
                errs["consts"] = max(errs["consts"], max_err(cs_h, cs_ph))
                same["consts"] &= bool(torch.equal(cs, cs_p))
                assert_close(f"K4 TV-L1 entry {'nig' if k2 else 'grad'} {sd} {h}x{w} sp={sp} "
                             f"shard {i} (y0 {e0})", cs_h, cs_ph, rtol=1e-5, atol=1e-3)
                want, want_s = plain(blk, cs, k, e0, h, halo)
                got = kern(blk.clone(), cs, k, e0, h, halo, ctl, i, 0)
                own = slice(halo[0], e1 - e0 - halo[1])
                got_s = float(ctl.sums[0, i])
                check(float(want_s) > 0.0, f"{name} sp={sp} shard {i}: no update")
                errs["own"] = max(errs["own"], max_err(got[:, own], want[:, own]))
                same["own"] &= bool(torch.equal(got[:, own], want[:, own]))
                errs["sum"] = max(errs["sum"], abs(got_s - float(want_s)) / float(want_s))
                assert_close(f"{name} sp={sp} shard {i} owned rows", got[:, own], want[:, own],
                             rtol=0.0, atol=SHARD_OWN_ATOL)
                check(abs(got_s - float(want_s)) <= SHARD_SUM_RTOL * float(want_s),
                      f"{name} sp={sp} shard {i}: sum {got_s} against {float(want_s)}")
        log(f"[14 shard kernels] {name}, every shard of sp 2-4 from a mid-level state: K4 "
            f"TV-L1 entry ({'K2' if k2 else 'K3'} form, {sd}) max abs {errs['consts']:.3e} "
            f"(rtol 1e-5, atol 1e-3; same bits {same['consts']}), owned rows max abs "
            f"{errs['own']:.3e} (<= {SHARD_OWN_ATOL:g}; same bits {same['own']}), owned sums "
            f"rel err {errs['sum']:.2e} (<= {SHARD_SUM_RTOL:g})")
        e1 = h // 2 + k
        blk, i0b = state[:, :e1].contiguous(), img0[:e1].contiguous()
        cs = tvl1_stage_consts(i1s, blk, i0b, nig=k2, state_dtype=sd)
        ctl = RoundCtl(2, a.device, 0.01, h, w)
        k_ms, p_ms = timed_pair(lambda: kern(blk, cs, k, 0, h, (0, k), ctl, 0, 0),
                                lambda: plain(blk, cs, k, 0, h, (0, k)), 20, 1)
        npx = e1 * w
        rows[name] = (k_ms, p_ms, *bound(k * npx * (K2_FLOPS_ITER if k2 else K3_FLOPS_ITER),
                                         64 * npx))
        if k2 and sd == "float32":
            k_ms, p_ms = timed_pair(lambda: tvl1_stage_consts(i1s, blk, i0b, nig=True),
                                    lambda: tvl1_stage_consts(i1s, blk, i0b, "plain", nig=True),
                                    50, 2)
            rows[f"K4 TV-L1 entry, K2 form, {e1} rows of {h}x{w}"] = (
                k_ms, p_ms, *bound(npx * (3 * K4_FLOPS_CH + 8), npx * (8 + 4 + 16) + h * w * 12))
    h, w = FULL
    occ = occlusion_mask(cold, 0.75)
    # C=2, the filter's gray priors, and C=12, fsmo's priors of a
    # 4-channel clip (two channel groups)
    im12 = torch.from_numpy(np.random.default_rng(14).uniform(0, 255, (h, w, 12))
                            .astype(np.float32)).cuda()
    for src in (prevs, im12):
        worst = 0.0
        for sp in (2, 3, 4):
            for r0, r1 in row_bounds(h, sp):
                args = (src, cold[r0:r1].contiguous(), occ[r0:r1].contiguous())
                out, valid = bicubic_warp(*args, y0=r0)
                ref, ref_valid = bicubic_warp_plain(*args, y0=r0)
                worst = max(worst, max_err(out, ref))
                check(torch.equal(valid, ref_valid),
                      f"K4 shard warp C={src.shape[-1]} sp={sp} rows {r0}: masks")
                assert_close(f"K4 shard warp C={src.shape[-1]} sp={sp} rows {r0}..{r1}", out,
                             ref, rtol=0.0, atol=1e-3)
        log(f"[14 shard kernels] K4 shard warp C={src.shape[-1]} along the cold flow, every "
            f"shard of sp 2-4: max abs {worst:.3e} (atol 1e-3), masks equal")
    del im12
    args = (prevs, cold[:h // 2].contiguous(), occ[:h // 2].contiguous())
    k_ms, p_ms = timed_pair(lambda: bicubic_warp(*args, y0=0),
                            lambda: bicubic_warp_plain(*args, y0=0), 50, 2)
    rows["K4 shard warp C=2, 540 rows of 1080p"] = (k_ms, p_ms,
                                                    *bound(h // 2 * w * 2 * K4_FLOPS_CH,
                                                           h // 2 * w * (8 + 8 + 4 + 1)
                                                           + h * w * 8))
    for name, (k_ms, p_ms, b_ms, b_by) in rows.items():
        log(f"[14 shard launches] {name}: {k_ms:.4f} ms between events, plain {p_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}) ({smi})")


def phase_native_io(smi):
    """15. The native io library: build, codecs, round trips against the
    pure codecs, times, FrameLoader, and nlkalman-seq on JPEG frames."""
    import shutil
    import tempfile

    import torch
    from bwd_nlkalman_tpu_torch import native
    from bwd_nlkalman_tpu_torch.cli import nlkalman_seq
    from bwd_nlkalman_tpu_torch.io import codecs as pure

    native.build()
    have = native.codecs()
    missing = [c for c in native.CODECS if c not in have]
    log(f"[15 native io] {native.lib_path().relative_to(HERE)} built in "
        f"{native.BUILD_SECONDS:.2f} s with g++; codecs compiled in: "
        f"{', '.join(have) or 'none'} (pfm and flo always); left out, their header not "
        f"found by the compiler: {', '.join(native.CODECS[c][0] for c in missing) or 'none'}")
    rng = np.random.default_rng(15)
    h, w = FULL
    rgb = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    cases = {"png8": ("png", ".png", rgb, lambda p, x: native.write_png(p, x, 8)),
             "png16": ("png", ".png", rgb * 200.0, lambda p, x: native.write_png(p, x, 16)),
             "tiff": ("tiff", ".tif", rgb, native.write_tiff),
             "pfm": (None, ".pfm", rgb, native.write_pfm),
             "flo": (None, ".flo", rgb[..., :2] - 100.0, native.write_flo),
             "jpeg": ("jpeg", ".jpg", make_clip(h, w, 1, 0.0, channels=3)[0][0],
                      native.write_jpeg)}
    d = tempfile.mkdtemp(prefix="bnlk_native_")
    try:
        for name, (codec, ext, img, write) in cases.items():
            if codec is not None and codec not in have:
                log(f"[15 native io] {name}: not run, {codec} not compiled in")
                continue
            p_nat, p_pure = os.path.join(d, "n" + ext), os.path.join(d, "p" + ext)
            t0 = time.perf_counter()
            write(p_nat, img)
            got = native.read_image(p_nat)
            nat_ms = 1e3 * (time.perf_counter() - t0)
            if codec == "jpeg":
                again = native.read_image(p_nat)
                ok = np.array_equal(got, again) and got.shape == img.shape
                gain = 10 * np.log10(255.0 ** 2 / np.mean((got - img) ** 2))
                log(f"[15 native io] jpeg 1080p RGB: decode identical to its own decode "
                    f"{ok}, PSNR against the input {gain:.2f} dB; native write + read "
                    f"{nat_ms:.1f} ms (no pure codec)")
                check(ok, "native jpeg decode differs from itself")
                continue
            t0 = time.perf_counter()
            pure.write_image(p_pure, img, native=False)
            want = pure.read_image(p_pure, native=False)
            pure_ms = 1e3 * (time.perf_counter() - t0)
            cross = (np.array_equal(native.read_image(p_pure), want)
                     and np.array_equal(pure.read_image(p_nat, native=False), got))
            same = np.array_equal(got, want) and got.shape == img.shape
            log(f"[15 native io] {name} 1080p: arrays identical to the pure codec's {same}, "
                f"each reads the other's file to the same array {cross}; write + read "
                f"{nat_ms:.1f} ms native, {pure_ms:.1f} ms pure (host, {smi})")
            check(same and cross, f"native {name} round trip differs from the pure codec")
        # FrameLoader over 8 frames: PNG where built, else PFM
        ext = ".png" if "png" in have else ".pfm"
        pat = os.path.join(d, "f-%03d" + ext)
        frames = [rng.uniform(0, 255, (h, w, 3)).astype(np.float32) for _ in range(8)]
        for i, f in enumerate(frames):
            pure.write_image(pat % (i + 1), f, native=False)
        t0 = time.perf_counter()
        loader = native.FrameLoader(pat, 1, 8, nthreads=4, max_queue=8)
        got = list(loader)
        loader.close()
        fl_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = [pure.read_image(pat % (i + 1), native=False) for i in range(8)]
        loop_s = time.perf_counter() - t0
        same = [i for i, _ in got] == list(range(8)) and all(
            np.array_equal(a, b) for (_, a), b in zip(got, want))
        log(f"[15 native io] FrameLoader over 8 frames of 1080p RGB {ext[1:].upper()}: in "
            f"order and equal to read_image {same}; {8 / fl_s:.1f} frames/s against "
            f"{8 / loop_s:.1f} for a loop of the pure read_image (4 threads, host)")
        check(same, "FrameLoader frames differ or came out of order")
        if "jpeg" not in have:
            log("[15 native io] nlkalman-seq on JPEG frames: not run, libjpeg not compiled "
                "in (jpeglib.h not found)")
            return
        clean, _ = make_clip(540, 960, 3, SIGMA, channels=3)
        jpat = os.path.join(d, "c-%03d.jpg")
        for i in range(3):
            native.write_jpeg(jpat % (i + 1), clean[i], 95)
        counters = reset_counters()
        rc = nlkalman_seq.main([jpat, "1", "3", "20", os.path.join(d, "out"),
                                "--gt-pattern", jpat])
        launches = read_counters(counters, "15 nlkalman-seq jpeg", ("K1", "K2", "K4"))
        meas = open(os.path.join(d, "out", "measures")).read()
        log(f"[15 native io] nlkalman-seq on 3 JPEG frames of 540x960 RGB: rc {rc}, "
            f"launches {launches}; measures: " + " | ".join(
                line for line in meas.splitlines() if "total" in line))
        check(rc == 0 and "smo1-total" in meas, "nlkalman-seq on JPEG input failed")
    finally:
        shutil.rmtree(d, ignore_errors=True)
        torch.cuda.synchronize()


def phase_channels(smi):
    """16. Clips of 4-7 channels, whose stacked priors K4 warps in channel
    groups: ``nlkalman-seq --smoother fsmo`` through ``main`` on 1080p RGBA
    PNGs (profiled), ``run_streaming`` with fsmo on a 1080p 4-channel clip
    against ``fsmo_sequence``, ``filter_sequence`` + ``smooth_sequence`` on
    a 1080p 5-channel clip (timed by ``utils.StageTimer``, profiled),
    ``denoise_sequence_sharded`` on it at sp=2 against the unsharded run, a
    270x480 7-channel clip through the kernels against the plain versions,
    and K1's 1080p passes at 4 and 5 channels held against the plain pass
    and timed."""
    import re
    import tempfile

    import torch
    from bwd_nlkalman_tpu_torch.cli import nlkalman_seq
    from bwd_nlkalman_tpu_torch.core.engine import dense_pass_v2, nlk_bases
    from bwd_nlkalman_tpu_torch.core.engine_cuda import dense_pass_cuda
    from bwd_nlkalman_tpu_torch.core.nlkalman import PLAIN_PASSES
    from bwd_nlkalman_tpu_torch.io import read_image, write_png
    from bwd_nlkalman_tpu_torch.ops.bases import make_bases
    from bwd_nlkalman_tpu_torch.parallel import denoise_sequence_sharded, make_mesh
    from bwd_nlkalman_tpu_torch.pipeline import (filter_sequence, fsmo_sequence, run_streaming,
                                                 smooth_sequence)
    from bwd_nlkalman_tpu_torch.tools.k1_bench import (k1_bands, k1_order, nlk_inputs, pass_args,
                                                       stage_ms)
    from bwd_nlkalman_tpu_torch.utils import StageTimer

    t, (h, w) = 3, FULL
    # fsmo on RGBA PNGs: K1 at 4 channels on every pass (2 on the first
    # frame, 3 on each after), one 12-channel warp (flt1|flt2|smo) a frame
    clean, _ = make_clip(h, w, t, SIGMA, channels=4)
    with tempfile.TemporaryDirectory() as d:
        pat, out = os.path.join(d, "c-%03d.png"), os.path.join(d, "out")
        for i in range(t):
            write_png(pat % (i + 1), clean[i])

        def cli():
            return nlkalman_seq.main([pat, "1", str(t), f"{SIGMA:g}", out, "--gt-pattern",
                                      pat, "--smoother", "fsmo"])

        counters = reset_counters()
        PLAIN_PASSES.reset()
        t0 = time.perf_counter()
        rc = cli()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_counters(counters, "16 nlkalman-seq fsmo RGBA", ("K1", "K2", "K4",
                                                                          "K4grp"))
        text = open(os.path.join(out, "measures")).read()
        shape = read_image(os.path.join(out, f"smo1-{t:03d}.tif")).shape
        total = {m[0]: float(m[1]) for m in
                 re.findall(r"^(\w+)-total RMSE \S+ PSNR (\S+)$", text, re.M)}
        log(f"[16 nlkalman-seq fsmo RGBA] 1080p RGBA PNGs T={t}, ground-truth mode: rc {rc}, "
            f"smo1 frames {shape}, PSNR " + " ".join(f"{k} {v:.3f}" for k, v in total.items())
            + f" dB; plain-route passes {PLAIN_PASSES.count}; {secs:.3f} s with io, "
            f"{t / secs:.3f} frames/s ({smi})")
        check(rc == 0 and shape == (h, w, 4), "nlkalman-seq on RGBA PNGs failed")
        check(set(total) == {"flt1", "flt2", "smo1"}, f"measures hold {sorted(total)}")
        check(total["smo1"] >= total["flt2"] - 0.3,
              "fsmo RGBA smo1 is worse than flt2 by 0.3 dB")
        check(PLAIN_PASSES.count == 0 and launches["K1"] == 3 * t - 1,
              f"fsmo RGBA: K1 {launches['K1']} passes, {PLAIN_PASSES.count} on the plain route")
        check(launches["K4grp"] == t - 1, f"fsmo RGBA: {launches['K4grp']} grouped warps")
        prof = profile_slice(cli, "16 nlkalman-seq fsmo RGBA profile", smi)
        if prof is not None:
            log(f"[16 nlkalman-seq fsmo RGBA profile] idle {100 * prof[0]:.1f}% of the command's "
                f"wall time (png and tif io, noise, measures and the passes); device K1 "
                f"{prof[1]['K1']:.3f} ms, K2 {prof[1]['K2']:.3f} ms, K4 {prof[1]['K4']:.3f} ms "
                f"({smi})")

    # the stream with fsmo on a 4-channel clip: the same 12-channel warp a
    # frame, against fsmo_sequence on the same frames
    clean_np, noisy_np = make_clip(h, w, t, SIGMA, seed=4, channels=4)
    frames = {}
    counters = reset_counters()
    PLAIN_PASSES.reset()
    t0 = time.perf_counter()
    run_streaming(lambda i: noisy_np[i], 0, t - 1, SIGMA, smoother="fsmo",
                  write_frame=lambda name, i, a: frames.__setitem__((name, i), a))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counters(counters, "16 stream fsmo 4 channels", ("K1", "K2", "K4", "K4grp"))
    check(PLAIN_PASSES.count == 0 and launches["K1"] == 3 * t - 1,
          f"stream 4 channels: K1 {launches['K1']} passes, {PLAIN_PASSES.count} plain")
    check(launches["K4grp"] == t - 1, f"stream 4 channels: {launches['K4grp']} grouped warps")
    seq = fsmo_sequence(torch.from_numpy(noisy_np).cuda(), SIGMA)
    clean = torch.from_numpy(clean_np).cuda()
    diffs = []
    for name, want in zip(("flt1", "flt2", "smo1"), seq):
        got = torch.from_numpy(np.stack([frames[(name, i)] for i in range(t)])).cuda()
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"stream 4-channel {name} is not finite or has the wrong shape")
        diffs.append((name, psnr(clean, got), psnr(clean, want), max_err(got, want)))
    log(f"[16 stream fsmo 4 channels] 1080p T={t}: " + "; ".join(
        f"{n} PSNR {a:.4f} dB (fsmo_sequence {b:.4f}), max abs diff {e:.3e}"
        for n, a, b, e in diffs) + f"; {secs:.3f} s with host copies, {t / secs:.3f} "
        f"frames/s ({smi})")
    check(all(abs(a - b) <= 0.05 for _, a, b, _ in diffs),
          "the 4-channel stream is off fsmo_sequence by more than 0.05 dB")
    del seq, clean

    # filter + smooth on a 5-channel clip: the filter's warp of flt1|flt2 is
    # 10 channels (two groups), the smoother's 5
    clean_np, noisy_np = make_clip(h, w, t, SIGMA, channels=5)
    clean = torch.from_numpy(clean_np).cuda()
    noisy = torch.from_numpy(noisy_np).cuda()

    def run(timer):
        flt1, flt2 = timer.measure("filter_sequence 5 channels", filter_sequence, noisy,
                                   SIGMA)
        return flt1, flt2, timer.measure("smooth_sequence 5 channels", smooth_sequence,
                                         flt2, SIGMA)

    run(StageTimer())            # warm-up
    timer = StageTimer()
    counters = reset_counters()
    PLAIN_PASSES.reset()
    t0 = time.perf_counter()
    outs = run(timer)
    secs = time.perf_counter() - t0
    launches = read_counters(counters, "16 sequence 5 channels", ("K1", "K2", "K4", "K4grp"))
    for name, x in zip(("flt1", "flt2", "smo1"), outs):
        check(x.shape == noisy.shape and bool(torch.isfinite(x).all()),
              f"5-channel {name} is not finite or has the wrong shape")
    p_n, p_1, p_2, p_s = (psnr(clean, x) for x in (noisy, *outs))
    log(f"[16 sequence 5 channels] 1080p T={t} sigma={SIGMA:g}: PSNR noisy {p_n:.3f} flt1 "
        f"{p_1:.3f} flt2 {p_2:.3f} smo1 {p_s:.3f} dB; plain-route passes "
        f"{PLAIN_PASSES.count}; {secs:.3f} s, {t / secs:.3f} frames/s ({smi})")
    for line in timer.report().splitlines():
        log(f"[16 stage timer] {line}")
    check(p_s >= p_n + 6.0, "5-channel smo1 does not denoise by 6 dB")
    check(PLAIN_PASSES.count == 0 and launches["K1"] == 3 * t - 1,
          f"5 channels: K1 {launches['K1']} passes, {PLAIN_PASSES.count} on the plain route")
    check(launches["K4grp"] == t - 1, f"5 channels: {launches['K4grp']} grouped warps")
    prof = profile_slice(lambda: run(StageTimer()), "16 sequence 5 channels profile", smi)
    if prof is not None:
        log(f"[16 sequence 5 channels profile] idle {100 * prof[0]:.1f}%; K1 "
            f"{prof[1]['K1'] / launches['K1']:.3f} ms of device time a pass, K4 "
            f"{prof[1]['K4']:.3f} ms in all ({smi})")

    # the same clip row-sharded at sp=2 on this card: each shard's filter
    # warp 10 channels in groups, against the unsharded outputs
    mesh = make_mesh(1, 2, ["cuda:0"] * 2)
    counters = reset_counters()
    PLAIN_PASSES.reset()
    t0 = time.perf_counter()
    sharded = denoise_sequence_sharded(noisy, SIGMA, mesh)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_counters(counters, "16 sharded sequence 5 channels",
                             ("K1", "K2", "K4", "K4grp"))
    d = []
    for name, x, want in zip(("flt1", "flt2", "smo1"), sharded, outs):
        check(x.shape == noisy.shape and bool(torch.isfinite(x).all()),
              f"sharded 5-channel {name} is not finite or has the wrong shape")
        d.append(psnr(clean, x) - psnr(clean, want))
    log(f"[16 sharded sequence 5 channels] 1080p T={t} sp=2 on cuda:0 x 2: PSNR d flt1/flt2/"
        "smo1 against the unsharded run " + "/".join(f"{x:+.4f}" for x in d) + " dB (|d| <= "
        f"0.05); {secs:.3f} s, {t / secs:.3f} frames/s ({smi})")
    check(max(abs(x) for x in d) <= 0.05, "sharded 5-channel sequence off the unsharded one")
    check(PLAIN_PASSES.count == 0 and launches["K1"] == 2 * (3 * t - 1),
          f"sharded 5 channels: K1 {launches['K1']}, {PLAIN_PASSES.count} plain passes")
    check(launches["K4grp"] == 2 * (t - 1),
          f"sharded 5 channels: {launches['K4grp']} grouped warps, 2 a frame expected")
    del clean, noisy, outs, sharded

    # 7 channels at 270x480: the filter's warp is 14 channels, against the
    # plain versions on every output
    clean_np, noisy_np = make_clip(*MID, t, SIGMA, seed=7, channels=7)
    clean = torch.from_numpy(clean_np).cuda()
    noisy = torch.from_numpy(noisy_np).cuda()
    res = {}
    for engine in ("auto", "plain"):
        counters = reset_counters()
        flt1, flt2 = filter_sequence(noisy, SIGMA, engine=engine)
        smo1 = smooth_sequence(flt2, SIGMA, engine=engine)
        res[engine] = [psnr(clean, x) for x in (flt1, flt2, smo1)]
        launches = read_counters(counters, f"16 sequence 7 channels {engine}",
                                 ("K1", "K4", "K4grp") if engine == "auto" else ())
    d = [abs(a - b) for a, b in zip(res["auto"], res["plain"])]
    log(f"[16 sequence 7 channels vs plain] 270x480 T={t}: kernels flt1/flt2/smo1 "
        + "/".join(f"{x:.4f}" for x in res["auto"]) + " dB, plain "
        + "/".join(f"{x:.4f}" for x in res["plain"]) + " dB, |d| "
        + "/".join(f"{x:.4f}" for x in d) + " (<= 0.05)")
    check(max(d) <= 0.05, "7 channels: kernels and plain versions disagree")
    del clean, noisy, flt1, flt2, smo1
    torch.cuda.empty_cache()

    # K1's 1080p passes at 4 and 5 channels against the plain pass. By
    # phase 3's 1080p rule (share beyond the bar, mean abs error) against
    # the plain pass on K1's bands summing its distances in K1's order
    # (k1_bands, k1_order), so that a selection tie on a float's last bit
    # goes the same way; against the plain pass with its own bands and
    # order by phase 14's rule for that comparison (K1_SHARD_SHARE,
    # K1_SHARD_MEAN): over 256-320 coefficients a distance's rounding
    # moves more ties than in gray. flt1 and smo1 timed
    kb = make_bases(nlk_bases(8), "cuda")
    rng = np.random.default_rng(16)
    for c in (4, 5):
        cur, prev, valid, basic = (torch.from_numpy(np.ascontiguousarray(a)).cuda()
                                   for a in nlk_inputs(rng, *FULL, c))
        for name, args in pass_args(cur, prev, valid, basic, kb).items():
            got = dense_pass_cuda(*args)
            with k1_order(), k1_bands():
                same = dense_pass_v2(*args)
            own = dense_pass_v2(*args)
            res = []
            for want in (same, own):
                diff = (got - want).abs()
                res.append((float(((diff > 5e-2 + 1e-3 * want.abs()).sum())) / want.numel(),
                            float(diff.mean()), float(diff.max())))
            (share, mean, mx), (o_share, o_mean, o_mx) = res
            log(f"[16 parity] K1 {name} 1080p {c} channels: against the plain pass in K1's "
                f"order on its bands max abs err {mx:.3e}, mean {mean:.3e} (<= "
                f"{K1_FULL_MEAN:g}), share beyond rtol 1e-3 / atol 5e-2 {share:.2e} (<= "
                f"{K1_FULL_SHARE:g}); against the plain pass's own bands and order max "
                f"{o_mx:.3e}, mean {o_mean:.3e} (<= {K1_SHARD_MEAN:g}), share {o_share:.2e} "
                f"(<= {K1_SHARD_SHARE:g})")
            check(share <= K1_FULL_SHARE and mean <= K1_FULL_MEAN,
                  f"K1 {name} 1080p {c} channels off the plain pass in its order")
            check(o_share <= K1_SHARD_SHARE and o_mean <= K1_SHARD_MEAN,
                  f"K1 {name} 1080p {c} channels off the plain pass")
            del got, same, own
            if name not in ("flt1", "smo1"):
                continue
            k_ms, p_ms = timed_pair(lambda: dense_pass_cuda(*args),
                                    lambda: dense_pass_v2(*args), 3, 1)
            d_ms = device_ms(lambda: dense_pass_cuda(*args), 3)
            st = stage_ms(lambda: dense_pass_cuda(*args), 3)
            b_ms, b_by = bound(*k1_work(cur, valid, args[5], *args[6:9])[:2])
            log(f"[16 time] K1 {name} 1080p {c} channels: kernel {k_ms:.2f} ms between "
                f"events, device {fmt_ms(d_ms)}, plain {p_ms:.2f} ms, bound {b_ms:.3f} ms "
                f"({b_by}); device ms by kernel: " + (
                    ", ".join(f"{k} {v:.3f}" for k, v in st.items()) if st
                    else "not measured") + f" ({smi})")
        del cur, prev, valid, basic, args
        torch.cuda.empty_cache()


# the kernels of each, by the start of their names as torch.profiler shows them
KERNEL_NAMES = {"K1": ("dct_kernel", "site_kernel", "aggregate_kernel", "fold_kernel"),
                "K2": ("level_kernel", "round_kernel<K2Rule"),
                "K3": ("stage_kernel", "round_kernel<K3Rule"), "K4": ("warp_tile_kernel",),
                "G": ("band_sep_kernel",)}
KERNELS = {
    "K1": ("nlk_pass", "bwd_nlkalman_tpu_torch/csrc/nlk_pass.cu",
           "bwd_nlkalman_tpu/core/engine_pallas.py:128"),
    "K2": ("tvl1_level", "bwd_nlkalman_tpu_torch/csrc/tvl1_level.cu",
           "bwd_nlkalman_tpu/flow/tvl1_fused.py:65"),
    "K3": ("tvl1_block", "bwd_nlkalman_tpu_torch/csrc/tvl1_block.cu",
           "bwd_nlkalman_tpu/flow/tvl1_pallas.py:52"),
    "K4": ("bicubic_warp", "bwd_nlkalman_tpu_torch/csrc/warp.cu",
           "bwd_nlkalman_tpu/ops/warp_pallas.py:59"),
    "P": ("vpu_probe", "bwd_nlkalman_tpu_torch/csrc/probe.cu",
          "tools/vpu_probe.py:39"),
    "G": ("band_sep", "bwd_nlkalman_tpu_torch/csrc/band_sep.cu", None),
}


def main() -> int:
    smi = phase_device()
    import torch

    sys.path.insert(0, HERE)
    t0 = time.perf_counter()
    phase_build()
    log(f"[2 build] phase took {time.perf_counter() - t0:.1f} s")

    def settle():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        settle()
        log(f"[{name}] phase took {time.perf_counter() - t0:.1f} s")
        return out

    for phase in (phase_k1, phase_k1_widened, phase_k2, phase_k2_bf16, phase_k3, phase_k4,
                  phase_p, phase_g):
        timed(f"3 {phase.__name__}", phase, smi)
    slice1 = timed("4 slice", phase_slice, smi)
    timed("4b slice bf16", phase_slice_bf16, smi, slice1)
    launches = timed("5 slice fscale=0", phase_slice_fullres, smi)
    timed("6 tvl1flow", phase_cli_tvl1flow, smi)
    launches["P"] = timed("7 probe", phase_probe)["P"]
    timed("8 slice vs plain", phase_slice_vs_plain)
    timed("9 stream", phase_stream, smi)
    timed("10 nlkalman-seq lsmo", phase_cli_lsmo, smi)
    timed("11 multiscale", phase_multiscale, smi)
    timed("12 per-frame commands", phase_cli_frame, smi)
    timed("13 search", phase_search, smi)
    timed("14 sharded", phase_sharded, smi, slice1)
    timed("15 native io", phase_native_io, smi)
    timed("16 channels", phase_channels, smi)
    torch.cuda.synchronize()
    # no single PyTorch call computes any of K1-K4 and P, so they have no
    # library time (grid_sample's bicubic is another cubic and border); G's
    # library call is the dense products, its plain version
    log(json.dumps({"kernels": [
        {"name": KERNELS[k][0], "route": "cuda", "source": KERNELS[k][1],
         "replaces": KERNELS[k][2], "launches": launches[k],
         "max_abs_err": PARITY[k], "ms": TIMES[k][0], "device_ms": TIMES[k][2],
         "plain_ms": TIMES[k][1],
         "bound_ms": BOUNDS[k][0], "bound_by": BOUNDS[k][1],
         "library_ms": TIMES[k][1] if k == "G" else None,
         **({"variants": {"K1": K1_VARIANTS, "K2": K2_VARIANTS}[k]}
            if k in ("K1", "K2") else {})}
        for k in KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
