"""Time K2 and K3, the TV-L1 kernels, and K4's entries on one card, and
compare two checkouts in turns.

    python3 bwd_nlkalman_tpu_torch/tools/tvl1_bench.py [--against DIR]
        [--state-dtype {float32,bfloat16}]

Each turn is a worker process that imports ``bwd_nlkalman_tpu_torch``
from one checkout's root, builds that checkout's kernels and times, on
a 1080p gray pair of a translating scene with noise at sigma=20
(luma-normalised and presmoothed as the flow does):

- the cold 540x960 K2 level (zero flow in, 5 warp stages, rounds of 8,
  lambda 0.25, as slice 1's finest level);
- the warm 540x960 K2 level (the next pair, from the cold level's flow,
  3 warp stages, as slice 1's warm-started flow);
- one K3 block of 24 iterations at 1080x1920 (zero state, the first
  warp stage's constants);
- the 1080x1920 level of the tiled solver (K4 warps, constants, K3; 5
  warp stages), as slice 2's finest level;
- K4's two entries at 1080p on the whole frame: a 2-channel warp with
  occlusion along a smooth flow, and a 1080x1920 warp stage's constants;
- with ``--state-dtype bfloat16``, both 540x960 K2 levels again with
  bfloat16 dual planes (``*_bf16``), in this checkout's turns only.

For each: ``ms``, the mean per call between CUDA events over ``REPS``
calls after a warm-up; ``wall_ms``, the host clock per call around one
call and a synchronise; ``device_ms``, the device time of one call's
kernels from torch.profiler (None where it sees none); ``digest``, a
sha256 of the call's outputs' bytes. With ``--against DIR`` (another
checkout, for example the parent commit unpacked with ``git archive``)
the turns run other, this, this, other, so both are timed on the same
card. Every turn prints one JSON line with the card's name and power
limit; the last line is the mean per tree and ``digests_equal``, whether
every turn that ran a case gave the same bits in it. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
SIGMA = 20.0
FULL = (1080, 1920)
REPS = 5


def noisy_frames(h, w, frames, sigma=SIGMA, seed=0):
    """A structured scene translating by one pixel a frame, with AWGN
    (chip_smoke.py's make_clip, same draws): (T, H, W) float32."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(np.cumsum(rng.standard_normal((h + 8, w + 8)), axis=0), axis=1)
    base = ((base - base.min()) / (base.max() - base.min()) * 175 + 40).astype(np.float32)
    clean = np.stack([base[i % 8: i % 8 + h, i % 8: i % 8 + w] for i in range(frames)])
    return clean + sigma * rng.standard_normal(clean.shape).astype(np.float32)


def cases(k2_level, k3_block, k3_level, k4_warp, k4_consts, bf16=False):
    """name -> zero-argument call, on the card, from each tree's own
    functions (``tvl1_level_cuda``, ``tvl1_block_cuda``,
    ``tvl1_single_scale_tiled``, ``bicubic_warp_cuda``,
    ``warp_tvl1_consts_cuda``); with ``bf16`` the K2 levels with
    bfloat16 duals too."""
    import torch
    from bwd_nlkalman_tpu_torch.flow import tvl1, tvl1_tiled

    nz = torch.from_numpy(noisy_frames(*FULL, 3)).cuda()
    a, b = tvl1._prep_pair(nz[1], nz[0])
    a2, b2 = tvl1._prep_pair(nz[2], nz[1])
    h0, h1 = (tvl1.zoom_out(x, 0.5) for x in (a, b))
    w0, w1 = (tvl1.zoom_out(x, 0.5) for x in (a2, b2))
    kw = dict(lambda_=0.25, k_check=8, max_iters=300)
    zero = h0.new_zeros(h0.shape + (2,))
    warm = k2_level(h0, h1, zero, nwarps=5, **kw)
    state = a.new_zeros((6,) + a.shape)
    consts = tvl1_tiled.tvl1_stage_consts(
        torch.stack([b, *tvl1_tiled.centered_gradient(b)], -1), state, a)
    u0 = a.new_zeros(a.shape + (2,))
    yy, xx = np.mgrid[:FULL[0], :FULL[1]].astype(np.float32)
    flow = torch.from_numpy(np.stack([2.3 + 1.5 * np.sin(xx / 97.0), -1.7 + np.cos(yy / 61.0)],
                                     -1).astype(np.float32)).cuda()
    occ = torch.where(torch.from_numpy((xx + 3 * yy) % 17 == 0).cuda(), 255.0, 0.0)
    im2 = torch.stack([nz[0], nz[1]], -1).contiguous()
    i1s = torch.stack([b, *tvl1_tiled.centered_gradient(b)], -1).contiguous()
    ustate = torch.cat([flow.permute(2, 0, 1), a.new_zeros((4,) + a.shape)]).contiguous()
    out = {
        "k2_cold_540x960": lambda: k2_level(h0, h1, zero, nwarps=5, **kw),
        "k2_warm3_540x960": lambda: k2_level(w0, w1, warm, nwarps=3, **kw),
        "k3_block24_1080x1920": lambda: k3_block(state, consts, 24),
        "k3_level_1080x1920": lambda: k3_level(a, b, u0, lambda_=0.25, nwarps=5,
                                               max_iters=300),
        "k4_warp_c2_1080p": lambda: k4_warp(im2, flow, occ),
        "k4_consts_1080x1920": lambda: k4_consts(i1s, ustate, a),
    }
    if bf16:
        sd = dict(kw, state_dtype="bfloat16")
        warm16 = k2_level(h0, h1, zero, nwarps=5, **sd)
        out["k2_cold_540x960_bf16"] = lambda: k2_level(h0, h1, zero, nwarps=5, **sd)
        out["k2_warm3_540x960_bf16"] = lambda: k2_level(w0, w1, warm16, nwarps=3, **sd)
    return out


def digest(out) -> str:
    """sha256 of the bytes of a call's output tensors."""
    h = hashlib.sha256()
    for t in out if isinstance(out, (tuple, list)) else (out,):
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def worker(root: str, bf16: bool = False) -> dict:
    """Time one checkout's K2 and K3 (imported from ``root``) on the card."""
    sys.path.insert(0, root)
    import torch
    from bwd_nlkalman_tpu_torch import _build
    from bwd_nlkalman_tpu_torch.flow.tvl1_block_cuda import tvl1_block_cuda
    from bwd_nlkalman_tpu_torch.flow.tvl1_cuda import tvl1_level_cuda
    from bwd_nlkalman_tpu_torch.flow.tvl1_tiled import tvl1_single_scale_tiled
    from bwd_nlkalman_tpu_torch.ops.warp_cuda import bicubic_warp_cuda, warp_tvl1_consts_cuda
    from bwd_nlkalman_tpu_torch.tools.k1_bench import busy_ms, card, cuda_ms, device_events
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("tvl1_bench: no CUDA device")
    _build.library()
    res = {}
    for name, fn in cases(tvl1_level_cuda, tvl1_block_cuda, tvl1_single_scale_tiled,
                          bicubic_warp_cuda, warp_tvl1_consts_cuda, bf16).items():
        dig = digest(fn())
        ms = cuda_ms(fn, REPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = device_events(prof)
        res[name] = {"ms": ms, "wall_ms": wall,
                     "device_ms": busy_ms(ev) if ev else None, "digest": dig}
    return {"root": os.path.relpath(root, ROOT) if root != ROOT else ".",
            "card": card(), "torch": torch.__version__, "cases": res}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another checkout's root, timed in turns")
    ap.add_argument("--state-dtype", choices=("float32", "bfloat16"), default="float32",
                    help="bfloat16: time the K2 levels with bf16 duals too")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--bf16", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker:
        print(json.dumps(worker(os.path.abspath(a.worker), a.bf16)), flush=True)
        return 0
    roots = [ROOT] if not a.against else [a.against, ROOT, ROOT, a.against]
    runs = []
    for r in roots:
        bf16 = ["--bf16"] if a.state_dtype == "bfloat16" and r == ROOT else []
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                              os.path.abspath(r), *bf16], capture_output=True, text=True)
        if out.returncode != 0:
            sys.stderr.write(out.stdout + out.stderr)
            return out.returncode
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    mean: dict = {}
    for run in runs:
        m = mean.setdefault(run["root"], {})
        for name, c in run["cases"].items():
            m.setdefault(name, []).append(c["ms"])
    digests: dict = {}
    for run in runs:
        for name, c in run["cases"].items():
            digests.setdefault(name, set()).add(c["digest"])
    print(json.dumps({"card": runs[0]["card"], "mean_ms": {
        root: {k: sum(v) / len(v) for k, v in m.items()} for root, m in mean.items()},
        "digests": {k: sorted(v) for k, v in digests.items()},
        "digests_equal": all(len(v) == 1 for v in digests.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
