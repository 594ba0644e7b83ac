"""Time K4, the bicubic warp, on one card, and compare two checkouts in
turns.

    python3 bwd_nlkalman_tpu_torch/tools/warp_bench.py [--against DIR]

Each turn is a worker process that imports ``bwd_nlkalman_tpu_torch``
from one checkout's root, builds that checkout's kernels and times the
main path's warps:

- ``filter_c2_1080p``: 1080x1920 with C=2 (the filter's flt1|flt2 warp);
- ``smoother_c1_occl_1080p``: 1080x1920 with C=1 and an occlusion mask
  on a tenth of the pixels;
- ``gate_c1_540x960``: 540x960 with C=1 (the warm gate);
- ``tvl1_c3_1080x1920``: 1080x1920 with C=3 ((I1, I1x, I1y) of a TV-L1
  warp stage);
- ``tvl1_consts_1080x1920``: a whole 1080x1920 TV-L1 warp stage's
  constants, from the (6, H, W) state, (I1, I1x, I1y) and I0 to the
  four constant planes: ``tvl1_tiled.tvl1_stage_consts`` where the
  checkout has it, else the composition of K4 and eager ops that the
  checkout's ``tvl1_single_scale_tiled`` runs;

each along three flows, named ``<case>/<flow>``, and
``c<C>_occl_1080p/tvl1``, 1080x1920 with C = 4-10, 12 and 14 channels
and the occlusion mask (the generic instance, the instances of 6 and 9,
and past 9 the launches in channel groups: the filter's and fsmo's warps
of 4-7-channel clips), along the first: ``tvl1``, the flow the
main path computes for ``chip_smoke.py``'s 1080p scene
(``FlowConfig().flow_cold_carry`` of its first two noisy frames; its
540x960 carry for the gate); ``smooth``, a sinusoid of about a pixel;
``noisy``, independent normal draws of 1.5 px. The last two send border
rows and columns out of the frame.

For each: ``ms``, CUDA-event milliseconds per wrapper call over ``REPS``
calls after a warm-up; ``warp_device_ms``, the profiler's device time of
K4's own kernels (names ``warp_*``) per call; ``device_ms``, the device
time of everything the call launches, per call; each with the L2 cache
hot (calls back to back) and flushed (a 96 MB buffer written before
each call; ``*_flushed``). ``kernels`` lists what one call launched.
``bound_ms`` is the byte bound of the call (each input read once, each
output written once, over 3.35 TB/s). ``digest`` is a sha256 of the
call's output and mask bytes. The ``--against`` checkout's K4 may
refuse a channel count (a parent that took at most 9): its turns record
the refusal in place of the case. A refusal in this checkout's turns
fails the run.

Beside each warp along the ``tvl1`` flow, ``grid_sample/<case>`` times
``torch.nn.functional.grid_sample(mode="bicubic", padding_mode="zeros",
align_corners=True)`` on the same H, W and C in its own planar layout: a
yardstick for the same amount of work (16 taps a channel), not the same
function (its cubic has a=-0.75 and other borders), which the port never
calls. ``stage_kernels`` lists the kernels of one whole warp stage at
1080x1920 (the constants, then K3's stage entry), run with torch's sync
debug mode at "error", so a host sync in it raises.

With ``--against DIR`` (another checkout, for example the parent commit
unpacked with ``git archive``) the turns run other, this, this, other,
so both are timed on the same card. Every turn prints one JSON line with
the card's name and power limit; the last line is the mean per tree and
``digests_equal``, whether every turn that ran a case gave the same bits
in it (a kernel change that keeps the parent's arithmetic).

    python3 bwd_nlkalman_tpu_torch/tools/warp_bench.py --variants

builds ``tools/warp_variants.cu`` (K4's design variants: the gather at
other tile shapes and register caps, and the staged design, a
shared-memory window per block) into a library of its own, and prints
one JSON line for the port's own K4 and then one for each variant: its
registers a thread for 1-3 channels and its device ms (L2 hot) on each
warp above along each flow, each output checked against the plain
version first. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
FULL = (1080, 1920)
HALF = (540, 960)
REPS = 20
FLUSH_BYTES = 96 << 20
HBM_BYTES_S = 3.35e12
WARPS = (("filter_c2_1080p", FULL, 2, False), ("smoother_c1_occl_1080p", FULL, 1, True),
         ("gate_c1_540x960", HALF, 1, False), ("tvl1_c3_1080x1920", FULL, 3, False))
CHANNELS = (4, 5, 6, 7, 8, 9, 10, 12, 14)   # c<C>_occl_1080p, along the tvl1 flow
CHANNEL_CASES = {f"c{c}_occl_1080p/tvl1" for c in CHANNELS}


def smooth_flow(h, w):
    """A smooth (H, W, 2) flow of about one pixel that varies over the
    frame; it sends the first columns and last rows out of the frame."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    u = -1.3 + 0.8 * np.sin(2 * np.pi * yy / 300.0)
    v = 0.7 + 0.6 * np.cos(2 * np.pi * xx / 400.0)
    return np.stack([u, v], -1).astype(np.float32)


def noisy_flow(rng, h, w, band=False):
    """Independent normal draws of 1.5 px that send the top rows and right
    columns out of the frame; ``band``: five rows shifted by 0.45 w,
    hundreds of pixels, whose taps lie far from their neighbours'."""
    f = 1.5 * rng.standard_normal((h, w, 2)).astype(np.float32)
    f[: max(1, h // 5), :, 1] -= 9.0
    f[:, -max(1, w // 6):, 0] += 12.5
    if band:
        f[h // 3: h // 3 + 5, :, 0] -= 0.45 * w
    return f


def tvl1_flows():
    """The flow the main path computes for chip_smoke.py's 1080p scene
    (its first two noisy frames, cold, the default flow configuration):
    (the 1080x1920 flow, its 540x960 warm-start carry), on the card."""
    import torch
    from bwd_nlkalman_tpu_torch.pipeline import FlowConfig
    from bwd_nlkalman_tpu_torch.tools.tvl1_bench import noisy_frames

    nz = torch.from_numpy(noisy_frames(*FULL, 2)).cuda()
    u, u_fs = FlowConfig().flow_cold_carry(nz[1], nz[0])
    return u.contiguous(), u_fs.contiguous()


def inputs():
    """(name -> (im, flow, occl) of the main path's warps, name -> (i1s,
    state, i0) of a 1080x1920 TV-L1 warp stage), along each flow, on the
    card."""
    import torch
    from bwd_nlkalman_tpu_torch.ops.grad import centered_gradient
    from bwd_nlkalman_tpu_torch.tools.tvl1_bench import noisy_frames

    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    u, u_fs = tvl1_flows()
    flows = {"tvl1": {FULL: u, HALF: u_fs},
             "smooth": {s: t(smooth_flow(*s)) for s in (FULL, HALF)},
             "noisy": {s: t(noisy_flow(rng, *s)) for s in (FULL, HALF)}}
    warps = {}
    for name, size, c, occl in WARPS:
        im = t(rng.uniform(0, 255, size + (c,)).astype(np.float32))
        oc = t(np.where(rng.uniform(size=size) < 0.1, 255.0, 0.0).astype(np.float32)) \
            if occl else None
        for kind, fl in flows.items():
            warps[f"{name}/{kind}"] = (im, fl[size], oc)
    oc = t(np.where(rng.uniform(size=FULL) < 0.1, 255.0, 0.0).astype(np.float32))
    for c in CHANNELS:
        im = t(rng.uniform(0, 255, FULL + (c,)).astype(np.float32))
        warps[f"c{c}_occl_1080p/tvl1"] = (im, u, oc)   # CHANNEL_CASES
    nz = t(noisy_frames(*FULL, 2))
    i0, i1 = nz[1], nz[0]
    i1s = torch.stack([i1, *centered_gradient(i1)], dim=-1)
    stages = {}
    for kind, fl in flows.items():
        state = torch.zeros((6,) + FULL, device="cuda")
        state[:2] = fl[FULL].permute(2, 0, 1)
        stages[f"tvl1_consts_1080x1920/{kind}"] = (i1s, state, i0)
    return warps, stages


def per_call(fn, reps, flush=None, own=None):
    """(event ms, device ms of the kernels whose short name starts with
    ``own``, device ms of every kernel, the kernel names of one call), each
    a time per call over ``reps`` calls after a warm-up; the device times
    from torch.profiler, None where it saw none (and for ``own`` when not
    given). ``flush``: a call made before each, left out of every time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bwd_nlkalman_tpu_torch.tools.k1_bench import device_events, short_name

    fn()
    torch.cuda.synchronize()
    skip = set()
    if flush is not None:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flush()
            torch.cuda.synchronize()
        skip = {n for n, _, _ in device_events(prof)}
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    for a, b in ev:
        if flush is not None:
            flush()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    ms = sum(a.elapsed_time(b) for a, b in ev) / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    dev = sorted((e for e in device_events(prof) if e[0] not in skip), key=lambda e: e[1])
    if not dev:
        return ms, None, None, None
    total = sum(t1 - t0 for _, t0, t1 in dev) / 1e3 / reps
    mine = None if own is None else sum(
        t1 - t0 for n, t0, t1 in dev if short_name(n).startswith(own)) / 1e3 / reps
    names = [short_name(n) for n, _, _ in dev[: max(1, len(dev) // reps)]]
    return ms, mine, total, names


def timed(fn, nbytes, flush, may_refuse=False):
    from bwd_nlkalman_tpu_torch.tools.tvl1_bench import digest

    try:
        dig = digest(fn())
    except ValueError as e:    # the other checkout's K4 refuses the case
        if not may_refuse:
            raise
        return {"refused": str(e)}
    hot = per_call(fn, REPS, None, "warp_")
    cold = per_call(fn, REPS, flush, "warp_")
    return {"ms": hot[0], "warp_device_ms": hot[1], "device_ms": hot[2],
            "ms_flushed": cold[0], "warp_device_ms_flushed": cold[1],
            "device_ms_flushed": cold[2], "kernels": hot[3],
            "bound_ms": 1e3 * nbytes / HBM_BYTES_S, "digest": dig}


def worker(root: str) -> dict:
    """Time one checkout's K4 (imported from ``root``) on the card."""
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F
    from bwd_nlkalman_tpu_torch import _build
    from bwd_nlkalman_tpu_torch.flow import tvl1_tiled
    from bwd_nlkalman_tpu_torch.flow.tvl1_block_cuda import tvl1_stage_cuda
    from bwd_nlkalman_tpu_torch.ops.warp_cuda import bicubic_warp_cuda
    from bwd_nlkalman_tpu_torch.tools.k1_bench import card, device_events, short_name
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("warp_bench: no CUDA device")
    _build.library()
    torch.backends.cudnn.allow_tf32 = False
    buf = torch.zeros(FLUSH_BYTES // 8, dtype=torch.int64, device="cuda")

    def flush():
        buf.add_(1)

    warps, stages = inputs()
    res = {}
    for name, (im, flow, oc) in warps.items():
        h, w, c = im.shape
        nbytes = h * w * (8 * c + 8 + 1 + (4 if oc is not None else 0))
        res[name] = timed(lambda: bicubic_warp_cuda(im, flow, oc), nbytes, flush,
                          may_refuse=root != ROOT)
    for name, (im, flow, _) in warps.items():
        if not name.endswith("/tvl1") or name in CHANNEL_CASES:
            continue
        h, w, c = im.shape
        planar = im.permute(2, 0, 1)[None].contiguous()
        xs = torch.arange(w, device="cuda", dtype=torch.float32)
        ys = torch.arange(h, device="cuda", dtype=torch.float32)
        grid = torch.stack([2 * (xs[None, :] + flow[..., 0]) / (w - 1) - 1,
                            2 * (ys[:, None] + flow[..., 1]) / (h - 1) - 1], -1)[None]
        res["grid_sample/" + name] = timed(
            lambda: F.grid_sample(planar, grid, mode="bicubic", padding_mode="zeros",
                                  align_corners=True),
            h * w * (8 * c + 8), flush)

    if hasattr(tvl1_tiled, "tvl1_stage_consts"):
        consts = tvl1_tiled.tvl1_stage_consts
    else:
        def consts(i1s, state, i0):   # a checkout without it: its level's composition
            u1, u2 = state[0], state[1]
            wrp = tvl1_tiled.warp_bicubic_zero_multi(i1s, u1, u2)
            i1w, i1wx, i1wy = wrp.unbind(-1)
            return torch.stack([i1wx, i1wy, i1wx * i1wx + i1wy * i1wy,
                                i1w - i1wx * u1 - i1wy * u2 - i0])
    for name, (i1s, state, i0) in stages.items():
        res[name] = timed(lambda: consts(i1s, state, i0), 40 * i0.numel(), flush)

    # a first stage makes K3's device block counter (one fill kernel)
    i1s, state, i0 = stages["tvl1_consts_1080x1920/tvl1"]
    tvl1_stage_cuda(state.clone(), consts(i1s, state, i0), 24, 24, 0.01, lambda_=0.25)
    st = state.clone()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            tvl1_stage_cuda(st, consts(i1s, st, i0), 24, 24, 0.01, lambda_=0.25)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    stage = [short_name(n) for n, _, _ in sorted(device_events(prof), key=lambda e: e[1])]
    return {"root": os.path.relpath(root, ROOT) if root != ROOT else ".",
            "card": card(), "torch": torch.__version__, "cases": res,
            "stage_kernels": stage}


def variants() -> int:
    """Build and time ``tools/warp_variants.cu``'s designs of K4 beside
    the port's own."""
    import ctypes

    sys.path.insert(0, ROOT)
    import torch
    from bwd_nlkalman_tpu_torch import _build
    from bwd_nlkalman_tpu_torch.ops.warp import bicubic_warp_plain
    from bwd_nlkalman_tpu_torch.ops.warp_cuda import bicubic_warp_cuda
    from bwd_nlkalman_tpu_torch.tools.k1_bench import card

    if not torch.cuda.is_available():
        raise SystemExit("warp_bench: no CUDA device")
    out_dir = _build.BUILD_ROOT.parent / "warp_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libwarp_variants.so"
    nvcc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC),
         os.path.join(HERE, "warp_variants.cu"), "-o", str(lib_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.library()
    warps = {k: v for k, v in inputs()[0].items() if k not in CHANNEL_CASES}
    want = {name: bicubic_warp_plain(*args) for name, args in warps.items()}
    log = nvcc.communicate()[0]
    if nvcc.returncode != 0:
        sys.stderr.write(log)
        return nvcc.returncode
    lib = ctypes.CDLL(str(lib_path))
    p, n = ctypes.c_void_p, ctypes.c_int
    lib.bnlk_warp_variant.argtypes = [n, p, p, p, p, p, n, n, n, p]
    lib.bnlk_warp_variant_regs.argtypes = [n, n]
    lib.bnlk_warp_variant_name.argtypes = [n]
    lib.bnlk_warp_variant_name.restype = ctypes.c_char_p
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def variant(i):
        def run(im, flow, oc):
            h, w, c = im.shape
            out = torch.empty_like(im)
            valid = torch.empty((h, w), dtype=torch.bool, device="cuda")
            rc = lib.bnlk_warp_variant(i, im.data_ptr(), flow.data_ptr(),
                                       None if oc is None else oc.data_ptr(),
                                       out.data_ptr(), valid.data_ptr(), h, w, c, stream)
            if rc != 0:
                raise RuntimeError(f"bnlk_warp_variant({i}) failed with CUDA error {rc}")
            return out, valid
        return run

    rows = [("csrc/warp.cu, the port's K4", None, bicubic_warp_cuda)] + [
        (lib.bnlk_warp_variant_name(i).decode(),
         {c: lib.bnlk_warp_variant_regs(i, c) for c in (1, 2, 3)}, variant(i))
        for i in range(lib.bnlk_warp_variant_count())]
    for name, regs, run in rows:
        cases = {}
        for case, (im, flow, oc) in warps.items():
            got, valid = run(im, flow, oc)
            if not (torch.equal(valid, want[case][1])
                    and float((got - want[case][0]).abs().max()) <= 1e-3):
                raise SystemExit(f"warp_bench: {name} differs from the plain warp on {case}")
            cases[case] = per_call(lambda: run(im, flow, oc), REPS)[2]
        print(json.dumps({"variant": name, "card": card(), "registers": regs,
                          "device_ms": cases}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another checkout's root, timed in turns")
    ap.add_argument("--variants", action="store_true",
                    help="time tools/warp_variants.cu's designs of K4")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.variants:
        return variants()
    if a.worker:
        print(json.dumps(worker(os.path.abspath(a.worker))), flush=True)
        return 0
    roots = [ROOT] if not a.against else [a.against, ROOT, ROOT, a.against]
    runs = []
    for r in roots:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                              os.path.abspath(r)], capture_output=True, text=True)
        if out.returncode != 0:
            sys.stderr.write(out.stdout + out.stderr)
            return out.returncode
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    mean: dict = {}
    digests: dict = {}
    for run in runs:
        m = mean.setdefault(run["root"], {})
        for name, c in run["cases"].items():
            if "digest" in c:
                digests.setdefault(name, set()).add(c["digest"])
            for key in ("ms", "warp_device_ms", "device_ms", "ms_flushed",
                        "warp_device_ms_flushed", "device_ms_flushed"):
                if c.get(key) is not None:
                    m.setdefault(name, {}).setdefault(key, []).append(c[key])
    print(json.dumps({"card": runs[0]["card"], "mean": {
        root: {name: {k: sum(v) / len(v) for k, v in keys.items()}
               for name, keys in m.items()} for root, m in mean.items()},
        "digests": {k: sorted(v) for k, v in digests.items()},
        "digests_equal": all(len(v) == 1 for v in digests.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
