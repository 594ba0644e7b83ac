"""One traced request of a cell, read by the program's layer spans: each
layer's device extent per frame, K2's iterations from the request's
counter beside a host read of ``ITERATIONS`` around the same request, the
four span readers, and the device's idle gaps summed by the innermost
``bnlk.*`` span the host was in.

    python3 portbench/span_report.py --workload <cell> --seed <n>

Prints one JSON line. One request a process, as the traced run profiles
it: a second set-up in one process has lost a kernel from the profile in
every attempt. Needs a CUDA device and a checkout of the program that
records spans.
"""

import argparse
import json
import os
import sys
import time


def gaps_by_span(trace) -> dict:
    """Seconds of device idle between the first and last activity, summed
    by the innermost ``bnlk.*`` host span overlapping each gap most
    ("none" where no span does)."""
    from portbench.trace import _union

    busy = _union((e[1], e[2]) for e in trace.events)
    spans = [h for h in trace.host if h[0].startswith("bnlk.")]
    out: dict = {}
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        best, key = "none", (0.0, 0.0)
        for name, h0, h1 in spans:
            ov = min(h1, g1) - max(h0, g0)
            if ov > 0 and (ov, h0 - h1) > key:
                best, key = name, (ov, h0 - h1)
        out[best] = out.get(best, 0.0) + (g1 - g0) / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def innermost(spans, t) -> str:
    """The innermost of ``spans`` ((name, start, end)) holding time ``t``,
    "none" where none does."""
    best, width = "none", None
    for name, a, b in spans:
        if a <= t <= b and (width is None or b - a < width):
            best, width = name, b - a
    return best


def gaps_by_launch_span(raw) -> tuple[dict, int]:
    """Seconds of device idle summed by the innermost ``bnlk.*`` span open
    on the host when the activity that ends each gap was launched: the
    layer the device waited for, whether the host was behind it or ahead.
    ``raw`` are the profiler's own events (``kineto_results.events()``); an
    activity is linked to the innermost host op open at its launch (a
    ``bnlk.*`` span itself for the kernels launched through ctypes) by its
    linked correlation id. Also returns the number of activities left
    unlinked."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev = sorted((e.start_ns(), e.end_ns(), e.linked_correlation_id())
                 for e in raw if e.device_type() == cuda)
    # host ops by id; the runtime and driver calls (cuda*, cu*) carry the
    # device's correlation ids, which may clash with the ops'
    ops = [e for e in raw if e.device_type() != cuda and not e.name().startswith("cu")]
    start = {e.correlation_id(): e.start_ns() for e in ops}
    spans = [(e.name(), e.start_ns(), e.end_ns()) for e in ops if e.name().startswith("bnlk.")]
    out: dict = {}
    unlinked, end = 0, None
    for a, b, linked in dev:
        t = start.get(linked)
        unlinked += t is None
        if end is not None and a > end:
            name = "unlinked" if t is None else innermost(spans, t)
            out[name] = out.get(name, 0.0) + (a - end) / 1e9
        end = b if end is None else max(end, b)
    return dict(sorted(out.items(), key=lambda kv: -kv[1])), unlinked


def report(cell, seed: int, device) -> dict:
    import torch

    from bwd_nlkalman_tpu_torch import kernel_counters
    from bwd_nlkalman_tpu_torch.flow.tvl1_cuda import ITERATIONS
    from portbench import cells
    from portbench.spans import last_request
    from portbench.trace import (Trace, _mismatches, breakdown, busy_s, device_events,
                                 host_events)
    from torch.profiler import ProfilerActivity, profile

    driver = cells.load_module(cell.root, "drivers", cell.config["entry"])
    state = driver.setup(cell, seed, device)
    x = state.clips[state.order[0]]
    # one request profiled as trace.profile_request does, keeping the
    # profiler's own events for the launch links
    launches = {k: c.count for k, c in kernel_counters().items()}
    before = ITERATIONS.count
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.no_grad():
            state.model(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    host_read = ITERATIONS.count - before
    launches = {k: c.count - launches[k] for k, c in kernel_counters().items()}
    trace = Trace(device_events(prof), host_events(prof), wall, x.shape[0],
                  driver.k1_passes(state, x.shape[0]))
    lost = _mismatches(trace.events, launches)
    by_launch, unlinked = gaps_by_launch_span(prof.profiler.kineto_results.events())
    req = last_request()
    f = trace.frames
    # where the request span sits in the profiler's clock (us), against the
    # first and last device activity
    r0, r1 = next((h[1], h[2]) for h in trace.host if h[0] == "bnlk.request")
    d0, d1 = min(e[1] for e in trace.events), max(e[2] for e in trace.events)
    layers = {k: req.extent_ms(k) / f for k in ("flow", "occlusion", "warp", "nlk")}
    layers["driver"] = req.self_ms(0) / f
    return {
        "workload": cell.name, "seed": seed, "device": torch.cuda.get_device_name(0),
        "window_s": trace.wall_s, "busy_s": busy_s(trace.events),
        "request_ms": req.spans[0].device_ms,
        "ms_per_frame": layers, "layers_sum_ms_per_frame": sum(layers.values()),
        "request_ms_per_frame": req.spans[0].device_ms / f,
        "flows": req.count("flow"), "k2_iterations": req.counters.get("k2_iterations"),
        "k2_iterations_host_read": host_read, "profile_lost": lost,
        "host_ms_before_request": 1e3 * (req.spans[0].host_start - t0),
        "host_ms_after_request": 1e3 * (wall - (req.spans[0].host_end - t0)),
        "device_ms_from_request_entry_to_first_activity": (d0 - r0) / 1e3,
        "device_ms_from_last_activity_to_request_exit": (r1 - d1) / 1e3,
        "device_ms_first_to_last_activity": (d1 - d0) / 1e3,
        "metrics": {m: cells.load_module(cell.root, "metrics", m).read(trace)
                    for m in ("k2_iters_per_flow", "flow_glue_ms_per_frame",
                              "warp_ms_per_frame", "driver_ms_per_frame",
                              "flow_ms_per_frame", "idle_pct")},
        "idle_gaps_by_span_s": gaps_by_span(trace),
        "idle_gaps_by_launch_span_s": by_launch, "activities_unlinked": unlinked,
        "idle_gaps_s": breakdown(trace)["idle_gaps"],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    from portbench import cells

    if not torch.cuda.is_available():
        print("span_report: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(report(cells.load(root, args.workload), args.seed, torch.device("cuda"))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
