"""The traced run: one request under ``torch.profiler`` in the fresh
process, with a check that the profiler saw every kernel launch the
program counted, and the readings every per-layer metric reads.

The event helpers (:func:`device_events`, :func:`short_name`,
:func:`kernel_ms`, :func:`busy_s`) are copies of those in the program's
``tools/k1_bench.py``.
"""

from __future__ import annotations

import dataclasses
import re
import sys
import time

# each counted kernel's kernels, by the start of their names as the
# profiler shows them: a launch of K1 runs one of each of the three named
# here (and a DCT kernel a band); a launch of the others one of any
KERNELS = {"K1": ("site_kernel", "aggregate_kernel", "fold_kernel"),
           "K2": ("level_kernel", "round_kernel<K2Rule"),
           "K3": ("stage_kernel", "round_kernel<K3Rule"),
           "K4": ("warp_tile_kernel",)}
# the flow's kernels: K2 and K3, and K4's TV-L1 entry (its instances with
# kConsts 1-3)
FLOW_KERNEL = re.compile(r"^(level_kernel|round_kernel|stage_kernel)|^warp_tile_kernel<\d+, [123]")
ATTEMPTS = 3


def device_events(prof):
    """(kernel name, start us, end us) of every device activity."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if getattr(e, "device_type", None) == cuda]


def host_events(prof):
    import torch

    cpu = torch.autograd.DeviceType.CPU
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if getattr(e, "device_type", None) == cpu]


def short_name(name: str) -> str:
    """A kernel's name without return type, namespaces and arguments."""
    name = name.replace("(anonymous namespace)::", "").replace("bnlk_nlk::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].strip()[:80]


def kernel_ms(events) -> dict:
    out: dict = {}
    for name, t0, t1 in events:
        k = short_name(name)
        out[k] = out.get(k, 0.0) + (t1 - t0) / 1e3
    return out


def _union(intervals):
    merged = []
    for t0, t1 in sorted(intervals):
        if merged and t0 <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t1)
        else:
            merged.append([t0, t1])
    return merged


def busy_s(events) -> float:
    """Seconds in which at least one device activity ran."""
    return sum(t1 - t0 for t0, t1 in _union((e[1], e[2]) for e in events)) / 1e6


@dataclasses.dataclass
class Trace:
    """What the per-layer readers read: the device and host events of the
    profiled request, its wall seconds, its frames and the NL-Kalman
    passes it ran (``k1_passes``: the (FLOPs, bytes) of each, counted from
    shapes)."""

    events: list
    host: list
    wall_s: float
    frames: int
    k1_passes: list

    def seconds_where(self, pred) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.events if pred(short_name(n))) / 1e6


def _mismatches(events, counted) -> list[str]:
    """Where the kernels the profile saw disagree with the launches the
    program counted."""
    names = [short_name(n) for n, _, _ in events]
    why = []
    for k, parts in KERNELS.items():
        seen = [sum(n.startswith(p) for n in names) for p in parts]
        if k == "K1" and any(s != counted[k] for s in seen):
            why.append(f"K1: profiled {dict(zip(parts, seen))} of {counted[k]} launches")
        elif k != "K1" and sum(seen) != counted[k]:
            why.append(f"{k}: profiled {sum(seen)} of {counted[k]} launches")
    return why


def profile_request(run, counters, frames: int, k1_passes: list) -> Trace:
    """Run ``run()`` (one whole request, ending in a device sync) under the
    profiler until the kernels it saw match the launches the program
    counted; raise after ``ATTEMPTS`` tries that never agree."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    reasons = []
    for _ in range(ATTEMPTS):
        before = {k: c.count for k, c in counters().items()}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counted = {k: c.count - before[k] for k, c in counters().items()}
        events = device_events(prof)
        why = _mismatches(events, counted)
        if not events:
            why.append("the profiler saw no device time")
        if not why:
            print(f"trace: every counted launch profiled, attempt {len(reasons) + 1}",
                  file=sys.stderr)
            return Trace(events, host_events(prof), wall, frames, k1_passes)
        reasons.append("; ".join(why))
    raise RuntimeError("the profiler lost kernels in every attempt: " + " | ".join(reasons))


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps of the
    device summed by what the host was doing in them (the innermost host
    operation that overlaps a gap most)."""
    ops = sorted(kernel_ms(trace.events).items(), key=lambda kv: -kv[1])[:top]
    busy = _union((e[1], e[2]) for e in trace.events)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:]) if b[0] > a[1]]
    host = sorted(trace.host, key=lambda e: e[1])
    by: dict = {}
    for g0, g1 in gaps:
        best, key = "host", (0.0, 0.0)
        for name, h0, h1 in host:
            if h0 >= g1:
                break
            ov = min(h1, g1) - max(h0, g0)
            if ov > 0 and (ov, h0 - h1) > key:
                best, key = name, (ov, h0 - h1)
        by[best] = by.get(best, 0.0) + (g1 - g0) / 1e6
    gaps_top = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v / 1e3] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps_top]}
