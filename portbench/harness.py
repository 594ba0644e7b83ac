"""One run of one cell: set-up, the measured window, the traced request,
the check against the reference, and the result line.

The window is a closed loop with one request in flight: the next request
starts when the previous one has finished on the device. It runs whole
requests until ``--seconds`` have passed since it opened.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from . import cells

FORBIDDEN = ("jax", "jaxlib", "flax", "bwd_nlkalman_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's, a
    JAX library's or the JAX package's (the port's own name only begins
    with the latter)."""
    tops = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


def process_start_time() -> float | None:
    """The wall-clock time this process started, from /proc; None where
    it cannot be read."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as fh:
            btime = next(int(line.split()[1]) for line in fh if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return None


@dataclasses.dataclass
class Window:
    """What the window measured, for the end-to-end readers."""

    start: float
    latencies: list      # seconds of each completed request
    frames: list         # frames of each completed request
    last_end: float
    setup_s: float


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit   # NaN fails


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(device, chips: int) -> dict:
    """The result's "device": the card's name and the peak of device memory
    allocated on the fullest card used."""
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d) for d in range(chips))}


def run_window(driver, state, seconds: float, sync) -> tuple[list, list, float, float]:
    """Requests back to back until ``seconds`` have passed; (latencies,
    frames, window start, last completion)."""
    lat, frames = [], []
    start = time.perf_counter()
    end = start
    i = 0
    while end - start < seconds:
        t0 = time.perf_counter()
        n = driver.request(state, i)
        sync()
        end = time.perf_counter()
        lat.append(end - t0)
        frames.append(n)
        i += 1
    return lat, frames, start, end


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, sync=lambda: None, control: bool = False) -> dict:
    """Everything of one run but the device checks and the printing: the
    result object, with the numbers compared under "checks". ``control``
    runs the configuration's lower-precision control in the program's
    place (``calibrate.py``)."""
    driver = cells.load_module(cell.root, "drivers", cell.config["entry"])
    state = driver.setup(cell, seed, device, control)
    sync()
    traced = None
    if trace:
        traced = driver.profile(state)
    w_start_wall = time.time()
    lat, frames, w_start, w_end = run_window(driver, state, seconds, sync)
    window = Window(w_start, lat, frames, w_end, w_start_wall - t_start)
    result = {"correct": False, "attempted": len(lat), "failed": 0,
              "metrics": {}, "device": device_info(device, cell.chips)}
    if trace:
        from .trace import breakdown, busy_s

        for m in cell.per_layer:
            v = cells.load_module(cell.root, "metrics", m["name"]).read(traced)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        result["device"]["busy_s"] = busy_s(traced.events)
        result["device"]["window_s"] = traced.wall_s
        result["breakdown"] = breakdown(traced)
    else:
        for m in cell.end_to_end:
            v = cells.load_module(cell.root, "e2e", m["name"]).read(window)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    checks = driver.check(state)
    result["correct"] = bool(checks) and all(c.ok for c in checks)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


def main(argv, root, t_start) -> int:
    args = parse(argv)
    cell = cells.load(root, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device count {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"),
                      t_start, sync=torch.cuda.synchronize)
    bad = forbidden_modules()
    if bad:
        print("portbench: the run loaded " + ", ".join(bad), file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
