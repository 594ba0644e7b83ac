"""Profiling and tracing (port of ``bwd_nlkalman_tpu.utils.profiling``).

A per-stage wall-clock timer that waits for the card to finish the
stage's work, and a ``torch.profiler`` trace context that writes a
Chrome trace of the host's and the card's activity.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def _first_tensor(x):
    """The first tensor in ``x``, a tensor or a (nested) tuple, list or dict
    of them; None where there is none."""
    if isinstance(x, torch.Tensor):
        return x
    items = x.values() if isinstance(x, dict) else x if isinstance(x, (tuple, list)) else ()
    for item in items:
        t = _first_tensor(item)
        if t is not None:
            return t
    return None


def _sync(x):
    """Wait for the card where the first tensor in ``x`` lies on one
    (PyTorch returns before its kernels finish); nothing on the CPU."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
    return x


class StageTimer:
    """Accumulates per-stage wall-clock times with device sync."""

    def __init__(self):
        self.times: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def _add(self, name: str, dt: float) -> None:
        self.times[name] = self.times.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    @contextlib.contextmanager
    def stage(self, name: str, result_ref=None):
        """Time the block; with ``result_ref`` (the stage's result, read
        after the block) wait for its device first."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if result_ref is not None:
                _sync(result_ref)
            self._add(name, time.perf_counter() - t0)

    def measure(self, name: str, fn, *args, **kwargs):
        """``fn(*args, **kwargs)``, timed to the end of its device work."""
        t0 = time.perf_counter()
        out = _sync(fn(*args, **kwargs))
        self._add(name, time.perf_counter() - t0)
        return out

    def report(self) -> str:
        lines = ["stage                      total_s  calls  mean_ms"]
        for k in sorted(self.times, key=self.times.get, reverse=True):
            t, n = self.times[k], self.counts[k]
            lines.append(f"{k:<26} {t:7.3f}  {n:5d}  {1e3 * t / n:7.1f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the host and, where there is one, the card,
    written as a Chrome trace ``trace_<pid>_<n>.json`` under ``log_dir``
    (open it in chrome://tracing or Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))
