"""Profiling and tracing (port of ``bwd_nlkalman_tpu.utils.profiling``).

A per-stage wall-clock timer that waits for the card to finish the
stage's work, a ``torch.profiler`` trace context that writes a Chrome
trace of the host's and the card's activity, and the layer spans the
pipeline records while a profiler runs (:func:`span`,
:func:`last_request`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch
import torch.autograd.profiler as _autograd_profiler

from .._dispatch import counted


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


# ---------------------------------------------------------------------------
# Layer spans. Tracing is on exactly while a torch profiler is enabled
# (``trace()`` above, or any ``torch.profiler.profile``); there is no other
# switch. Off, a span is that one check.


@dataclasses.dataclass
class Span:
    """One layer span of a traced request. ``name`` is "bnlk.<layer>",
    ``parent`` the index of the enclosing span in the request's ``spans``
    (None for the request's own), ``request`` the request's id, ``host_start``
    and ``host_end`` ``time.perf_counter()`` seconds. ``device_ms`` is the
    span's device extent: from the moment the stream finished the work
    enqueued before the span to the end of the span's own work, the
    device's waits for the host inside the span included, so that sibling
    spans and the gaps between them tile their parent. It is timed by two
    CUDA events on the current stream of the span's device (with a mesh,
    the mesh's first device, where whole frames live), or by the host
    times for work on the CPU."""

    name: str
    parent: int | None
    request: int
    host_start: float
    host_end: float = 0.0
    device_ms: float = 0.0
    events: tuple | None = None     # (start, end) CUDA events until resolved


@dataclasses.dataclass
class Request:
    """The record of one traced request: its spans (``spans[0]`` the
    request's own) and its counters, by name (``k2_iterations``: K2's
    primal-dual iterations, ``flow.tvl1_cuda.ITERATIONS``)."""

    id: int
    spans: list
    counters: dict
    snapshots: dict      # name -> (snapshot at entry, at exit), until resolved

    def resolve(self) -> None:
        """Read the device extents and counters (waits for the request's
        last event: call once the device has finished the request)."""
        for s in self.spans:
            if s.events is not None:
                s.events[1].synchronize()
                s.device_ms = s.events[0].elapsed_time(s.events[1])
                s.events = None
        for name, (before, after) in self.snapshots.items():
            self.counters[name] = counted(before, after)
        self.snapshots = {}

    def count(self, layer: str) -> int:
        """The number of spans of ``layer``."""
        return sum(s.name == "bnlk." + layer for s in self.spans)

    def extent_ms(self, *layers: str) -> float:
        """Summed device extent of the spans of ``layers``, in ms."""
        names = {"bnlk." + layer for layer in layers}
        return sum(s.device_ms for s in self.spans if s.name in names)

    def self_ms(self, i: int = 0) -> float:
        """Device extent of span ``i`` less its child spans' extents, in ms."""
        return self.spans[i].device_ms - sum(s.device_ms for s in self.spans
                                             if s.parent == i)


class _Recorder:
    """The open request's record and the indices of its open spans, and
    the newest finished request's record."""

    def __init__(self):
        self.open: Request | None = None
        self.stack: list = []
        self.last: Request | None = None
        self.next_id = 0


_RECORDER = _Recorder()
_NO_SPAN = contextlib.nullcontext()


class _Span:
    def __init__(self, layer: str, device: torch.device, counters):
        self.name = "bnlk." + layer
        self.device = device
        self.counters = counters or {}

    def __enter__(self):
        rec = _RECORDER
        self.op = torch._C._profiler._RecordFunctionFast(self.name)
        self.op.__enter__()
        self.starts = rec.open is None and self.name == "bnlk.request"
        if self.starts:
            self.before = {k: c.snapshot() for k, c in self.counters.items()}
            rec.open = Request(rec.next_id, [], {}, {})
            rec.next_id += 1
        self.span = None
        if rec.open is not None:
            self.span = Span(self.name, rec.stack[-1] if rec.stack else None, rec.open.id,
                             time.perf_counter())
            if self.device.type == "cuda":
                self.span.events = (torch.cuda.Event(enable_timing=True),
                                    torch.cuda.Event(enable_timing=True))
                self.span.events[0].record(torch.cuda.current_stream(self.device))
            rec.stack.append(len(rec.open.spans))
            rec.open.spans.append(self.span)
        return self

    def __exit__(self, exc_type, exc, tb):
        rec = _RECORDER
        try:
            s = self.span
            if s is not None:
                if s.events is not None:
                    s.events[1].record(torch.cuda.current_stream(self.device))
                s.host_end = time.perf_counter()
                if s.events is None:
                    s.device_ms = 1e3 * (s.host_end - s.host_start)
                rec.stack.pop()
            if self.starts:
                req, rec.open, rec.stack = rec.open, None, []
                if exc_type is None:
                    req.snapshots = {k: (self.before[k], c.snapshot())
                                     for k, c in self.counters.items()}
                    rec.last = req
        finally:
            self.op.__exit__(exc_type, exc, tb)
        return False


def span(layer: str, device, counters: dict | None = None):
    """A context that records the layer span "bnlk.<layer>" of work on
    ``device`` while a torch profiler is enabled, and is one flag check
    otherwise (no profiler call, no CUDA event, no record).

    On, it records a host-only profiler op of that name (not a user
    annotation, so it shows as no device activity), on the profiler's
    clock and in the Chrome trace ``trace()`` writes. The span with layer
    "request" opened outside any request starts a request's record; it
    takes each of ``counters`` (name -> ``LaunchCounter``) at entry and at
    exit, as device-side copies. Spans inside the request are kept in its
    record (:class:`Span`); spans outside any request record the profiler
    op alone. The process keeps one record, the newest request's
    (:func:`last_request`)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(layer, device, counters)


def last_request() -> Request | None:
    """The record of the newest request run with tracing on (None before
    one), resolved. A newer traced request replaces it; requests run with
    tracing off leave it alone. Read it after the device has finished the
    request."""
    req = _RECORDER.last
    if req is not None:
        req.resolve()
    return req
