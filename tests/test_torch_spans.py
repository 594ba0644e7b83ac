"""Layer spans and per-request counters (``utils.profiling.span``,
``last_request``) and the benchmark's readers of them
(``portbench/metrics/``): off without a profiler, their count and nesting
in a profiled request, each reader on a hand-built record, and, marked
``cuda``, the spans of a request on the card.

This file imports no JAX. On a GPU machine, run
``python -m pytest tests/test_torch_spans.py -m cuda --noconftest -q``.
"""

import collections
import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bwd_nlkalman_tpu_torch import FlowConfig, NLKalmanDenoiser
from bwd_nlkalman_tpu_torch._dispatch import LaunchCounter, counted
from bwd_nlkalman_tpu_torch.pipeline import sequence
from bwd_nlkalman_tpu_torch.utils import last_request, profiling, span
from portbench import cells
from portbench.tests.tiny import ROOT
from portbench.trace import Trace, device_events, short_name

T, H, W = 3, 32, 48
FLOW = FlowConfig(nscales=2, nwarps=1, max_iters=10)   # few ops: the profiler records each
READERS = ("k2_iters_per_flow", "flow_glue_ms_per_frame", "warp_ms_per_frame",
           "driver_ms_per_frame")
CPU = torch.device("cpu")


@pytest.fixture
def recorder(monkeypatch):
    """A fresh recorder: no request recorded yet."""
    rec = profiling._Recorder()
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    return rec


@pytest.fixture(scope="module")
def clip():
    torch.manual_seed(3)
    return torch.rand(T, H, W, 1) * 255.0


class _FakeEvent:
    """Stands in for ``torch.cuda.Event`` on the CPU; counts its instances
    and reads 2 ms between any two."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.stream = None

    def record(self, stream):
        self.stream = stream

    def synchronize(self):
        assert self.stream is not None

    def elapsed_time(self, end):
        assert self.stream == end.stream == "stream"
        return 2.0


@pytest.mark.parametrize("traced", [False, True])
def test_a_span_is_one_check_off_and_times_the_stream_on(recorder, monkeypatch, clip, traced):
    """Off, spans on a CUDA device make no CUDA event and keep no record,
    and a clip's outputs are those of a profiled run bit for bit; on, each
    span of a CUDA device takes two events on that device's current stream
    and reads its extent from them."""
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: "stream")
    cuda = torch.device("cuda")
    ctx = profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext()
    with ctx:
        with span("request", cuda):
            with span("flow", cuda):
                pass
    if not traced:
        assert _FakeEvent.made == 0 and last_request() is None
        model = NLKalmanDenoiser(20.0, H, W, FLOW, device="cpu")
        off = model(clip)
        assert last_request() is None and recorder.open is None
        with profile(activities=[ProfilerActivity.CPU]):
            on = model(clip)
        assert all(torch.equal(a, b) for a, b in zip(off, on))
        return
    req = last_request()
    assert _FakeEvent.made == 4 and recorder.open is None
    assert [(s.name, s.parent, s.device_ms, s.events) for s in req.spans] == [
        ("bnlk.request", None, 2.0, None), ("bnlk.flow", 0, 2.0, None)]


@pytest.mark.parametrize("smoother,flows,passes", [
    ("rts", 2 * (T - 1), 3 * T - 1), ("fsmo", T - 1, 3 * T - 1),
    ("lsmo", 2 * (T - 1), 3 * T - 1), ("none", T - 1, 2 * T)])
def test_a_profiled_request_records_its_layer_spans(recorder, clip, smoother, flows, passes):
    """Under a CPU profiler a request keeps one span a flow, occlusion mask,
    warp and NL-Kalman pass, each a child of the request's span with its
    id, timed by the host on the CPU; each is a host-only profiler op, not
    a user annotation. A request run after it with tracing off leaves the
    record alone."""
    model = NLKalmanDenoiser(20.0, H, W, FLOW, device="cpu", smoother=smoother)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model(clip)
    req = last_request()
    names = collections.Counter(s.name for s in req.spans)
    assert names == {"bnlk.request": 1, "bnlk.flow": flows, "bnlk.occlusion": flows,
                     "bnlk.warp": flows, "bnlk.nlk": passes}
    assert req.spans[0].name == "bnlk.request" and req.spans[0].parent is None
    assert all(s.parent == 0 for s in req.spans[1:])
    assert {s.request for s in req.spans} == {req.id}
    assert all(s.host_end >= s.host_start and s.device_ms >= 0.0 for s in req.spans)
    assert req.self_ms(0) >= 0.0
    assert req.counters == {"k2_iterations": 0}      # no K2 launch on the CPU
    # the profiler's raw events: its event list takes seconds to build here
    ops = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("bnlk.")]
    assert collections.Counter(e.name() for e in ops) == names
    assert not any(e.is_user_annotation() for e in ops)
    assert {e.device_type() for e in ops} == {torch.autograd.DeviceType.CPU}
    model(clip)
    assert last_request() is req


def _trace(frames=2):
    """A traced request's events: 25 ms of K2 and 5 ms of K1."""
    events = [("void level_kernel<K2Rule, 4>(float const*)", 0.0, 25000.0),
              ("void site_kernel<8, 2, 1, float>(float*)", 25000.0, 30000.0)]
    return Trace(events, [], 0.2, frames, [])


def _record():
    S = profiling.Span
    spans = [S("bnlk.request", None, 7, 0.0, device_ms=100.0),
             S("bnlk.flow", 0, 7, 0.0, device_ms=30.0), S("bnlk.flow", 0, 7, 0.0, device_ms=20.0),
             S("bnlk.occlusion", 0, 7, 0.0, device_ms=1.0),
             S("bnlk.warp", 0, 7, 0.0, device_ms=2.0),
             S("bnlk.nlk", 0, 7, 0.0, device_ms=40.0)]
    return profiling.Request(7, spans, {"k2_iterations": 1000}, {})


@pytest.mark.parametrize("name,value", zip(READERS, (500.0, 12.5, 1.5, 3.5)))
def test_each_span_reader_on_a_hand_built_record(recorder, name, value):
    """1000 iterations over 2 flows; (30 + 20 - 25) ms of flow extent past
    K2's kernels, (1 + 2) ms of warp and occlusion and (100 - 93) ms of the
    request's own, over 2 frames. None without a record, without spans and,
    for the K2 reader, without an iteration counted."""
    read = cells.load_module(ROOT, "metrics", name).read
    assert read(_trace()) is None
    recorder.last = profiling.Request(0, [], {}, {})
    assert read(_trace()) is None
    recorder.last = _record()
    assert read(_trace()) == pytest.approx(value)
    recorder.last.counters = {}
    assert (read(_trace()) is None) == (name == "k2_iters_per_flow")


def test_counter_snapshots_count_on_the_device_across_a_wrap():
    c = LaunchCounter()
    c.slot(CPU).fill_(2 ** 31 - 5)
    before = c.snapshot()
    c.add(3)
    c.slot(CPU).copy_(torch.tensor([-2 ** 31 + 4], dtype=torch.int32))
    assert counted(before, c.snapshot()) == 3 + 9
    assert counted((0, {}), c.snapshot()) == 3 + 2 ** 31 + 4


@pytest.mark.cuda
def test_spans_on_the_card(monkeypatch, recorder):
    """On the card, the profiled request's device activities hold no span
    and the same kernels as a profiled request without spans, the request
    span's extent holds its children's, and K2's iterations per flow times
    the flows are what ``ITERATIONS`` counted over the request."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from bwd_nlkalman_tpu_torch.flow.tvl1_cuda import ITERATIONS

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    torch.manual_seed(5)
    x = (torch.rand(4, 96, 128, 1) * 255.0).to(dev)
    model = NLKalmanDenoiser(20.0, 96, 128, device=dev)
    model(x)
    torch.cuda.synchronize()

    def kernels(prof):
        return collections.Counter(short_name(n) for n, _, _ in device_events(prof)
                                   if not n.startswith(("Memcpy", "Memset")))

    before = ITERATIONS.count
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(x)
        torch.cuda.synchronize()
    iters = ITERATIONS.count - before
    events = device_events(prof)
    assert events and not any(n.startswith("bnlk.") for n, _, _ in events)
    req = last_request()
    assert iters > 0 and req.counters["k2_iterations"] == iters
    trace = Trace(events, [], 1.0, x.shape[0], [])
    per_flow = cells.load_module(ROOT, "metrics", "k2_iters_per_flow").read(trace)
    assert per_flow * req.count("flow") == pytest.approx(iters)
    assert req.self_ms(0) >= 0.0 and all(s.device_ms > 0.0 for s in req.spans)
    monkeypatch.setattr(sequence, "span", lambda *a, **k: contextlib.nullcontext())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as bare:
        model(x)
        torch.cuda.synchronize()
    assert kernels(prof) == kernels(bare)
    assert last_request() is req
