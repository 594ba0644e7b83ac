"""``utils.profiling`` (``StageTimer``, ``trace``) against the JAX
package's, on the CPU: the timer as ``tests/test_utils.py`` drives JAX's,
its report the same text as JAX's for the same times, and the trace
written as a Chrome trace."""

import json

import numpy as np
import torch

from bwd_nlkalman_tpu.utils import StageTimer as JStageTimer
from bwd_nlkalman_tpu_torch.utils import StageTimer, trace

torch.set_num_threads(1)


def test_stage_timer():
    t = StageTimer()
    with t.stage("a"):
        sum(range(1000))
    out = t.measure("b", lambda: np.zeros(3))
    assert out.shape == (3,)
    rep = t.report()
    assert "a" in rep and "b" in rep


def test_stage_timer_waits_on_tensors_and_counts_calls():
    t = StageTimer()
    x = torch.ones(4)
    for _ in range(3):
        with t.stage("add", result_ref=(x + 1, {"k": [x]})):
            pass
    out = t.measure("mul", torch.mul, x, 2.0)
    assert torch.equal(out, torch.full((4,), 2.0))
    assert t.counts == {"add": 3, "mul": 1}
    assert all(v >= 0.0 for v in t.times.values())


def test_report_formats_as_jax():
    long = "a stage name of 30 characters."
    times = {"flow": 1.23456, "nlk pass": 12.5, "warp": 0.0004, long: 3.0}
    counts = {"flow": 3, "nlk pass": 7, "warp": 1, long: 2}
    mine, theirs = StageTimer(), JStageTimer()
    for t in (mine, theirs):
        t.times, t.counts = dict(times), dict(counts)
    assert mine.report() == theirs.report()
    assert mine.report().splitlines()[1].startswith("nlk pass")


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
