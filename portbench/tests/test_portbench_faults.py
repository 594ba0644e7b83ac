"""Whole runs of every cell at a tiny size on the CPU with the timed path
broken underneath: ``correct`` has to come out false for each fault the
cell can have. (One chip, so no exchange between chips to leave out.)"""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from portbench import cells, harness
from portbench.tests.tiny import ROOT, SEARCH_CELL, tiny_tree

SEED = 2 ** 31 + 777
CPU = torch.device("cpu")
SEQ = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
       if w["config"].startswith("nlkseq")]
SEARCH = [SEARCH_CELL["name"]]


def _run(tmp_path, cell):
    return harness.run_cell(cells.load(tiny_tree(tmp_path), cell), SEED, 0.01, False, CPU, 0.0)


def _pass_returns_its_frame(monkeypatch):
    """Every NL-Kalman pass returns its input unchanged."""
    import bwd_nlkalman_tpu_torch.core.nlkalman as nlk

    monkeypatch.setattr(nlk, "dense_pass", lambda cur, *a, **k: cur.clone())


def _flow_level_returns_its_start(monkeypatch):
    """Every TV-L1 level returns the flow it started from."""
    import bwd_nlkalman_tpu_torch.flow.tvl1_fused as fused

    monkeypatch.setattr(fused, "tvl1_level_plain", lambda i0, i1, u, *a, **k: u.clone())


def _outputs_altered(monkeypatch):
    """The module's flt2 comes out half a grey level off."""
    from bwd_nlkalman_tpu_torch.pipeline.sequence import NLKalmanDenoiser

    fwd = NLKalmanDenoiser.forward

    def forward(self, x):
        f1, f2, s1 = fwd(self, x)
        return f1, f2 + 0.5, s1

    monkeypatch.setattr(NLKalmanDenoiser, "forward", forward)


def _half_the_frames_unfiltered(monkeypatch):
    """The second half of every clip comes out as its noisy frames."""
    from bwd_nlkalman_tpu_torch.pipeline.sequence import NLKalmanDenoiser

    fwd = NLKalmanDenoiser.forward

    def forward(self, x):
        h = x.shape[0] // 2
        return tuple(torch.cat([o[:h], x[h:]]) for o in fwd(self, x))

    monkeypatch.setattr(NLKalmanDenoiser, "forward", forward)


def _first_frame_unfiltered(monkeypatch):
    """Frame 0's spatial passes (the only passes with no prior) return
    their input; every later step runs as it should."""
    import bwd_nlkalman_tpu_torch.pipeline.sequence as seq

    fp = seq._filter_pass

    def filter_pass(nisy, deno0, *a, **k):
        return nisy.clone() if deno0 is None else fp(nisy, deno0, *a, **k)

    monkeypatch.setattr(seq, "_filter_pass", filter_pass)


def _one_step_without_flow(monkeypatch):
    """One filter step in the middle of the clip warps its priors along a
    zero flow; every other step runs as it should."""
    import bwd_nlkalman_tpu_torch.pipeline.sequence as seq

    pair = seq.filter_frame_pair
    step = {"t": 0}

    def filter_frame_pair(noisy, flt1_prev, flt2_prev, sigma, p1, p2, flow_cfg, *a):
        step["t"] = 0 if flt2_prev is None else step["t"] + 1
        if step["t"] != 2:
            return pair(noisy, flt1_prev, flt2_prev, sigma, p1, p2, flow_cfg, *a)
        zero = noisy.new_zeros(noisy.shape[:2] + (2,))
        return seq._filter_with_flow(noisy, flt1_prev, flt2_prev, zero, flow_cfg.occ_threshold,
                                     sigma, p1, p2, *a)

    monkeypatch.setattr(seq, "filter_frame_pair", filter_frame_pair)


def _half_the_clips(monkeypatch):
    """A trial scores half of the clips and takes the mean over those."""
    import bwd_nlkalman_tpu_torch.train.search as search

    ev = search.evaluate

    def evaluate(clean, *a, fixtures=None, **k):
        n = max(1, len(clean) // 2)
        return ev(clean[:n], *a, fixtures=fixtures[:n], **k)

    monkeypatch.setattr(search, "evaluate", evaluate)


def _score_altered(monkeypatch):
    """A trial's MSE comes out 1% off."""
    import bwd_nlkalman_tpu_torch.train.search as search

    ev = search.evaluate

    def evaluate(*a, **k):
        r = ev(*a, **k)
        return dataclasses.replace(r, mse={s: 1.01 * v for s, v in r.mse.items()})

    monkeypatch.setattr(search, "evaluate", evaluate)


@pytest.mark.parametrize("cell", SEQ)
@pytest.mark.parametrize("fault", [_pass_returns_its_frame, _flow_level_returns_its_start,
                                   _outputs_altered, _half_the_frames_unfiltered,
                                   _first_frame_unfiltered, _one_step_without_flow])
def test_a_broken_sequence_is_not_correct(tmp_path, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = _run(tmp_path, cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", SEARCH)
@pytest.mark.parametrize("fault", [_pass_returns_its_frame, _flow_level_returns_its_start,
                                   _half_the_clips, _score_altered])
def test_a_broken_search_is_not_correct(tmp_path, monkeypatch, cell, fault):
    fault(monkeypatch)
    r = _run(tmp_path, cell)
    assert not r["correct"], r["checks"]
