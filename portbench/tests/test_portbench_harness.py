"""The benchmark's harness on the CPU: inputs by seed, cells and readers
found by name, the import checks, and runs of every cell at a tiny size,
sound and with the timed path broken underneath."""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import cells, harness
from portbench import traffic as tr
from portbench.tests.tiny import PKG, ROOT, SEARCH_CELL, tiny_tree

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CELLS.append(SEARCH_CELL["name"])
SEED = 2 ** 31 + 12345          # above 32 signed bits, as the driver's seeds are
CPU = torch.device("cpu")


def _traffic(name):
    return json.loads((PKG / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["scene-clips", "texture-clips", "random-trials"])
def test_inputs_are_the_same_for_a_seed_and_differ_across_seeds(name):
    t = _traffic(name)
    a = tr.clean_clips(t, 2, 3, 16, 24, 1, SEED, CPU)
    b = tr.clean_clips(t, 2, 3, 16, 24, 1, SEED, CPU)
    c = tr.clean_clips(t, 2, 3, 16, 24, 1, SEED + 1, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    lo, hi = t["range"]
    assert all(float(x.min()) >= lo - 1e-3 and float(x.max()) <= hi + 1e-3 for x in a)
    if t["noise"] == "gaussian":
        n1, n2 = tr.noisy_clips(t, a, 20.0, SEED), tr.noisy_clips(t, a, 20.0, SEED)
        assert all(torch.equal(x, y) for x, y in zip(n1, n2))
    else:
        assert np.array_equal(tr.awgn_seeds(2, 3, SEED), tr.awgn_seeds(2, 3, SEED))
        d1, d2 = tr.trial_draws(t, SEED), tr.trial_draws(t, SEED)
        assert [next(d1) for _ in range(4)] == [next(d2) for _ in range(4)]


def test_frames_translate_by_the_shift_and_the_order_cycles_the_pool():
    t = _traffic("scene-clips")
    clip = tr.clean_clips(t, 1, 3, 16, 24, 1, SEED, CPU)[0]
    assert torch.equal(clip[1][:-1, :-1], clip[0][1:, 1:])
    order = tr.request_order(t, 3 * t["pool"], SEED)
    assert sorted(order[:t["pool"]]) == list(range(t["pool"]))
    assert order == tr.request_order(t, 3 * t["pool"], SEED)


def test_random_search_draw_order():
    """The trial draws follow random_search's: integers for npatches, then
    uniforms, from the same generator calls."""
    t = _traffic("random-trials")
    d = next(tr.trial_draws(t, SEED))
    r = tr.rng(SEED, "draws")
    assert d == {"npatches": int(r.integers(1, 99)), "beta_x": float(r.uniform(0, 8)),
                 "beta_t": float(r.uniform(2, 12)), "dista_lambda": float(r.uniform(0, 1))}


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix and a metric added as files, and named
    in BENCHMARK.json, are found without a change to the harness."""
    root = tiny_tree(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    pkg = root / "portbench"
    cfg = json.loads((pkg / "configs" / "nlkseq-1080p-gray-s20.json").read_text())
    cfg["sigma"] = 40.0
    (pkg / "configs" / "nlkseq-new.json").write_text(json.dumps(cfg))
    mix = dict(_traffic("scene-clips"), wrap=4)
    (pkg / "traffic" / "new-mix.json").write_text(json.dumps(mix))
    (pkg / "metrics" / "frames_seen.py").write_text(
        "def read(trace):\n    return float(trace.frames)\n")
    bench["configs"].append({"name": "nlkseq-new", "source": "x",
                             "file": "portbench/configs/nlkseq-new.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "new-cell", "config": "nlkseq-new",
                               "traffic": "new-mix", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                               "source": "device_trace", "layer": "x",
                               "moves": "frames_per_s", "workloads": ["new-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cells.load(root, "new-cell")
    assert cell.config["sigma"] == 40.0 and cell.traffic["wrap"] == 4
    assert "frames_seen" in [m["name"] for m in cell.per_layer]
    assert "frames_seen" not in [m["name"] for m in cells.load(root, CELLS[0]).per_layer]

    class Traced:
        frames = 3

    assert cells.load_module(root, "metrics", "frames_seen").read(Traced()) == 3.0
    r = harness.run_cell(cell, SEED, 0.01, False, CPU, 0.0)
    assert r["correct"], r["checks"]
    with pytest.raises(KeyError):
        cells.load(root, "no-such-cell")


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["bwd_nlkalman_tpu_torch", "bwd_nlkalman_tpu_torch.core",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "bwd_nlkalman_tpu.ops", "flax"]) == [
        "bwd_nlkalman_tpu", "flax", "jax"]


def _loaded_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole tiny run of every cell, in a fresh process."""
    root = tiny_tree(tmp_path)
    code = (f"import sys, time, torch; sys.path.insert(0, {str(ROOT)!r})\n"
            "from portbench import cells, harness\n"
            + "".join(f"harness.run_cell(cells.load({str(root)!r}, {c!r}), 5, 0.01, False, "
                      f"torch.device('cpu'), time.time())\n" for c in CELLS))
    loaded = _loaded_after(code)
    assert "bwd_nlkalman_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import portbench.reference.sequence, portbench.reference.search")
    assert not loaded & (set(harness.FORBIDDEN) | {"bwd_nlkalman_tpu_torch"})


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tmp_path, cell):
    r = harness.run_cell(cells.load(tiny_tree(tmp_path), cell), SEED, 0.01, False, CPU, 0.0)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and list(r) == ["correct", "attempted", "failed", "metrics",
                                               "device", "checks"]
    names = {m["name"] for m in cells.load(tmp_path, cell).end_to_end}
    # one request in so short a window: no percentile
    assert {"frames_per_s", "setup_s"} <= set(r["metrics"]) <= names
