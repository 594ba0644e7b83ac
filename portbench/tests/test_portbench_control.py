"""The control on the card: the configuration's lower-precision path in
the program's place, at the cell's own size, has to come out not correct.

    python -m pytest portbench/tests/test_portbench_control.py -m cuda -q

Skips without a CUDA device."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import cells, harness
from portbench.tests.tiny import ROOT, SEARCH_CELL, SEARCH_CONFIG

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS + [SEARCH_CELL["name"]])
def test_the_control_is_not_correct(tmp_path, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(SEARCH_CONFIG)
    bench["workloads"].append(SEARCH_CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench").symlink_to(ROOT / "portbench")
    torch.backends.cuda.matmul.allow_tf32 = False
    r = harness.run_cell(cells.load(tmp_path, cell), 2 ** 31 + 99, 1.0, False,
                         torch.device("cuda"), 0.0, sync=torch.cuda.synchronize, control=True)
    assert not r["correct"], r["checks"]
