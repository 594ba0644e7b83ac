"""Find a cell of ``BENCHMARK.json`` and everything that belongs to it,
by name: its configuration file, its traffic file, the readers of its
metrics and the driver of its configuration's entry point."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

PKG = "portbench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    run_seconds: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list
    root: Path


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(root, workload: str) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json``."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are {', '.join(cells)})")
    w = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    return Cell(workload, int(w["chips"]), int(bench["run_seconds"]), w["config"],
                json.loads((root / cfg["file"]).read_text()), w["traffic"],
                json.loads((root / PKG / "traffic" / f"{w['traffic']}.json").read_text()),
                e2e, per_layer, root)


def load_module(root, kind: str, name: str):
    """``<root>/portbench/<kind>/<name>.py`` as a module (a metric reader,
    an end-to-end reader or a driver)."""
    path = Path(root) / PKG / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path}")
    key = f"{PKG}_{kind}_{name}".replace("-", "_").replace(".", "_")
    if key in sys.modules and getattr(sys.modules[key], "__file__", None) == str(path):
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
