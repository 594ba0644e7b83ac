"""A benchmark tree at a size the CPU runs in seconds: the real drivers,
readers and traffic generator, tiny configurations and traffic files."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
ROOT = PKG.parent


def _cfg(name: str) -> dict:
    return json.loads((PKG / "configs" / f"{name}.json").read_text())


# the search cell, which BENCHMARK.json leaves out (its host-held runs
# spread more than any bound allows, PERF.md), kept under test
SEARCH_CONFIG = {"name": "train14-search-s20", "source": "x",
                 "file": "portbench/configs/train14-search-s20.json", "reduced": ["sigma"],
                 "why": "x"}
SEARCH_CELL = {"name": "search400-fixtures", "config": "train14-search-s20",
               "traffic": "random-trials", "chips": 1, "why": "x"}


def tiny_tree(tmp: Path) -> Path:
    """``tmp`` as a benchmark root: BENCHMARK.json with the real cells and
    the search cell, copies of the real drivers, readers and traffic
    files, and the configurations cut to 32x40 frames, 4 frames a clip, 2
    search clips."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append(SEARCH_CONFIG)
    bench["workloads"].append(SEARCH_CELL)
    pkg = tmp / "portbench"
    (pkg / "configs").mkdir(parents=True)
    for kind in ("drivers", "e2e", "metrics", "traffic"):
        shutil.copytree(PKG / kind, pkg / kind, ignore=shutil.ignore_patterns("__pycache__"))
    for c in bench["configs"]:
        cfg = _cfg(c["name"])
        cfg.update(height=32, width=40, frames=4)
        cfg["check"].update(keep_within=1, block_bytes=1 << 24)
        if "clips" in cfg:
            cfg.update(clips=2, first_frame=1, border=2)
        (pkg / "configs" / f"{c['name']}.json").write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
