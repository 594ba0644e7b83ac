"""Readings that set the limits of ``correct``: the program's and the
control's numbers on many seeds, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds <n> ... \
        [--control-seeds <n> ...] [--seconds <s>]

For each seed of ``--seeds`` one run of the cell as ``run.py`` makes it
(set-up, a window of ``--seconds``, the check), and for each seed of
``--control-seeds`` the same with the configuration's control in the
program's place: its lower-precision options ("control" in the
configuration file). One JSON line a run, with every number compared.
The benchmark's own runs never run the control.
"""

import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    from portbench import cells
    from portbench.harness import run_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = cells.load(root, args.workload)
    runs = [(s, False) for s in args.seeds] + [(s, True) for s in args.control_seeds]
    for seed, control in runs:
        t0 = time.time()
        r = run_cell(cell, seed, args.seconds, False, torch.device("cuda"), t0,
                     sync=torch.cuda.synchronize, control=control)
        print(json.dumps({"workload": cell.name, "seed": seed, "control": control,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "seconds": time.time() - t0, "checks": r["checks"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
