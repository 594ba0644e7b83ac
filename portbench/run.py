"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port
(``bwd_nlkalman_tpu_torch``) on a machine with the CUDA devices the cell
asks for. The last line of standard output is one JSON object; the
numbers compared with the reference are the last lines of standard error.
Exits non-zero, printing no result, without those devices, without the
port, or where the run loaded JAX or the JAX package.
"""

import os
import sys
import time

T_IMPORT = time.time()


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from portbench.harness import main as run, process_start_time

    return run(sys.argv[1:], root, process_start_time() or T_IMPORT)


if __name__ == "__main__":
    sys.exit(main())
