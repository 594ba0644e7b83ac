"""msnlkalman-seq equivalent: the multiscale pipeline over a frame
sequence (scripts/msnlkalman-seq.sh / -gt.sh). A thin wrapper over
``nlkalman_seq`` with ``--multiscale``; ``--device`` as there (default
cuda).

Run as ``python -m bwd_nlkalman_tpu_torch.cli.msnlkalman_seq``.
"""

from __future__ import annotations

import sys

from .nlkalman_seq import main as _seq_main


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    return _seq_main(argv + ["--multiscale"])


if __name__ == "__main__":
    sys.exit(main())
