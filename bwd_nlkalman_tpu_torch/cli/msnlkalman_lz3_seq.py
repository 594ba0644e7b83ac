"""msnlkalman-lz3-seq equivalent: the Lanczos-3 multiscale pipeline over a
frame sequence (scripts/msnlkalman-lz3-seq.sh / -gt.sh). A thin wrapper
over ``nlkalman_seq`` with ``--multiscale --pyramid lz3``; ``--device``
as there (default cuda).

Run as ``python -m bwd_nlkalman_tpu_torch.cli.msnlkalman_lz3_seq``.
"""

from __future__ import annotations

import sys

from .nlkalman_seq import main as _seq_main


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    return _seq_main(argv + ["--multiscale", "--pyramid", "lz3"])


if __name__ == "__main__":
    sys.exit(main())
