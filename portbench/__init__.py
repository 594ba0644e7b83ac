"""The benchmark of ``bwd_nlkalman_tpu_torch``, the PyTorch and CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, traffic mix or metric sits in a file of its
own, found by its name: ``configs/<name>.json``, ``traffic/<name>.json``,
``metrics/<name>.py`` (per-layer readers of the traced run),
``e2e/<name>.py`` (end-to-end readers of the window) and
``drivers/<entry>.py`` (how a configuration's entry point is set up,
driven and checked). ``reference/`` is the plain reference that decides
``correct``.
"""
