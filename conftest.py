"""Test harness settings for every pytest run under this repository.

Pytest loads this file before ``tests/conftest.py``, which imports jax, so
the XLA flags below are set before XLA reads them.

Every test phase (setup, call, teardown) runs under a time limit of
``DEFAULT_TIME_LIMIT_S``.
"""

import faulthandler
import os

import pytest

# Lower XLA's CPU backend optimisation for the JAX references the tests
# compare the port against: most of such a test's time is XLA compiling the
# JAX package's whole-sequence programs for toy clips, and at this level
# that compile takes about half as long, while the code it makes runs a few
# seconds longer at these sizes.  A flag already set is left alone; the CLI
# tests' subprocesses inherit them.
flags = os.environ.get("XLA_FLAGS", "")
for flag in ("--xla_backend_optimization_level=0",
             "--xla_llvm_disable_expensive_passes=true"):
    if flag.split("=")[0] not in flags:
        flags += " " + flag
os.environ["XLA_FLAGS"] = flags.strip()

DEFAULT_TIME_LIMIT_S = 600.0
_stderr_fd = pytest.StashKey[int]()


def pytest_configure(config):
    # a dup of the real stderr, taken while output capture is suspended,
    # so the traceback of a test past its limit outlives its process
    config.stash[_stderr_fd] = os.dup(2)


def pytest_unconfigure(config):
    os.close(config.stash[_stderr_fd])


def _time_limited(item):
    """Run one test phase under the time limit.

    At the limit faulthandler prints every thread's traceback and ends the
    process, even while native code (an XLA compile, a torch op, a lock)
    holds the interpreter, where no Python signal handler could run.
    Under xdist that fails this one test, the worker is replaced and the
    run goes on.
    """
    faulthandler.dump_traceback_later(
        DEFAULT_TIME_LIMIT_S, exit=True, file=item.config.stash[_stderr_fd])
    try:
        return (yield)
    finally:
        faulthandler.cancel_dump_traceback_later()


pytest_runtest_setup = pytest.hookimpl(wrapper=True)(_time_limited)
pytest_runtest_call = pytest.hookimpl(wrapper=True)(_time_limited)
pytest_runtest_teardown = pytest.hookimpl(wrapper=True)(_time_limited)
