"""The per-phase time limit of the repository's root ``conftest.py``.

Each case runs pytest in a subprocess on a small generated test file, in a
directory that holds a copy of that conftest with its limit cut to 1 s.
Installed pytest plugins are not loaded there, so each process starts in
about a second.
"""

import os
import shutil
import subprocess
import sys

ROOT_CONFTEST = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "conftest.py")

# libc's sleep does not return to Python until it ends, as an XLA compile
# or a torch op would not
HANG = """import ctypes


def test_blocks_in_native_code():
    sleep = ctypes.CDLL(None).sleep
    sleep.argtypes, sleep.restype = [ctypes.c_uint], ctypes.c_uint
    sleep(120)


def test_next_of_the_file():
    assert True
"""

QUICK = """def test_quick():
    assert True
"""

# sleeps past the last test's limit after every phase has ended
SLEEP_AT_END = """import ctypes


def pytest_sessionfinish(session):
    sleep = ctypes.CDLL(None).sleep
    sleep.argtypes, sleep.restype = [ctypes.c_uint], ctypes.c_uint
    sleep(2)
"""


def _pytest(tmp_path, files, *args):
    shutil.copy(ROOT_CONFTEST, tmp_path / "conftest.py")
    with open(tmp_path / "conftest.py", "a") as f:
        f.write("\nDEFAULT_TIME_LIMIT_S = 1.0\n")
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    # well inside this test's own 600 s limit, so that a hang in the child
    # is reported here with its output
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         *args],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(tmp_path),
                           "PYTEST_DISABLE_PLUGIN_AUTOLOAD": "1"},
        capture_output=True, text=True, timeout=60)


def test_phase_past_its_limit_fails_alone_with_its_traceback(tmp_path):
    run = _pytest(tmp_path, {"test_hang.py": HANG},
                  "-p", "xdist", "-n", "1", "test_hang.py")
    out = run.stdout + run.stderr
    assert run.returncode == 1, out
    assert "Timeout (0:00:01)!" in out, out
    assert 'test_hang.py", line 7 in test_blocks_in_native_code' in out, out
    assert "FAILED test_hang.py::test_blocks_in_native_code" in out, out
    assert "1 failed, 1 passed" in out, out


def test_phase_within_its_limit_leaves_no_timer_armed(tmp_path):
    run = _pytest(tmp_path, {"test_quick.py": QUICK,
                             "sleep_at_end.py": SLEEP_AT_END},
                  "-p", "sleep_at_end", "test_quick.py")
    out = run.stdout + run.stderr
    assert run.returncode == 0, out
    assert "Timeout" not in out, out
    assert "1 passed" in out, out
