"""The port's non-Python sources ship with it: every file that
``_build.py`` (the CUDA kernels), ``native`` (the io library) and
``tools/warp_bench.py --variants`` compile is matched by a
``package-data`` pattern of ``pyproject.toml``, so an installed (not
editable) port can build them at first use."""

import fnmatch
import tomllib
from pathlib import Path

from bwd_nlkalman_tpu_torch import _build, native
from bwd_nlkalman_tpu_torch.tools import warp_bench

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "bwd_nlkalman_tpu_torch"


def _matches(parts, pattern: str) -> bool:
    """A package-data glob against a relative path: ``*`` within one part."""
    pat = pattern.split("/")
    return len(pat) == len(parts) and all(map(fnmatch.fnmatchcase, parts, pat))


def _shipped(path: Path) -> bool:
    """Whether a package-data pattern of its package or an enclosing one
    matches ``path``."""
    data = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"][
        "package-data"]
    rel = path.relative_to(ROOT)
    for n in range(1, len(rel.parts)):
        pkg, sub = ".".join(rel.parts[:n]), rel.parts[n:]
        if any(_matches(sub, p) for p in data.get(pkg, ())):
            return True
    return False


def test_every_built_source_is_package_data():
    read = [*_build._sources(), native.SOURCE, Path(warp_bench.HERE) / "warp_variants.cu"]
    assert all(p.exists() for p in read)
    assert not [str(p) for p in read if not _shipped(p)]


def test_every_native_source_in_the_port_is_package_data():
    found = [p for ext in ("*.cu", "*.cuh", "*.cpp", "*.h") for p in PKG.rglob(ext)]
    assert len(found) >= 13
    assert not [str(p) for p in found if not _shipped(p)]
