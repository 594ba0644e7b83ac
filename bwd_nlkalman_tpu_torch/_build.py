"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` files compile with ``nvcc`` into one shared library
with a plain C interface, loaded with ``ctypes``. The build runs at first
use, from the sources in the checkout alone, into
``build/torch_kernels/<hash>/`` at the repository root, where ``<hash>``
is a digest of the sources and the compiler flags: a changed source
builds anew, an unchanged one loads the library already built.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)
LIB_NAME = "libbnlk_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double

# C entry points: name -> argument types (all return a cudaError_t as int)
SIGNATURES = {
    "bnlk_warp": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "bnlk_tvl1_level": [_P, _P, _P, _P, _I, _I, _I, _D, _F, _D, _D, _I, _I, _P],
    "bnlk_nlk_dct": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "bnlk_nlk_sites": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _I, _I, _I, _F, _F, _F, _F, _F, _P],
    "bnlk_nlk_aggregate": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _P],
    "bnlk_nlk_fold": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def build() -> tuple[Path, float]:
    """Compile the kernels if needed; returns (library path, seconds spent)."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    cu = [str(p) for p in sorted(CSRC.glob("*.cu"))]
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, *cu]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib_path, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def call(name: str, *args) -> None:
    """Call a C entry point; raise if it reports a CUDA error."""
    rc = getattr(library(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
