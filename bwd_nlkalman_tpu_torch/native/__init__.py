"""ctypes bindings of the port's native io library (``bnlk_io.cpp``).

The port's own copy of ``bwd_nlkalman_tpu.native``: the same entry points
(``available``, ``build``, ``read_image``, ``write_png`` 8/16-bit,
``write_tiff``, ``write_pfm``, ``write_flo``, ``write_jpeg`` and the
threaded ``FrameLoader``) over the same C ABI, plus :func:`codecs`, the
codecs compiled in.

The library builds at first use (:func:`build`, or any entry point here),
from this directory's ``bnlk_io.cpp`` alone, with ``g++`` and the JAX
package's Makefile flags, into
``build/native_io/<digest>/libbnlk_io.so`` at the repository root, where
``<digest>`` covers the source and the compiler command. Before compiling,
the compiler itself is asked for each codec's header (``g++ -E -include
png.h``); a header it finds turns on that codec's guard and links its
library, a header it lacks leaves the codec out (its entries then fail,
and :func:`codecs` does not list it). A compile error with the headers
present raises; nothing is swallowed. Concurrent builds (several test
workers) each compile in a temporary directory and move the result into
place with ``os.replace``.
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

import numpy as np

SOURCE = Path(__file__).resolve().parent / "bnlk_io.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "native_io"
LIB_NAME = "libbnlk_io.so"
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")  # native/Makefile's
# codec -> (header, guard, library, bit of bnlk_codecs())
CODECS = {"png": ("png.h", "BNLK_HAVE_PNG", "-lpng", 1),
          "tiff": ("tiffio.h", "BNLK_HAVE_TIFF", "-ltiff", 2),
          "jpeg": ("jpeglib.h", "BNLK_HAVE_JPEG", "-ljpeg", 4)}
EXTENSIONS = {".png": "png", ".tif": "tiff", ".tiff": "tiff", ".jpg": "jpeg",
              ".jpeg": "jpeg", ".pfm": None, ".flo": None}

_lib = None
BUILD_SECONDS = 0.0     # what the last build of this process took (0 if it loaded one)


def _cxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the native io library builds with g++")
    return found


@functools.lru_cache(maxsize=None)
def found_codecs() -> tuple[str, ...]:
    """The codecs whose header the compiler finds on this machine."""
    cxx = _cxx()
    have = []
    for name, (header, _, _, _) in CODECS.items():
        res = subprocess.run([cxx, "-E", "-x", "c++", "-include", "cstdio", "-include",
                              header, "-", "-o", os.devnull], input="", text=True,
                             capture_output=True)
        if res.returncode == 0:
            have.append(name)
    return tuple(have)


def _guards_and_libs() -> tuple[list[str], list[str]]:
    have = found_codecs()
    return [f"-D{CODECS[c][1]}" for c in have], [CODECS[c][2] for c in have] + ["-lpthread"]


def compile_command(out: str) -> list[str]:
    """The g++ command that builds the library into ``out``."""
    guards, libs = _guards_and_libs()
    return [_cxx(), *CXXFLAGS, *guards, "-o", out, str(SOURCE), *libs]


def lib_path() -> Path:
    """Where the library of this source and this machine's codecs lives:
    the digest covers the source, the flags, the guards and the libraries."""
    guards, libs = _guards_and_libs()
    h = hashlib.sha256(" ".join([*CXXFLAGS, *guards, *libs]).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    i = ctypes.c_int
    lib.bnlk_codecs.restype = i
    lib.bnlk_codecs.argtypes = []
    lib.bnlk_read_image.restype = fp
    lib.bnlk_read_image.argtypes = [ctypes.c_char_p, ip, ip, ip]
    lib.bnlk_write_tiff.argtypes = [ctypes.c_char_p, fp, i, i, i]
    lib.bnlk_write_png.argtypes = [ctypes.c_char_p, fp, i, i, i, i]
    lib.bnlk_write_pfm.argtypes = [ctypes.c_char_p, fp, i, i, i]
    lib.bnlk_write_flo.argtypes = [ctypes.c_char_p, fp, i, i]
    lib.bnlk_write_jpeg.argtypes = [ctypes.c_char_p, fp, i, i, i, i]
    lib.bnlk_free.argtypes = [ctypes.c_void_p]
    lib.bnlk_loader_create.restype = ctypes.c_void_p
    lib.bnlk_loader_create.argtypes = [ctypes.c_char_p, i, i, i, i, i]
    lib.bnlk_loader_next.restype = fp
    lib.bnlk_loader_next.argtypes = [ctypes.c_void_p, ip, ip, ip, ip]
    lib.bnlk_loader_destroy.argtypes = [ctypes.c_void_p]
    return lib


def build() -> ctypes.CDLL:
    """The loaded library, compiled first if this source has no build for
    this machine's codecs yet. Raises where g++ is missing or fails."""
    global _lib, BUILD_SECONDS
    if _lib is not None:
        return _lib
    path = lib_path()
    BUILD_SECONDS = 0.0
    if not path.exists():
        t0 = time.perf_counter()
        path.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
            out = os.path.join(tmp, LIB_NAME)
            res = subprocess.run(compile_command(out), capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"native io build failed ({res.returncode}):\n"
                                   f"{res.stdout}\n{res.stderr}")
            os.replace(out, path)
        BUILD_SECONDS = time.perf_counter() - t0
    _lib = _bind(path)
    return _lib


def built() -> bool:
    """Whether the library is loaded or built for this source and machine
    (builds nothing)."""
    return _lib is not None or (shutil.which("g++") is not None and lib_path().exists())


def available() -> bool:
    """Whether the library can be used here: built, or buildable at first
    use (g++ present). Builds it."""
    if shutil.which("g++") is None and _lib is None:
        return False
    build()
    return True


def codecs() -> tuple[str, ...]:
    """The library codecs compiled in ("png", "tiff", "jpeg"); PFM and FLO
    are always there."""
    mask = build().bnlk_codecs()
    return tuple(c for c, (_, _, _, bit) in CODECS.items() if mask & bit)


def has_codec(path: str) -> bool:
    """Whether the library reads and writes ``path``'s format."""
    ext = os.path.splitext(path)[1].lower()
    if ext not in EXTENSIONS:
        return False
    return EXTENSIONS[ext] is None or EXTENSIONS[ext] in codecs()


def _array(lib, ptr, w, h, c) -> np.ndarray:
    n = w.value * h.value * c.value
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy()
    lib.bnlk_free(ptr)
    return arr.reshape(h.value, w.value, c.value)


def read_image(path: str) -> np.ndarray:
    lib = build()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    ptr = lib.bnlk_read_image(path.encode(), w, h, c)
    if not ptr:
        raise IOError(f"native read failed: {path}")
    return _array(lib, ptr, w, h, c)


def _as_cfloat(img: np.ndarray):
    img = np.ascontiguousarray(np.atleast_3d(np.asarray(img, np.float32)))
    return img, img.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def write_tiff(path: str, img: np.ndarray) -> None:
    img, p = _as_cfloat(img)
    if build().bnlk_write_tiff(path.encode(), p, img.shape[1], img.shape[0], img.shape[2]):
        raise IOError(f"native tiff write failed: {path}")


def write_png(path: str, img: np.ndarray, depth: int = 8) -> None:
    img, p = _as_cfloat(img)
    if build().bnlk_write_png(path.encode(), p, img.shape[1], img.shape[0], img.shape[2],
                              depth):
        raise IOError(f"native png write failed: {path}")


def write_pfm(path: str, img: np.ndarray) -> None:
    img, p = _as_cfloat(img)
    if build().bnlk_write_pfm(path.encode(), p, img.shape[1], img.shape[0], img.shape[2]):
        raise IOError(f"native pfm write failed: {path}")


def write_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    img, p = _as_cfloat(img)
    if build().bnlk_write_jpeg(path.encode(), p, img.shape[1], img.shape[0], img.shape[2],
                               quality):
        raise IOError(f"native jpeg write failed: {path}")


def write_flo(path: str, flow: np.ndarray) -> None:
    flow, p = _as_cfloat(flow)
    if build().bnlk_write_flo(path.encode(), p, flow.shape[1], flow.shape[0]):
        raise IOError(f"native flo write failed: {path}")


class FrameLoader:
    """Threaded in-order frame prefetcher over a printf pattern: yields
    (index, frame) with the 0-based position in the sequence as index. A
    frame that fails to read ends the iteration there, without an error,
    as the JAX package's does (``bnlk_loader_next`` returns null)."""

    def __init__(self, pattern: str, first: int, last: int, step: int = 1,
                 nthreads: int = 4, max_queue: int = 8):
        self._lib = build()
        self._h = self._lib.bnlk_loader_create(pattern.encode(), first, last, step,
                                               nthreads, max_queue)

    def __iter__(self):
        return self

    def __next__(self) -> tuple[int, np.ndarray]:
        idx, w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        ptr = self._lib.bnlk_loader_next(self._h, idx, w, h, c)
        if not ptr:
            raise StopIteration
        return idx.value, _array(self._lib, ptr, w, h, c)

    def close(self):
        if self._h:
            self._lib.bnlk_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
