"""The port's native io library against the JAX package's.

JAX's ``bnlk_io.cpp`` is built here from its own source with its
Makefile's flags into a temporary directory (``bwd_nlkalman_tpu.native._SO``
is pointed at it; nothing in the JAX package changes), and the port's
library builds from the port's copy into another. Each writes and reads
the same inputs, made from a seed: the files must be the same bytes and
the arrays the same values, for every codec. The port's ``io`` is held
to JAX's codecs with and without the library, ``FrameLoader`` to JAX's
(order, indices, the early stop at a frame that fails to read), and the
build's digest and per-codec guards are checked. Skips where the compiler
finds no codec header (JAX's source needs all three).
"""

import os
import shutil
import subprocess

import numpy as np
import pytest

from bwd_nlkalman_tpu import io as j_io
from bwd_nlkalman_tpu import native as j_native
from bwd_nlkalman_tpu_torch import io, native

J_SRC = os.path.join(os.path.dirname(j_native.__file__), "bnlk_io.cpp")
J_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-shared"]     # native/Makefile
J_LIBS = ["-lpng", "-ltiff", "-ljpeg", "-lpthread"]


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    """(JAX library path, the port's build root), both built once."""
    if shutil.which("g++") is None or set(native.found_codecs()) != {"png", "tiff", "jpeg"}:
        pytest.skip("g++ or a codec header (png.h, tiffio.h, jpeglib.h) is missing")
    d = tmp_path_factory.mktemp("native")
    so = str(d / "libbnlk_io_jax.so")
    subprocess.run(["g++", *J_FLAGS, "-o", so, J_SRC, *J_LIBS], check=True)
    return so, d / "port"


@pytest.fixture
def libs(builds, monkeypatch):
    """Both libraries loaded: JAX's through its module, the port's built
    into a temporary root (the checkout's build/ stays untouched)."""
    so, root = builds
    monkeypatch.setattr(j_native, "_SO", so)
    monkeypatch.setattr(j_native, "_lib", None)
    monkeypatch.delenv("BNLK_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "BUILD_ROOT", root)
    monkeypatch.setattr(native, "_lib", None)
    assert j_native.available()
    native.build()
    assert native.codecs() == ("png", "tiff", "jpeg")
    return j_native, native


def _image(seed, h, w, c, hi=255.0):
    return np.random.default_rng(seed).uniform(0, hi, (h, w, c)).astype(np.float32)


CASES = {  # name -> (file, channels, top of the value range, writer's extra argument)
    "png8-gray": ("a.png", 1, 255.0, 8), "png8-rgb": ("a.png", 3, 255.0, 8),
    "png16-gray": ("a.png", 1, 4000.0, 16), "png16-rgba": ("a.png", 4, 60000.0, 16),
    "tiff-gray": ("a.tif", 1, 255.0, None), "tiff-rgb": ("a.tif", 3, 255.0, None),
    "pfm-gray": ("a.pfm", 1, 255.0, None), "pfm-rgb": ("a.pfm", 3, 255.0, None),
    "flo": ("a.flo", 2, 20.0, None),
    "jpeg-gray": ("a.jpg", 1, 255.0, 90), "jpeg-rgb": ("a.jpg", 3, 255.0, 95),
}


def _write(mod, path, img, extra):
    ext = os.path.splitext(path)[1]
    if ext == ".png":
        mod.write_png(path, img, extra)
    elif ext == ".jpg":
        mod.write_jpeg(path, img, extra)
    else:
        {".tif": mod.write_tiff, ".pfm": mod.write_pfm, ".flo": mod.write_flo}[ext](path, img)


@pytest.mark.parametrize("case", list(CASES))
def test_native_files_and_arrays_identical(libs, tmp_path, case):
    """Both libraries write the same bytes, and read each other's files to
    the same arrays (33x41, values from a seed)."""
    jn, pn = libs
    name, c, hi, extra = CASES[case]
    img = _image(sorted(CASES).index(case), 33, 41, c, hi)
    if name.endswith(".flo"):
        img -= 10.0
    p, j = str(tmp_path / ("p-" + name)), str(tmp_path / ("j-" + name))
    _write(pn, p, img, extra)
    _write(jn, j, img, extra)
    assert open(p, "rb").read() == open(j, "rb").read()
    got = pn.read_image(j)
    np.testing.assert_array_equal(got, jn.read_image(p))
    assert got.shape == img.shape and got.dtype == np.float32
    if name.endswith((".pfm", ".tif", ".flo")):
        np.testing.assert_array_equal(got, img)
    elif name.endswith(".png"):
        np.testing.assert_array_equal(got, np.clip(np.rint(img), 0, 65535))


def _frames(tmp_path, n, missing=()):
    pat = str(tmp_path / "f-%03d.png")
    for i in range(n):
        if i not in missing:
            j_io.write_png(pat % (i + 1), _image(100 + i, 9, 11, 3))
    return pat


@pytest.mark.parametrize("missing", [(), (3,)])
def test_frame_loader_matches_jax(libs, tmp_path, missing):
    """Frames in order with their 0-based positions; a frame that fails to
    read ends the iteration early, without an error, in both packages."""
    jn, pn = libs
    pat = _frames(tmp_path, 6, missing)
    runs = []
    for mod in (jn, pn):
        loader = mod.FrameLoader(pat, 1, 6, nthreads=3, max_queue=2)
        runs.append(list(loader))
        loader.close()
    assert [i for i, _ in runs[1]] == [i for i, _ in runs[0]] == list(range(missing[0] if missing
                                                                           else 6))
    for (_, a), (_, b) in zip(*runs):
        np.testing.assert_array_equal(a, b)
    for i, a in runs[1]:
        np.testing.assert_array_equal(a, j_io.read_image(pat % (i + 1)))


@pytest.mark.parametrize("name,c,hi", [("a.png", 3, 255.0), ("a.png", 1, 4000.0),
                                       ("a.tif", 3, 255.0), ("a.pfm", 1, 255.0),
                                       ("a.flo", 2, 20.0), ("a.jpg", 3, 255.0)])
def test_port_io_with_and_without_native(libs, tmp_path, monkeypatch, name, c, hi):
    """``io.write_image`` / ``read_image``: with native=True the JAX
    package's native bytes, 16-bit PNG rule included; with native=False its
    pure codecs' bytes (BNLK_NO_NATIVE on the JAX side); with None (the
    default, the library built and loaded) the pure bytes but for JPEG,
    which has no other route. JPEG only natively: native=False raises, as
    JAX without its library does."""
    img = _image(7, 13, 17, c, hi)
    if name.endswith(".flo"):
        img -= 10.0
    jpeg = name.endswith(".jpg")
    for mode in (True, None, False):
        p, j = str(tmp_path / f"p{mode}-{name}"), str(tmp_path / f"j{mode}-{name}")
        if mode is True or (mode is None and jpeg):
            monkeypatch.delenv("BNLK_NO_NATIVE", raising=False)
        else:
            monkeypatch.setenv("BNLK_NO_NATIVE", "1")
        if mode is False and jpeg:
            with pytest.raises(ValueError, match="JPEG needs a native io library"):
                io.write_image(p, img, native=False)
            with pytest.raises(ValueError, match="JPEG"):
                j_io.write_image(j, img)
            continue
        io.write_image(p, img, native=mode)
        j_io.write_image(j, img)
        assert open(p, "rb").read() == open(j, "rb").read(), mode
        np.testing.assert_array_equal(io.read_image(j, native=mode), j_io.read_image(p))


def test_build_digest_and_guards(libs, tmp_path, monkeypatch):
    """The library lives under build/native_io/<digest>/ by default, the
    digest following the source and the codecs found; a codec whose
    header is not found is left out of the build, its entries fail and a
    JPEG path raises the pure path's message, while the others still
    work."""
    _, pn = libs
    default = type(native.BUILD_ROOT)(native.__file__).resolve().parents[2] / "build" / "native_io"
    monkeypatch.setattr(native, "BUILD_ROOT", default)
    full = native.lib_path()
    assert full.parent.parent == default and full.name == "libbnlk_io.so"
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "nojpeg")
    monkeypatch.setattr(native, "found_codecs", lambda: ("png", "tiff"))
    monkeypatch.setattr(native, "_lib", None)
    assert native.lib_path().parent.name != full.parent.name
    assert not native.built()
    native.build()
    assert native.built() and native.BUILD_SECONDS > 0.0
    assert native.lib_path().exists() and native.codecs() == ("png", "tiff")
    assert "-DBNLK_HAVE_JPEG" not in native.compile_command("x.so")
    img = _image(3, 12, 14, 3)
    with pytest.raises(IOError):
        native.write_jpeg(str(tmp_path / "x.jpg"), img)
    with pytest.raises(ValueError, match="JPEG needs a native io library"):
        io.write_image(str(tmp_path / "x.jpg"), img, native=True)
    io.write_image(str(tmp_path / "x.png"), img, native=True)
    np.testing.assert_array_equal(io.read_image(str(tmp_path / "x.png"), native=True),
                                  np.clip(np.rint(img), 0, 255))
