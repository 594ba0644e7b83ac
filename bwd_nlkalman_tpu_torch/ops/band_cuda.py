"""Wrapper of G, the banded separable product (csrc/band_sep.cu), and the
band forms it applies.

G replaces no TPU kernel: the JAX package applies the flow's blur and zoom
axis matrices as dense products. Its plain version is the dense product
itself, :func:`bwd_nlkalman_tpu_torch.ops.gaussian.apply_sep`, which
:func:`bwd_nlkalman_tpu_torch.ops.gaussian.sep_product` takes on the CPU
and with ``engine="plain"``.

The band form of an (n_out, n_in) axis matrix M is built once, in numpy,
from M itself (never from the taps again: the reflecting borders merge
entries in float64, and the band carries the merged values). It is an
int32 (n_out, 1 + T) array, T the widest row of M (its first to its last
nonzero): row i holds lo[i], the first input index of its taps, then the
float32 bits of M[i, lo[i]], ..., M[i, lo[i] + T - 1]. A row narrower
than T has zero taps at in-range indices (lo is moved down at the far
border), so the form scattered back is M exactly. G sums each output's
taps by fma in ascending index from zero (csrc/band_sep.cu): the dense
product's sum, in an order of its own, so within fp32 rounding of the
dense cuBLAS products and not always their bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Mapping

import numpy as np
import torch

from .._build import call, stream_ptr
from .._dispatch import LaunchCounter, check_tensor

# output tiles (rows, columns) a block may take, the first whose shared
# memory fits SMEM_TARGET, else the first that fits SMEM_BYTES: the taller
# the tile, the fewer staged rows a row of output costs; the widest bands
# take the smallest. The columns divide the block's 256 threads.
TILES = ((32, 128), (16, 128), (16, 64), (8, 128), (4, 128), (2, 128), (1, 128), (1, 64),
         (1, 32))
SMEM_TARGET = 65_536   # four blocks of 256 threads on an H100 SM
SMEM_BYTES = 232_448   # what one block of an H100 may use
K_ROWS = 4             # the staged rows are padded to a multiple of this (csrc/band_sep.cu)
PLANE_ALIGN = 32       # floats: each output plane starts on a 128-byte line

# the kinds of axis matrix that ``gaussian.sep_product`` applies: the blur,
# the zoom-out and the resample of ``ops/zoom.py``
BANDED = ("blur", "zoomout", "resample")

LAUNCHES = LaunchCounter()


def band_form_np(m: np.ndarray) -> np.ndarray:
    """The band form of the 2-D float32 matrix ``m`` (module docstring)."""
    n_in = m.shape[1]
    nz = m != 0
    any_nz = nz.any(axis=1)
    first = np.where(any_nz, nz.argmax(axis=1), 0)
    last = np.where(any_nz, n_in - 1 - nz[:, ::-1].argmax(axis=1), 0)
    taps = int((last - first).max()) + 1
    lo = np.minimum(first, n_in - taps)
    w = np.take_along_axis(m, lo[:, None] + np.arange(taps), axis=1)
    return np.concatenate([lo[:, None].astype(np.int32),
                           np.ascontiguousarray(w, np.float32).view(np.int32)], axis=1)


def band_parts(form: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(lo (n_out,), weights (n_out, T) float32) of a band form."""
    return form[:, 0], form[:, 1:].view(np.float32)


def band_key(key: tuple) -> tuple:
    """The ``bases`` key of the band form of the matrix of ``key``."""
    return ("band", *key)


@functools.lru_cache(maxsize=None)
def band_of(build: Callable[..., np.ndarray], kind: str, *args) -> np.ndarray:
    """The band form of ``build(*args)``, the matrix of key (kind, *args)."""
    return band_form_np(build(*args))


def band_build(build: Callable[..., np.ndarray]) -> Callable[..., np.ndarray]:
    """The build of :func:`band_key` keys whose matrices ``build`` makes."""
    return functools.partial(band_of, build)


def band_builds(builds: Mapping[tuple, Callable[..., np.ndarray]]) -> dict:
    """The band form of every axis matrix (a key of a kind in ``BANDED``) of
    a ``key -> build`` mapping, as one; ``ops.bases.make_bases`` adds them
    to every ``bases`` mapping it builds."""
    return {band_key(k): band_build(b) for k, b in builds.items() if k[0] in BANDED}


def _span(lo: np.ndarray, taps: int, tile: int) -> int:
    """The most input indices the outputs of one tile of ``tile`` cover."""
    g = np.pad(lo, (0, -len(lo) % tile), mode="edge").reshape(-1, tile)
    return int((g.max(axis=1) - g.min(axis=1)).max()) + taps


@functools.lru_cache(maxsize=None)
def band_plan(build: Callable[..., np.ndarray], key_y: tuple,
              key_x: tuple) -> tuple[int, int, int, int]:
    """(tile_y, tile_x, rows, pitch) of G on the matrices of ``key_y`` and
    ``key_x``: the first of ``TILES`` whose staged input (``rows`` by a
    ``pitch`` of 4k floats, room for 16-byte loads from a line start),
    intermediate and bands fit ``SMEM_TARGET`` bytes of shared memory, else
    the first that fits one block's."""
    lo_y, w_y = band_parts(band_of(build, *key_y))
    lo_x, w_x = band_parts(band_of(build, *key_x))
    ty, tx = w_y.shape[1], w_x.shape[1]
    plans = []
    for tile_y, tile_x in TILES:
        rows = _span(lo_y, ty, tile_y)
        pitch = (_span(lo_x, tx, tile_x) + 3 + 3) // 4 * 4
        plans.append((smem_bytes(tile_y, tile_x, rows, pitch, ty, tx),
                      (tile_y, tile_x, rows, pitch)))
    for budget in (SMEM_TARGET, SMEM_BYTES):
        for nbytes, plan in plans:
            if nbytes <= budget:
                return plan
    raise ValueError(f"bands of {ty} and {tx} taps are too wide for one block's "
                     "shared memory")


def smem_bytes(tile_y: int, tile_x: int, rows: int, pitch: int, ty: int, tx: int) -> int:
    """The shared memory of one block of G (``smem_words`` in
    csrc/band_sep.cu): the staged input, its rows padded to ``K_ROWS``, the
    intermediate and the tile's bands."""
    staged = -(-rows // K_ROWS) * K_ROWS
    return 4 * (staged * pitch + rows * tile_x + (tx + 1) * tile_x + (ty + 1) * tile_y)


def _planes(x: torch.Tensor, planes_last: bool):
    """(P, H, W) and the (plane, row, column) strides of x: (H, W), (P, H,
    W) or, with ``planes_last``, (H, W, P)."""
    if x.ndim == 2:
        return (1, *x.shape), (0, *x.stride())
    if x.ndim != 3:
        raise ValueError(f"expected (H, W) or a stack of planes, got {tuple(x.shape)}")
    if planes_last:
        return (x.shape[2], x.shape[0], x.shape[1]), (x.stride(2), x.stride(0), x.stride(1))
    return tuple(x.shape), tuple(x.stride())


def band_sep_cuda(x: torch.Tensor, band_y: torch.Tensor, band_x: torch.Tensor,
                  plan: tuple[int, int, int, int], planes_last: bool = False,
                  scale: float = 1.0) -> torch.Tensor:
    """Kernel version of ``apply_sep`` on every plane of ``x`` in one
    launch, times ``scale``: x is (H, W), (P, H, W) or, with
    ``planes_last``, (H, W, P), in any strides; ``band_y`` and ``band_x``
    the band forms (int32, (Ho, 1 + Ty) and (Wo, 1 + Tx)) of the axis
    matrices, ``plan`` their :func:`band_plan`. Returns (Ho, Wo), (P, Ho,
    Wo) with each plane on a 128-byte line, or (Ho, Wo, P) contiguous."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError("band_sep_cuda takes CUDA tensors")
    if x.dtype != torch.float32:
        raise ValueError(f"x: expected float32, got {x.dtype}")
    (p, h, w), (isp, isy, isx) = _planes(x, planes_last)
    ho, wo = band_y.shape[0], band_x.shape[0]
    check_tensor(band_y, "band_y", (ho, band_y.shape[1]), torch.int32, dev)
    check_tensor(band_x, "band_x", (wo, band_x.shape[1]), torch.int32, dev)
    ty, tx = band_y.shape[1] - 1, band_x.shape[1] - 1
    if h < 1 or w < 1 or ty < 1 or tx < 1 or ty > h or tx > w:
        raise ValueError(f"bands of {ty} and {tx} taps do not fit a {h}x{w} plane")
    if max(x.numel(), p * ho * wo) >= 2 ** 31 - 2 ** 24:
        raise ValueError("band_sep_cuda takes fewer than 2**31 elements")
    if x.ndim == 2:
        out = torch.empty((ho, wo), dtype=torch.float32, device=dev)
        osp, osy, osx = 0, wo, 1
    elif planes_last:
        out = torch.empty((ho, wo, p), dtype=torch.float32, device=dev)
        osp, osy, osx = 1, wo * p, p
    else:
        osp = -(-ho * wo // PLANE_ALIGN) * PLANE_ALIGN
        out = torch.empty(p * osp, dtype=torch.float32, device=dev).as_strided(
            (p, ho, wo), (osp, wo, 1))
        osy, osx = wo, 1
    vec = (isx == 1 and isy % 4 == 0 and isp % 4 == 0 and w % 4 == 0
           and x.data_ptr() % 16 == 0)
    tile_y, tile_x, rows, pitch = plan
    call("bnlk_band_sep", x.data_ptr(), out.data_ptr(), band_y.data_ptr(),
         band_x.data_ptr(), p, h, w, ho, wo, ty, tx, isp, isy, isx, osp, osy, osx,
         tile_y, tile_x, rows, pitch, float(scale), int(vec),
         ctypes.c_void_p(stream_ptr(dev)))
    LAUNCHES.add()
    return out
