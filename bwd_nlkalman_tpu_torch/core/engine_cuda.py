"""Wrapper of K1, the hand-written CUDA NL-Kalman pass (csrc/nlk_pass.cu).

Replaces the Pallas kernel ``bwd_nlkalman_tpu/core/engine_pallas.py:128``
(``_fused_pass_kernel``, driven by ``dense_pass_pallas``) over what that
kernel takes: every even patch size from 2 to 16, 1 to 7 channels, a
search radius up to 15 and the DCT bands in float32 or, with
``window_dtype="bfloat16"``, in bfloat16 (distances, statistics and the
fold stay float32). Its plain PyTorch version is
:func:`bwd_nlkalman_tpu_torch.core.engine.dense_pass_v2` with the same
``window_dtype``. One call launches the kernel's four stages (patch DCT
of each band, the per-site pass, aggregation with the inverse DCT, fold
and normalise) and counts as one launch of K1.

The sharded form of the TPU kernel (``dense_pass_pallas``'s
``site_rows``, ``qy_bounds`` and ``return_accum``,
``engine_pallas.py:1330-1346``) is K1's too: the site stage launches over
a shard's own site rows only (:func:`site_range`), its candidates keep to
the global patch-row bounds, and the fold can return the sums and their
weights before the normalisation. The bounds are launch arguments.

:func:`site_plan` sizes the site stage's launch (sites per block, dynamic
shared memory) and :func:`plan_refusal` says why K1 does not take a
pass; the kernel checks the size it is given against its own layout.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._build import call, stream_ptr
from .._dispatch import LaunchCounter, check_tensor, check_window_dtype
from ..ops.bases import basis
from ..ops.dct import _ortho_basis_np
from ..ops.windows import window_np
from ..params import NLKParams

LAUNCHES = LaunchCounter()
PATCH_SIZES = tuple(range(2, 17, 2))  # the even patch sizes K1 is built for
MAX_CHANNELS = 7
MAX_RAD = 15                # search radius: at most 961 window offsets
SITES_PER_BLOCK = 8         # most neighbouring sites of one site row, a warp each
SMEM_PER_BLOCK = 232_448    # shared memory one block may use (227 KB)
_BINS = 256                 # radix-select digit bins
BAND_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def pass_radius(prms: NLKParams, mode: str) -> int:
    """The search radius of a pass: a filter pass searches the larger of
    its spatial and temporal radii, a smoother pass the temporal one."""
    if mode == "filter":
        return max(prms.search_sz_x, prms.search_sz_t)
    return prms.search_sz_t


def site_range(h: int, psz: int, site_rows=None, qy_bounds=None):
    """(r0, r1, qlo, qhi): the site rows ``[r0, r1)`` a pass over ``h``
    rows computes and the patch rows ``[qlo, qhi)`` its candidates may lie
    on, with the JAX package's meaning (``core/engine.py:124-128, 246-250``):
    a site of row r counts where ``start <= r < stop`` (``site_rows``; stop
    clipped to the grid) and its own row ``psz/2 * r`` lies in ``[lo, hi)``
    (``qy_bounds``, local patch rows); a candidate counts where its row lies
    there. The defaults are the whole grid and the whole frame; both
    ranges are clipped to the frame."""
    step = psz // 2
    hh = h - psz + 1
    ny = (hh - 1) // step + 1
    start, stop = (0, ny) if site_rows is None else (int(site_rows[0]), int(site_rows[1]))
    lo, hi = (0, hh) if qy_bounds is None else (int(qy_bounds[0]), int(qy_bounds[1]))
    r0 = max(start, -(-lo // step), 0)
    r1 = max(r0, min(stop, ny, -(-hi // step)))
    return r0, r1, max(lo, 0), min(hi, hh)


def _site_smem(sites: int, c: int, rad: int, psz: int, band_bytes: int) -> int:
    """Dynamic shared bytes of a site block (csrc/nlk_pass.cuh: strip_row_words,
    site_region_bytes, site_warp_bytes)."""
    f = c * psz * psz
    n_off = (2 * rad + 1) ** 2
    pw = f * band_bytes // 4 + 1            # 32-bit words a staged position
    row = (psz // 2 * (sites - 1) + 2 * rad + 1) * pw
    row += (16 - row % 32) % 32
    warp = _align16(4 * f) + _align16(4 * n_off) + _align16(n_off)
    return _align16(max(4 * row * 4, sites * 3 * _BINS * 4)) + sites * warp


def plan_refusal(c: int, rad: int, psz: int = 8,
                 window_dtype: str = "float32") -> str | None:
    """Why K1 does not take a pass of ``c`` channels at patch size ``psz``
    and search radius ``rad``, or None where it does: the sizes it is
    built for, and a site block of at least one site within 227 KB."""
    check_window_dtype(window_dtype)
    if psz % 2 or not PATCH_SIZES[0] <= psz <= PATCH_SIZES[-1]:
        return (f"patch_sz {psz} is odd" if psz % 2 else
                f"patch_sz {psz} is outside K1's 2..16")
    if not 1 <= c <= MAX_CHANNELS:
        return f"{c} channels, K1 takes 1..{MAX_CHANNELS}"
    if not 0 <= rad <= MAX_RAD:
        return f"search radius {rad}, K1 takes 0..{MAX_RAD}"
    need = _site_smem(1, c, rad, psz, BAND_DTYPES[window_dtype].itemsize)
    if need > SMEM_PER_BLOCK:
        return (f"one site of {c} channels at patch_sz {psz}, radius {rad} "
                f"({window_dtype} bands) needs {need} bytes of shared memory, "
                f"more than {SMEM_PER_BLOCK}")
    return None


def site_plan(c: int, rad: int, psz: int = 8,
              window_dtype: str = "float32") -> tuple[int, int]:
    """(sites per block, dynamic shared bytes) of K1's site kernel for
    ``c`` channels at search radius ``rad`` and patch size ``psz``: the
    layout of ``csrc/nlk_pass.cuh``. Region A holds two stage buffers of
    two window rows (an odd count of 32-bit words a position, in the
    band's type, row stride 16 mod 32 words) or, after the distances,
    three 256-bin histograms per warp (then its member list); then each
    warp's own vector (float32), candidate bits and flags. Takes the most
    sites per block, up to 8, whose block fits in 227 KB. Raises
    ValueError for what K1 does not take (:func:`plan_refusal`)."""
    why = plan_refusal(c, rad, psz, window_dtype)
    if why is not None:
        raise ValueError(f"K1 does not take the pass: {why}")
    nbytes = BAND_DTYPES[window_dtype].itemsize
    for s in range(SITES_PER_BLOCK, 0, -1):
        smem = _site_smem(s, c, rad, psz, nbytes)
        if smem <= SMEM_PER_BLOCK:
            return s, smem
    raise AssertionError("unreachable: plan_refusal checked one site")


def _f32(x: float) -> float:
    return float(np.float32(x))


def dense_pass_cuda(cur, prev, prev_valid, basic, sigma: float,
                    prms: NLKParams, mode: str, has_prev: bool,
                    has_basic: bool, bases=None, window_dtype: str = "float32",
                    site_rows=None, qy_bounds=None, return_accum: bool = False):
    """Kernel version of ``dense_pass_v2`` (same arguments and result)."""
    return pass_with_weights(cur, prev, prev_valid, basic, sigma, prms, mode,
                             has_prev, has_basic, bases, window_dtype, site_rows,
                             qy_bounds, return_accum)[0]


def pass_with_weights(cur, prev, prev_valid, basic, sigma: float,
                      prms: NLKParams, mode: str, has_prev: bool,
                      has_basic: bool, bases=None, window_dtype: str = "float32",
                      site_rows=None, qy_bounds=None, return_accum: bool = False):
    """:func:`dense_pass_cuda` and the aggregated weight of each patch
    position, (H-psz+1, W-psz+1) float32: 0 where no site chose the
    position. With ``return_accum`` the first is ``(out_acc (H, W, C),
    agg (H, W))``, the sums before the normalisation."""
    h, w, ch = cur.shape
    dev = cur.device
    psz = prms.patch_sz
    if dev.type != "cuda":
        raise ValueError("dense_pass_cuda takes CUDA tensors")
    if prms.dista_lambda != 1.0 or prms.dista_th > 0.0:
        raise ValueError("K1 runs the K-similar-patches selection only "
                         "(dista_lambda 1, dista_th 0)")
    if h < psz or w < psz:
        raise ValueError(f"K1 needs a frame of at least one patch, got {h}x{w} "
                         f"at patch_sz {psz}")
    rad = pass_radius(prms, mode)
    sites, smem = site_plan(ch, rad, psz, window_dtype)
    bf16 = int(window_dtype == "bfloat16")
    band_dtype = BAND_DTYPES[window_dtype]
    n_off = (2 * rad + 1) ** 2
    check_tensor(cur, "cur", (h, w, ch), torch.float32, dev)
    check_tensor(basic, "basic", (h, w, ch), torch.float32, dev)
    if has_prev:
        check_tensor(prev, "prev", (h, w, ch), torch.float32, dev)
        check_tensor(prev_valid, "prev_valid", (h, w), torch.bool, dev)

    smooth = mode == "smooth"
    f = ch * psz * psz
    step = psz // 2
    hh, ww = h - psz + 1, w - psz + 1
    r0, r1, qlo, qhi = site_range(h, psz, site_rows, qy_bounds)
    n_sites = (r1 - r0) * ((ww - 1) // step + 1)
    stream = ctypes.c_void_p(stream_ptr(dev))
    dmat = basis(bases, ("dct", psz), _ortho_basis_np, dev)
    win = basis(bases, ("window", psz), window_np, dev)

    def band(img, valid=None):
        out = torch.empty((hh, ww, f), dtype=band_dtype, device=dev)
        pv = None
        if valid is not None:
            pv = torch.empty((hh, ww), dtype=torch.uint8, device=dev)
            valid = valid.to(torch.uint8)
        call("bnlk_nlk_dct", img.data_ptr(),
             None if valid is None else valid.data_ptr(), dmat.data_ptr(),
             out.data_ptr(), None if pv is None else pv.data_ptr(),
             h, w, ch, psz, bf16, stream)
        return out, pv

    xband, _ = band(basic if has_basic else cur)
    nband = band(cur)[0] if has_basic else xband
    dband, pval = band(prev, prev_valid) if has_prev else (None, None)

    sigma2 = sigma * sigma
    spec = torch.empty((n_sites, 2, f), dtype=torch.float32, device=dev)
    wgt = torch.empty((n_sites,), dtype=torch.float32, device=dev)
    mask = torch.empty((n_sites, (n_off + 31) // 32), dtype=torch.int32,
                       device=dev)
    call("bnlk_nlk_sites", xband.data_ptr(),
         None if dband is None else dband.data_ptr(),
         None if pval is None else pval.data_ptr(), spec.data_ptr(),
         wgt.data_ptr(), mask.data_ptr(), hh, ww, ch, psz, bf16, int(smooth),
         int(has_prev), rad, prms.search_sz_t, prms.npatches_t,
         prms.npatches_x, prms.npatches_tagg, _f32(sigma2),
         _f32(prms.beta_t * sigma2), _f32(prms.beta_x * sigma2),
         _f32(prms.beta_t), 0.0 if has_basic else _f32(sigma2), sites, smem,
         r0, r1, qlo, qhi, stream)

    pixw = torch.empty((hh, ww, f), dtype=torch.float32, device=dev)
    wq = torch.empty((hh, ww), dtype=torch.float32, device=dev)
    d_for_gain = dband if (smooth and has_prev) else None
    call("bnlk_nlk_aggregate", spec.data_ptr(), wgt.data_ptr(), mask.data_ptr(),
         nband.data_ptr(),
         None if d_for_gain is None else d_for_gain.data_ptr(),
         dmat.data_ptr(), win.data_ptr(), pixw.data_ptr(), wq.data_ptr(),
         hh, ww, ch, psz, bf16, int(smooth), rad, r0, r1, stream)

    out = torch.empty((h, w, ch), dtype=torch.float32, device=dev)
    agg = torch.empty((h, w), dtype=torch.float32, device=dev) if return_accum else None
    call("bnlk_nlk_fold", pixw.data_ptr(), wq.data_ptr(), win.data_ptr(),
         cur.data_ptr(), out.data_ptr(), None if agg is None else agg.data_ptr(),
         h, w, ch, psz, stream)
    LAUNCHES.add()
    return ((out, agg) if return_accum else out), wq
