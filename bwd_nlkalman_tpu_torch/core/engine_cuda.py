"""Wrapper of K1, the hand-written CUDA NL-Kalman pass (csrc/nlk_pass.cu).

Replaces the Pallas kernel ``bwd_nlkalman_tpu/core/engine_pallas.py:128``
(``_fused_pass_kernel``, driven by ``dense_pass_pallas``). Its plain
PyTorch version is :func:`bwd_nlkalman_tpu_torch.core.engine.dense_pass_v2`.
One call launches the kernel's four stages (patch DCT of each band, the
per-site pass, aggregation with the inverse DCT, fold and normalise) and
counts as one launch of K1. :func:`site_plan` sizes the site stage's
launch (sites per block, dynamic shared memory); the kernel checks the
size it is given against its own layout.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._build import call, stream_ptr
from .._dispatch import LaunchCounter, check_tensor
from ..ops.bases import basis
from ..ops.dct import _ortho_basis_np
from ..ops.windows import window_np
from ..params import NLKParams

LAUNCHES = LaunchCounter()
MAX_RAD = 15                # search radius: at most 961 window offsets
SITES_PER_BLOCK = 8         # most neighbouring sites of one site row, a warp each
SMEM_PER_BLOCK = 232_448    # shared memory one block may use (227 KB)
_BINS = 256                 # radix-select digit bins


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def pass_radius(prms: NLKParams, mode: str) -> int:
    """The search radius of a pass: a filter pass searches the larger of
    its spatial and temporal radii, a smoother pass the temporal one."""
    if mode == "filter":
        return max(prms.search_sz_x, prms.search_sz_t)
    return prms.search_sz_t


def check_limits(psz: int, rad: int, c: int | None = None) -> None:
    """Raise ValueError for a patch size, search radius or channel count
    (None: not known yet) that K1 does not take, naming the limit."""
    hint = "; engine='plain' runs the plain pass on the card instead"
    if psz != 8:
        raise ValueError(f"K1 supports patch_sz 8, got {psz}{hint}")
    if not 0 <= rad <= MAX_RAD:
        raise ValueError(f"K1 supports search radius <= {MAX_RAD}, got {rad}{hint}")
    if c is not None and not 1 <= c <= 3:
        raise ValueError(f"K1 supports 1..3 channels, got {c}{hint}")


def check_params(passes, channels: int | None = None) -> None:
    """:func:`check_limits` for every ``(NLKParams, mode)`` of ``passes``:
    what an entry point that will run K1 checks before its first launch."""
    for prms, mode in passes:
        check_limits(prms.patch_sz, pass_radius(prms, mode), channels)


def site_plan(c: int, rad: int, psz: int = 8) -> tuple[int, int]:
    """(sites per block, dynamic shared bytes) of K1's site kernel for
    ``c`` channels at search radius ``rad``: the layout of
    ``csrc/nlk_pass.cu`` (strip_row_floats, site_region_bytes,
    site_warp_bytes). Region A holds two stage buffers of two window rows
    (stride F + 1 floats per position, row stride 16 mod 32 floats) or,
    after the distances, three 256-bin histograms per warp (then its
    member list); then each warp's own vector, candidate bits and flags.
    Takes the most sites per block, up to 8, whose block fits in 227 KB.
    Raises for what K1 does not take (:func:`check_limits`)."""
    check_limits(psz, rad, c)
    f = c * psz * psz
    n_off = (2 * rad + 1) ** 2
    warp = _align16(4 * f) + _align16(4 * n_off) + _align16(n_off)
    for s in range(SITES_PER_BLOCK, 0, -1):
        row = (4 * (s - 1) + 2 * rad + 1) * (f + 1)
        row += (16 - row % 32) % 32
        smem = _align16(max(4 * row * 4, s * 3 * _BINS * 4)) + s * warp
        if smem <= SMEM_PER_BLOCK:
            return s, smem
    raise ValueError(f"K1 site block of one site needs {smem} bytes of shared memory")


def _f32(x: float) -> float:
    return float(np.float32(x))


def dense_pass_cuda(cur, prev, prev_valid, basic, sigma: float,
                    prms: NLKParams, mode: str, has_prev: bool,
                    has_basic: bool, bases=None) -> torch.Tensor:
    """Kernel version of ``dense_pass_v2`` (same arguments and result)."""
    return pass_with_weights(cur, prev, prev_valid, basic, sigma, prms, mode,
                             has_prev, has_basic, bases)[0]


def pass_with_weights(cur, prev, prev_valid, basic, sigma: float,
                      prms: NLKParams, mode: str, has_prev: bool,
                      has_basic: bool, bases=None):
    """:func:`dense_pass_cuda` and the aggregated weight of each patch
    position, (H-7, W-7) float32: 0 where no site chose the position."""
    h, w, ch = cur.shape
    dev = cur.device
    psz = prms.patch_sz
    if dev.type != "cuda":
        raise ValueError("dense_pass_cuda takes CUDA tensors")
    if prms.dista_lambda != 1.0 or prms.dista_th > 0.0:
        raise NotImplementedError("K1 runs the K-similar-patches selection only")
    rad = pass_radius(prms, mode)
    sites, smem = site_plan(ch, rad, psz)
    n_off = (2 * rad + 1) ** 2
    check_tensor(cur, "cur", (h, w, ch), torch.float32, dev)
    check_tensor(basic, "basic", (h, w, ch), torch.float32, dev)
    if has_prev:
        check_tensor(prev, "prev", (h, w, ch), torch.float32, dev)
        check_tensor(prev_valid, "prev_valid", (h, w), torch.bool, dev)

    smooth = mode == "smooth"
    f = ch * psz * psz
    hh, ww = h - psz + 1, w - psz + 1
    n_sites = ((hh - 1) // 4 + 1) * ((ww - 1) // 4 + 1)
    stream = ctypes.c_void_p(stream_ptr(dev))
    dct8 = basis(bases, ("dct", psz), _ortho_basis_np, dev)
    win = basis(bases, ("window", psz), window_np, dev)

    def band(img, valid=None):
        out = torch.empty((hh, ww, f), dtype=torch.float32, device=dev)
        pv = None
        if valid is not None:
            pv = torch.empty((hh, ww), dtype=torch.uint8, device=dev)
            valid = valid.to(torch.uint8)
        call("bnlk_nlk_dct", img.data_ptr(),
             None if valid is None else valid.data_ptr(), dct8.data_ptr(),
             out.data_ptr(), None if pv is None else pv.data_ptr(),
             h, w, ch, stream)
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
         wgt.data_ptr(), mask.data_ptr(), hh, ww, ch, int(smooth),
         int(has_prev), rad, prms.search_sz_t, prms.npatches_t,
         prms.npatches_x, prms.npatches_tagg, _f32(sigma2),
         _f32(prms.beta_t * sigma2), _f32(prms.beta_x * sigma2),
         _f32(prms.beta_t), 0.0 if has_basic else _f32(sigma2), sites, smem,
         stream)

    pixw = torch.empty((hh, ww, f), dtype=torch.float32, device=dev)
    wq = torch.empty((hh, ww), dtype=torch.float32, device=dev)
    d_for_gain = dband if (smooth and has_prev) else None
    call("bnlk_nlk_aggregate", spec.data_ptr(), wgt.data_ptr(), mask.data_ptr(),
         nband.data_ptr(),
         None if d_for_gain is None else d_for_gain.data_ptr(),
         dct8.data_ptr(), win.data_ptr(), pixw.data_ptr(), wq.data_ptr(),
         hh, ww, ch, int(smooth), rad, stream)

    out = torch.empty((h, w, ch), dtype=torch.float32, device=dev)
    call("bnlk_nlk_fold", pixw.data_ptr(), wq.data_ptr(), win.data_ptr(),
         cur.data_ptr(), out.data_ptr(), h, w, ch, stream)
    LAUNCHES.add()
    return out, wq
