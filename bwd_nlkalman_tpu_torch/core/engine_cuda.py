"""Wrapper of K1, the hand-written CUDA NL-Kalman pass (csrc/nlk_pass.cu).

Replaces the Pallas kernel ``bwd_nlkalman_tpu/core/engine_pallas.py:128``
(``_fused_pass_kernel``, driven by ``dense_pass_pallas``). Its plain
PyTorch version is :func:`bwd_nlkalman_tpu_torch.core.engine.dense_pass_v2`.
One call launches the kernel's four stages (patch DCT of each band, the
per-site pass, aggregation with the inverse DCT, fold and normalise) and
counts as one launch of K1.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._build import call, stream_ptr
from .._dispatch import LaunchCounter, check_tensor
from ..ops.bases import basis
from ..ops.dct import _ortho_basis_kron_np, _ortho_basis_np
from ..ops.windows import window_np
from ..params import NLKParams

LAUNCHES = LaunchCounter()
_MAX_OFF = 1024


def _f32(x: float) -> float:
    return float(np.float32(x))


def dense_pass_cuda(cur, prev, prev_valid, basic, sigma: float,
                    prms: NLKParams, mode: str, has_prev: bool,
                    has_basic: bool, bases=None) -> torch.Tensor:
    """Kernel version of ``dense_pass_v2`` (same arguments and result)."""
    h, w, ch = cur.shape
    dev = cur.device
    psz = prms.patch_sz
    if dev.type != "cuda":
        raise ValueError("dense_pass_cuda takes CUDA tensors")
    if psz != 8 or not 1 <= ch <= 3:
        raise ValueError(f"K1 supports patch_sz 8 and 1..3 channels, got "
                         f"{psz} and {ch}")
    if prms.dista_lambda != 1.0 or prms.dista_th > 0.0:
        raise NotImplementedError("K1 runs the K-similar-patches selection only")
    rad = max(prms.search_sz_x, prms.search_sz_t) if mode == "filter" \
        else prms.search_sz_t
    n_off = (2 * rad + 1) ** 2
    if n_off > _MAX_OFF:
        raise ValueError(f"K1 supports search radius <= 15, got {rad}")
    check_tensor(cur, "cur", (h, w, ch), torch.float32, dev)
    check_tensor(basic, "basic", (h, w, ch), torch.float32, dev)
    if has_prev:
        check_tensor(prev, "prev", (h, w, ch), torch.float32, dev)
        check_tensor(prev_valid, "prev_valid", (h, w), torch.bool, dev)

    smooth = mode == "smooth"
    f = ch * psz * psz
    hh, ww = h - psz + 1, w - psz + 1
    n_sites = ((hh - 1) // 4 + 1) * ((ww - 1) // 4 + 1)
    n_acc = 3 if smooth else 2
    stream = ctypes.c_void_p(stream_ptr(dev))
    dct8 = basis(bases, ("dct", psz), _ortho_basis_np, dev)
    bk = basis(bases, ("dctkron", psz), _ortho_basis_kron_np, dev)
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
    spec = torch.empty((n_sites, n_acc, f), dtype=torch.float32, device=dev)
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
         _f32(prms.beta_t), 0.0 if has_basic else _f32(sigma2), stream)

    pixw = torch.empty((hh, ww, f), dtype=torch.float32, device=dev)
    wq = torch.empty((hh, ww), dtype=torch.float32, device=dev)
    d_for_gain = dband if (smooth and has_prev) else None
    call("bnlk_nlk_aggregate", spec.data_ptr(), wgt.data_ptr(), mask.data_ptr(),
         nband.data_ptr(),
         None if d_for_gain is None else d_for_gain.data_ptr(),
         bk.data_ptr(), win.data_ptr(), pixw.data_ptr(), wq.data_ptr(),
         hh, ww, ch, int(smooth), rad, stream)

    out = torch.empty((h, w, ch), dtype=torch.float32, device=dev)
    call("bnlk_nlk_fold", pixw.data_ptr(), wq.data_ptr(), win.data_ptr(),
         cur.data_ptr(), out.data_ptr(), h, w, ch, stream)
    LAUNCHES.add()
    return out
