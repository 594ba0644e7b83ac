"""The NL-Kalman pass: dispatch and plain PyTorch version (K1's plain form).

Port of ``bwd_nlkalman_tpu.core.engine`` (``dense_pass_v2`` :101,
``_kth_smallest_bits`` :42, ``finalize_fields`` :468). On CUDA tensors
:func:`dense_pass` launches the hand-written kernel K1
(``engine_cuda.py``); on CPU tensors it runs :func:`dense_pass_v2` below,
which processes the site grid in blocks of site rows so that its window
tensors stay small.

Semantics per stride-psz/2 site (core/nlkalman.py module docstring):
distances on the x-band (``basic`` when given, else ``cur``) over the
(2*rad+1)^2 window, the temporal radius only for a filter site whose own
previous patch is valid; k-th-smallest thresholds on the float bits;
two-pass variances clamped at 0; Kalman (temporal) or Wiener (spatial)
update; aggregation of the first ``nagg`` members through DCT-domain
gain/bias fields; one inverse DCT and Gaussian-window fold; pixels no
patch covers copy the input.
"""

from __future__ import annotations

import numpy as np
import torch

from .._dispatch import use_kernel
from ..ops.bases import basis
from ..ops.dct import _ortho_basis_kron_np, _ortho_basis_np, dct_image_all_patches
from ..ops.windows import window_np
from ..params import NLKParams
from .engine_cuda import dense_pass_cuda

_INF_BITS = int(np.float32(np.inf).view(np.int32))
_ROWS_PER_BLOCK = 4   # site rows per block: bounds the window tensors


def patch_validity(valid_pix: torch.Tensor, psz: int) -> torch.Tensor:
    """(H, W) bool -> (H-psz+1, W-psz+1) bool: all psz x psz pixels valid
    (the C NaN scan of the patch, src/nlkalman.c:605-609)."""
    v = valid_pix.to(torch.float32)
    h, w = v.shape
    hh, ww = h - psz + 1, w - psz + 1
    rows = torch.stack([v[i: i + hh] for i in range(psz)], 0).amin(0)
    cols = torch.stack([rows[:, j: j + ww] for j in range(psz)], 0).amin(0)
    return cols > 0.5


def _kth_smallest_bits(bits: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact k-th smallest of int32-viewed non-negative floats along axis 0.

    bits: (O, S) int32 (masked entries = INF bits); k: (S,) integer.
    Equals the JAX package's 31-step bisection result: the smallest t with
    count(bits <= t) >= k, INF bits when k exceeds O, and -1 where k <= 0.
    """
    n = bits.shape[0]
    srt, _ = torch.sort(bits, dim=0)
    k = k.to(torch.long)
    th = srt.gather(0, (k.clamp(1, n) - 1)[None]).squeeze(0)
    th = torch.where(k > n, _INF_BITS, th)
    return torch.where(k <= 0, -1, th).to(torch.int32)


def nlk_bases(psz: int) -> dict:
    """Every numpy-built constant a pass with patch size ``psz`` uses: key -> build function."""
    return {("dct", psz): _ortho_basis_np, ("dctkron", psz): _ortho_basis_kron_np,
            ("window", psz): window_np}


def check_supported(prms: NLKParams) -> None:
    if prms.dista_lambda != 1.0 or prms.dista_th > 0.0:
        raise NotImplementedError(
            "dista_lambda != 1 / dista_th > 0 are v2-only NLK variants, "
            "not ported yet")


def dense_pass_v2(cur, prev, prev_valid, basic, sigma: float, prms: NLKParams,
                  mode: str, has_prev: bool, has_basic: bool,
                  bases=None) -> torch.Tensor:
    """Plain version of K1: one filter or smoother pass over (H, W, C) frames."""
    check_supported(prms)
    h, w, ch = cur.shape
    dev = cur.device
    psz = prms.patch_sz
    step = psz // 2
    f = ch * psz * psz
    sigma2 = sigma * sigma
    hh, ww = h - psz + 1, w - psz + 1
    if mode == "filter":
        rad = max(prms.search_sz_x, prms.search_sz_t)
    else:
        rad = prms.search_sz_t
    rad_t = prms.search_sz_t
    n_off1 = 2 * rad + 1
    centre = rad * n_off1 + rad
    np_t, np_x, nagg = prms.npatches_t, prms.npatches_x, prms.npatches_tagg
    beta_x, beta_t = prms.beta_x, prms.beta_t
    ny = (hh - 1) // step + 1
    nx = (ww - 1) // step + 1

    x_img = basic if has_basic else cur
    xd = dct_image_all_patches(x_img, psz).reshape(hh * ww, f)
    nd = dct_image_all_patches(cur, psz).reshape(hh * ww, f) if has_basic else xd
    if has_prev:
        dd = dct_image_all_patches(prev, psz).reshape(hh * ww, f)
        pval = patch_validity(prev_valid, psz).reshape(-1)
    else:
        dd = pval = None

    oy, ox = np.meshgrid(np.arange(-rad, rad + 1), np.arange(-rad, rad + 1),
                         indexing="ij")
    oy_t = torch.as_tensor(oy.reshape(-1), device=dev)
    ox_t = torch.as_tensor(ox.reshape(-1), device=dev)
    in_rad_t = (oy_t.abs() <= rad_t) & (ox_t.abs() <= rad_t)

    n_acc = 3 if mode == "smooth" else 2
    g_acc = torch.zeros((hh * ww, n_acc * f), dtype=cur.dtype, device=dev)
    w_acc = torch.zeros((hh * ww,), dtype=cur.dtype, device=dev)
    px = step * torch.arange(nx, device=dev)
    sub = 0.0 if has_basic else sigma2

    for r0 in range(0, ny, _ROWS_PER_BLOCK):
        py = step * torch.arange(r0, min(r0 + _ROWS_PER_BLOCK, ny), device=dev)
        qy = py[None, :, None] + oy_t[:, None, None]          # (O, R, 1)
        qx = px[None, None, :] + ox_t[:, None, None]          # (O, 1, nx)
        cand = (qy >= 0) & (qy < hh) & (qx >= 0) & (qx < ww)  # (O, R, nx)
        qidx = qy.clamp(0, hh - 1) * ww + qx.clamp(0, ww - 1)
        wx = xd[qidx]                                         # (O, R, nx, F)
        xp = wx[centre]
        wc = wx - xp[None]
        dist = torch.sum(wc * wc, dim=-1) * (1.0 / f)
        if has_prev:
            wd = dd[qidx]
            wv = pval[qidx] & cand
            prev_p = wv[centre]
            if mode == "filter":
                cand = cand & torch.where(prev_p[None], in_rad_t[:, None, None], True)
            prevc = wv & cand & prev_p[None]
        else:
            prev_p = torch.zeros_like(cand[0])
            prevc = torch.zeros_like(cand)

        bits = torch.where(cand, dist.view(torch.int32), _INF_BITS)
        pbits = torch.where(prevc, bits, _INF_BITS)
        s_shape = bits.shape[1:]
        k1 = torch.where(prev_p, np_t, np_x).reshape(-1)
        kn = torch.full_like(k1, nagg)
        th1 = _kth_smallest_bits(bits.reshape(bits.shape[0], -1), k1).reshape(s_shape)
        thp = _kth_smallest_bits(pbits.reshape(bits.shape[0], -1), kn).reshape(s_shape)
        tha = _kth_smallest_bits(bits.reshape(bits.shape[0], -1), kn).reshape(s_shape)
        sel1 = cand & (bits <= th1[None])
        m0sel = prevc & (bits <= thp[None]) & sel1
        memsp = sel1 & (bits <= tha[None])

        np1 = sel1.sum(0).to(cur.dtype)
        np0 = (sel1 & prevc).sum(0).to(cur.dtype)
        np1s = torch.clamp(np1, min=1.0)[..., None]
        np0s = torch.clamp(np0, min=1.0)[..., None]
        s1f = sel1.to(cur.dtype)
        m1c = torch.einsum("ors,orsf->rsf", s1f, wc) / np1s
        e2 = torch.einsum("ors,orsf->rsf", s1f, wc * wc) / np1s
        v1 = torch.clamp(e2 - m1c * m1c, min=0.0)
        m1_mean = m1c + xp
        if has_prev:
            spf = (sel1 & prevc).to(cur.dtype)
            wdc = wd - xp[None]
            m0vc = torch.einsum("ors,orsf->rsf", spf, wdc) / np0s
            e0 = torch.einsum("ors,orsf->rsf", spf, wdc * wdc) / np0s
            v0 = torch.clamp(e0 - m0vc * m0vc, min=0.0)
            dxw = wd - wx
            v01 = torch.einsum("ors,orsf->rsf", spf, dxw * dxw) / np0s
            m0n = torch.clamp(np0s, max=float(nagg))
            m0 = torch.einsum("ors,orsf->rsf", m0sel.to(cur.dtype), wd) / m0n
        else:
            v0 = v01 = m0 = torch.zeros_like(v1)

        temporal = (np0 > 0.0)[..., None]
        if mode == "filter":
            v_t = v0 + torch.clamp(v01 - sub, min=0.0)
            a_t = v_t / (v_t + beta_t * sigma2)
            vp_t = torch.sum((1.0 - a_t * a_t) * v_t + a_t * a_t * sigma2, dim=-1)
            v_x = torch.clamp(v1 - sub, min=0.0)
            a_x = v_x / (v_x + beta_x * sigma2)
            vp_x = torch.sum(a_x * v_x, dim=-1)
            a = torch.where(temporal, a_t, a_x)
            m_ref = torch.where(temporal, m0, m1_mean)
            mem = torch.where(temporal[None, ..., 0], m0sel, memsp)
            nagg_eff = torch.clamp(torch.where(np0 > 0, np0, np1), max=float(nagg))
            vp = torch.where(temporal[..., 0], vp_t, vp_x) * nagg_eff
            wgt = 1.0 / torch.clamp(vp, min=1e-6)
            specs = torch.cat([a, (1.0 - a) * m_ref], dim=-1)
        else:
            b = beta_t
            denom = v1 + b * v01
            a = torch.where(denom > 0.0, v1 / torch.clamp(denom, min=1e-30), 0.0)
            vp = torch.sum((1.0 - a * a) * v1
                           + a * a * torch.clamp(v0 - b * v01, min=0.0), dim=-1)
            vp = vp * torch.clamp(np0, max=float(nagg))
            wgt = 1.0 / torch.clamp(vp, min=1e-6)
            mem = m0sel
            specs = torch.cat([1.0 - a, torch.zeros_like(a), a], dim=-1)
            # passthrough where np0 == 0 [src/nlkalman.c:1795-1804]: gain 1
            # on Nd at the centre offset with weight 1e6 (no members there)
            passthrough = np0 == 0.0
            one = torch.cat([torch.ones_like(a), torch.zeros_like(a),
                             torch.zeros_like(a)], dim=-1)
            specs = torch.where(passthrough[..., None], one, specs)
            wgt = torch.where(passthrough, 1e6, wgt)
            mem = mem.clone()
            mem[centre] |= passthrough

        memw = mem.to(cur.dtype) * wgt[None]
        q_m = qidx.expand_as(mem)[mem]
        w_m = memw[mem]
        g_acc.index_add_(0, q_m, w_m[:, None] * specs[None].expand(mem.shape + (n_acc * f,))[mem])
        w_acc.index_add_(0, q_m, w_m)

    fields = [g_acc[:, i * f:(i + 1) * f].reshape(hh, ww, f) for i in range(n_acc)]
    return finalize_fields(fields, w_acc.reshape(hh, ww), nd.reshape(hh, ww, f),
                           None if dd is None else dd.reshape(hh, ww, f),
                           mode, psz, cur, bases)


def finalize_fields(fields, w_field, nd, dd, mode, psz, cur, bases=None):
    """Aggregated DCT-domain gain/bias fields -> filtered frame: one
    inverse DCT, the Gaussian-window fold, then normalise-or-copy-input
    [src/nlkalman.c:940-942]."""
    h, w, ch = cur.shape
    hh, ww = h - psz + 1, w - psz + 1
    fd = fields[0] * nd + fields[1]
    if mode == "smooth" and dd is not None:
        fd = fd + fields[2] * dd
    bk = basis(bases, ("dctkron", psz), _ortho_basis_kron_np, cur.device)
    pix = torch.einsum("rscK,Kp->rscp", fd.reshape(hh, ww, ch, psz * psz), bk)
    wnp = window_np(psz)
    out = torch.zeros((h, w, ch), dtype=cur.dtype, device=cur.device)
    agg = torch.zeros((h, w), dtype=cur.dtype, device=cur.device)
    for dy in range(psz):
        for dx in range(psz):
            wv = float(wnp[dy, dx])
            out[dy: dy + hh, dx: dx + ww] += wv * pix[..., dy * psz + dx]
            agg[dy: dy + hh, dx: dx + ww] += wv * w_field
    covered = agg > 1e-6
    return torch.where(covered[..., None],
                       out / torch.clamp(agg, min=1e-6)[..., None], cur)


def dense_pass(cur, prev, prev_valid, basic, sigma: float, prms: NLKParams,
               mode: str, has_prev: bool, has_basic: bool,
               engine: str = "auto", bases=None) -> torch.Tensor:
    """One NLK pass: K1 on CUDA tensors, :func:`dense_pass_v2` on CPU tensors.

    ``engine="plain"`` runs the plain version on any device."""
    if use_kernel(cur, engine):
        return dense_pass_cuda(cur, prev, prev_valid, basic, sigma, prms, mode,
                               has_prev, has_basic, bases=bases)
    return dense_pass_v2(cur, prev, prev_valid, basic, sigma, prms, mode,
                         has_prev, has_basic, bases=bases)
