"""The NL-Kalman filter and RTS smoother passes, plain (the K-similar-
patches build, src/nlkalman.c; one pass per call).

Per stride-psz/2 site: distances on the x-band (the basic estimate when
given, else the frame) over the (2 rad + 1)^2 window, the temporal radius
only for a filter site whose own previous patch is valid; k-th smallest
thresholds; two-pass variances clamped at 0; the Kalman (temporal) or
Wiener (spatial) update; aggregation of the first ``npatches_tagg``
members through DCT-domain gain and bias fields, one inverse DCT and the
Gaussian-window fold; pixels no patch covers copy the input.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import dct_all_patches, dct_basis_kron, gaussian_window, patch_validity
from .params import Params, pass_radius

_INF_BITS = int(np.float32(np.inf).view(np.int32))


def _kth_smallest_bits(bits, k):
    """k-th smallest of int32-viewed non-negative floats along axis 0; INF
    bits where k exceeds the count, -1 where k <= 0."""
    n = bits.shape[0]
    srt, _ = torch.sort(bits, dim=0)
    k = k.to(torch.long)
    th = srt.gather(0, (k.clamp(1, n) - 1)[None]).squeeze(0)
    th = torch.where(k > n, _INF_BITS, th)
    return torch.where(k <= 0, -1, th).to(torch.int32)


def dense_pass(cur, prev, prev_valid, basic, sigma: float, prms: Params, mode: str,
               has_prev: bool, has_basic: bool, block_bytes: int = 1 << 30):
    """One pass over (H, W, C) float32 frames; ``prev`` already zeroed
    where ``prev_valid`` is False. Sites are taken in blocks of site rows
    whose window tensors take about ``block_bytes`` in all."""
    h, w, ch = cur.shape
    dev = cur.device
    psz = prms.patch_sz
    step = psz // 2
    f = ch * psz * psz
    sigma2 = sigma * sigma
    hh, ww = h - psz + 1, w - psz + 1
    rad = pass_radius(prms, mode)
    n_off1 = 2 * rad + 1
    centre = rad * n_off1 + rad
    nagg = prms.npatches_tagg
    nx = (ww - 1) // step + 1
    ny = (hh - 1) // step + 1
    rows_per_block = max(1, min(ny, block_bytes // (16 * n_off1 * n_off1 * nx * f * 4)))

    xd = dct_all_patches(basic if has_basic else cur, psz).reshape(hh * ww, f)
    nd = dct_all_patches(cur, psz).reshape(hh * ww, f) if has_basic else xd
    if has_prev:
        dd = dct_all_patches(prev, psz).reshape(hh * ww, f)
        pval = patch_validity(prev_valid, psz).reshape(-1)
    else:
        dd = pval = None

    oy, ox = np.meshgrid(np.arange(-rad, rad + 1), np.arange(-rad, rad + 1), indexing="ij")
    oy_t = torch.as_tensor(oy.reshape(-1), device=dev)
    ox_t = torch.as_tensor(ox.reshape(-1), device=dev)
    rt = prms.search_sz_t
    in_rad_t = (oy_t.abs() <= rt) & (ox_t.abs() <= rt)
    n_acc = 3 if mode == "smooth" else 2
    g_acc = torch.zeros((hh * ww, n_acc * f), dtype=cur.dtype, device=dev)
    w_acc = torch.zeros((hh * ww,), dtype=cur.dtype, device=dev)
    px = step * torch.arange(nx, device=dev)
    sub = 0.0 if has_basic else sigma2
    nagg_f = float(nagg)

    for r0 in range(0, ny, rows_per_block):
        py = step * torch.arange(r0, min(r0 + rows_per_block, ny), device=dev)
        qy = py[None, :, None] + oy_t[:, None, None]
        qx = px[None, None, :] + ox_t[:, None, None]
        cand = (qy >= 0) & (qy < hh) & (qx >= 0) & (qx < ww)
        qidx = qy.clamp(0, hh - 1) * ww + qx.clamp(0, ww - 1)
        wx = xd[qidx]
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
        s_shape = bits.shape[1:]
        flat = bits.reshape(bits.shape[0], -1)
        pbits = torch.where(prevc, bits, _INF_BITS)
        k1 = torch.where(prev_p, prms.npatches_t, prms.npatches_x).reshape(-1)
        kn = torch.full_like(k1, nagg)
        th1 = _kth_smallest_bits(flat, k1).reshape(s_shape)
        thp = _kth_smallest_bits(pbits.reshape(bits.shape[0], -1), kn).reshape(s_shape)
        tha = _kth_smallest_bits(flat, kn).reshape(s_shape)
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
            m0 = torch.einsum("ors,orsf->rsf", m0sel.to(cur.dtype), wd) / torch.clamp(
                np0s, max=nagg_f)
        else:
            v0 = v01 = m0 = torch.zeros_like(v1)

        temporal = (np0 > 0.0)[..., None]
        if mode == "filter":
            bt, bx = prms.beta_t, prms.beta_x
            v_t = v0 + torch.clamp(v01 - sub, min=0.0)
            a_t = v_t / (v_t + bt * sigma2)
            vp_t = torch.sum((1.0 - a_t * a_t) * v_t + a_t * a_t * sigma2, dim=-1)
            v_x = torch.clamp(v1 - sub, min=0.0)
            a_x = v_x / (v_x + bx * sigma2)
            vp_x = torch.sum(a_x * v_x, dim=-1)
            a = torch.where(temporal, a_t, a_x)
            m_ref = torch.where(temporal, m0, m1_mean)
            mem = torch.where(temporal[None, ..., 0], m0sel, memsp)
            nagg_eff = torch.clamp(torch.where(np0 > 0, np0, np1), max=nagg_f)
            vp = torch.where(temporal[..., 0], vp_t, vp_x) * nagg_eff
            wgt = 1.0 / torch.clamp(vp, min=1e-6)
            specs = torch.cat([a, (1.0 - a) * m_ref], dim=-1)
        else:
            b = prms.beta_t
            denom = v1 + b * v01
            a = torch.where(denom > 0.0, v1 / torch.clamp(denom, min=1e-30), 0.0)
            vp = torch.sum((1.0 - a * a) * v1
                           + a * a * torch.clamp(v0 - b * v01, min=0.0), dim=-1)
            vp = vp * torch.clamp(np0, max=nagg_f)
            wgt = 1.0 / torch.clamp(vp, min=1e-6)
            specs = torch.cat([1.0 - a, torch.zeros_like(a), a], dim=-1)
            # passthrough where np0 == 0 (src/nlkalman.c:1795-1804): gain 1
            # on the frame at the centre offset, weight 1e6
            passthrough = np0 == 0.0
            one = torch.cat([torch.ones_like(a), torch.zeros_like(a),
                             torch.zeros_like(a)], dim=-1)
            specs = torch.where(passthrough[..., None], one, specs)
            wgt = torch.where(passthrough, 1e6, wgt)
            mem = m0sel.clone()
            mem[centre] |= passthrough

        memw = mem.to(cur.dtype) * wgt[None]
        q_m = qidx.expand_as(mem)[mem]
        w_m = memw[mem]
        g_acc.index_add_(0, q_m, w_m[:, None] * specs[None].expand(
            mem.shape + (n_acc * f,))[mem])
        w_acc.index_add_(0, q_m, w_m)

    fields = [g_acc[:, i * f:(i + 1) * f].reshape(hh, ww, f) for i in range(n_acc)]
    fd = fields[0] * nd.reshape(hh, ww, f) + fields[1]
    if mode == "smooth" and dd is not None:
        fd = fd + fields[2] * dd.reshape(hh, ww, f)
    bk = torch.as_tensor(dct_basis_kron(psz), device=dev)
    pix = torch.einsum("rscK,Kp->rscp", fd.reshape(hh, ww, ch, psz * psz), bk)
    wnp = gaussian_window(psz)
    out = torch.zeros((h, w, ch), dtype=cur.dtype, device=dev)
    agg = torch.zeros((h, w), dtype=cur.dtype, device=dev)
    w_field = w_acc.reshape(hh, ww)
    for dy in range(psz):
        for dx in range(psz):
            wv = float(wnp[dy, dx])
            out[dy: dy + hh, dx: dx + ww] += wv * pix[..., dy * psz + dx]
            agg[dy: dy + hh, dx: dx + ww] += wv * w_field
    covered = agg > 1e-6
    return torch.where(covered[..., None], out / torch.clamp(agg, min=1e-6)[..., None], cur)


def _prepare(frame, other, prev_valid):
    h, w, _ = frame.shape
    has_prev = other is not None
    if prev_valid is None:
        prev_valid = torch.full((h, w), has_prev, dtype=torch.bool, device=frame.device)
    other = torch.zeros_like(frame) if other is None else torch.where(
        prev_valid[..., None], other, 0.0)
    return other, prev_valid


def filter_frame(nisy, deno0, prev_valid, basic, sigma, prms: Params, block_bytes=1 << 30):
    """One filtering pass (OPP): ``deno0`` the warped previous output or
    None, ``basic`` the first pass's output for the second pass or None."""
    has_prev, has_basic = deno0 is not None, basic is not None
    deno0, prev_valid = _prepare(nisy, deno0, prev_valid)
    return dense_pass(nisy, deno0, prev_valid, basic if has_basic else nisy, float(sigma),
                      prms, "filter", has_prev, has_basic, block_bytes)


def smooth_frame(filt1, smoo0, prev_valid, sigma, prms: Params, block_bytes=1 << 30):
    """One RTS smoothing pass (OPP) against the warped smoothed frame t+1."""
    has_prev = smoo0 is not None
    smoo0, prev_valid = _prepare(filt1, smoo0, prev_valid)
    return dense_pass(filt1, smoo0, prev_valid, filt1, float(sigma), prms, "smooth",
                      has_prev, False, block_bytes)
