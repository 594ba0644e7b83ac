"""The reference's side of the sequence cells (nlkalman-seq: two-pass
forward filter, backward RTS smoother, cold TV-L1 flows).

The filter and the smoother are recursions over the clip. The reference
follows the program step by step: a filter step t takes the noisy frame
t and the program's flt1 and flt2 of frame t-1, a smoother step t the
program's flt2 of frame t and smo1 of frame t+1, and computes the
step's flow, occlusion mask, warp and NL-Kalman passes anew. The start
(frame 0's two spatial passes) is computed from the noisy frame alone,
and the smoother's start (smo1 of the last frame is its flt2) is an
exact comparison.
"""

from __future__ import annotations

import math

import torch

from .flow import tvl1_flows
from .nlk import filter_frame, smooth_frame
from .ops import Consts, bicubic_warp, luma, occlusion_mask, opp2rgb, rgb2opp
from .params import default_params


def rms(a, b) -> float:
    """Root-mean-square difference of two frames, in grey levels."""
    d = a.double() - b.double()
    return float(torch.sqrt(torch.mean(d * d)))


def trimmed_rms(a, b, trim: float) -> float:
    """The rms difference of two frames with the largest ``trim`` share of
    the squared differences left out; NaN where any difference is not
    finite."""
    d2 = ((a.double() - b.double()) ** 2).reshape(-1)
    if not bool(torch.isfinite(d2).all()):
        return float("nan")
    k = min(d2.numel() - 1, int(math.ceil(trim * d2.numel())))
    top = torch.topk(d2, k).values.sum() if k else 0.0
    return float(torch.sqrt((d2.sum() - top) / (d2.numel() - k)))


def step_gaps(noisy, flt1, flt2, smo1, sigma: float, flow: dict, occ_threshold: float,
              filter_steps, smooth_steps, block_bytes: int = 1 << 30, trim: float = 0.0) -> dict:
    """The gap of each compared output frame between the program and the
    reference, {"flt1": [(t, trimmed rms, rms)], "flt2": [...], "smo1":
    [...], "smo1_last": max abs}. All (T, H, W, C) float32 on one device;
    ``flow`` the TV-L1 parameters, ``filter_steps`` frames in 1..T-1,
    ``smooth_steps`` frames in 0..T-2, ``trim`` the share of each frame's
    largest differences that the trimmed rms leaves out."""

    def gap(a, b):
        return trimmed_rms(a, b, trim), rms(a, b)

    dev = noisy.device
    c = noisy.shape[-1]
    p1, p2, ps = (default_params(sigma, m) for m in ("flt1", "flt2", "smo1"))
    consts = Consts(dev)
    out = {"flt1": [], "flt2": [], "smo1": []}

    def filt(t, prevs=None, flow_t=None):
        n_opp = rgb2opp(noisy[t])
        if prevs is None:
            wt = v1 = None
            priors = (None, None)
        else:
            occ = occlusion_mask(flow_t, occ_threshold)
            wt, v1 = bicubic_warp(torch.cat([rgb2opp(p) for p in prevs], dim=-1), flow_t, occ)
            priors = (wt[..., :c], wt[..., c:2 * c])
        f11 = filter_frame(n_opp, priors[0], v1, None, sigma, p1, block_bytes)
        f21 = filter_frame(n_opp, priors[1], v1, f11, sigma, p2, block_bytes)
        out["flt1"].append((t, *gap(flt1[t], opp2rgb(f11))))
        out["flt2"].append((t, *gap(flt2[t], opp2rgb(f21))))

    filt(0)
    pairs = [(luma(noisy[t]), luma(flt2[t - 1])) for t in filter_steps]
    pairs += [(luma(flt2[t]), luma(smo1[t + 1])) for t in smooth_steps]
    if pairs:
        flows = tvl1_flows(torch.stack([a for a, _ in pairs]),
                           torch.stack([b for _, b in pairs]), consts, **flow)
    for k, t in enumerate(filter_steps):
        filt(t, (flt1[t - 1], flt2[t - 1]), flows[k])
    for k, t in enumerate(smooth_steps):
        f = flows[len(filter_steps) + k]
        w0, v0 = bicubic_warp(rgb2opp(smo1[t + 1]), f, occlusion_mask(f, occ_threshold))
        smo = smooth_frame(rgb2opp(flt2[t]), w0, v0, sigma, ps, block_bytes)
        out["smo1"].append((t, *gap(smo1[t], opp2rgb(smo))))
    out["smo1_last"] = float((smo1[-1] - flt2[-1]).abs().max())
    return out
