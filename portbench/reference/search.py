"""The reference's side of the search cells: the training fixtures
(nlkalman-train.sh:17-28; tvl1flow-seq.sh: noisy frames, backward TV-L1
flow between consecutive noisy frames, divergence occlusion masks) and
one trial's forward filtering on them, scored as the training protocol
scores it (mean per-frame MSE from a burn-in frame, a border cropped)."""

from __future__ import annotations

import numpy as np
import torch

from .flow import tvl1_flows
from .nlk import filter_frame
from .noise import awgn
from .ops import Consts, bicubic_warp, luma, occlusion_mask, opp2rgb, rgb2opp


def noisy_clip(clean: np.ndarray, sigma: float, seeds) -> np.ndarray:
    """Per-frame AWGN with explicit seeds (SRAND per frame)."""
    return np.stack([awgn(f, sigma, int(s)) for f, s in zip(clean, seeds)])


def backward_fixtures(noisy, flow: dict, occ_threshold: float, duals="float32"):
    """(bflow, bocc) of every clip: flow t -> t-1 of the noisy frames and
    its mask (255 = occluded), frame 0 a copy of frame 1's. ``noisy`` is a
    list of (T, H, W, C) float32 tensors on one device; all flows are
    solved as one batch."""
    dev = noisy[0].device
    i0 = torch.stack([luma(x[t]) for x in noisy for t in range(1, x.shape[0])])
    i1 = torch.stack([luma(x[t - 1]) for x in noisy for t in range(1, x.shape[0])])
    flows = tvl1_flows(i0, i1, Consts(dev), duals=duals, **flow)
    out, k = [], 0
    for x in noisy:
        n = x.shape[0] - 1
        f = flows[k:k + n]
        k += n
        f = torch.cat([f[:1], f])
        out.append((f, torch.stack([occlusion_mask(u, occ_threshold) for u in f])))
    return out


def filter_precomputed(noisy, bflow, bocc, sigma, p1, p2, block_bytes=1 << 30):
    """Two-pass forward filtering along stored flows and masks -> (flt1, flt2)."""
    c = noisy.shape[-1]
    flt1, flt2 = [], []
    for t in range(noisy.shape[0]):
        n_opp = rgb2opp(noisy[t])
        if t == 0:
            wt = v1 = None
            priors = (None, None)
        else:
            wt, v1 = bicubic_warp(torch.cat([rgb2opp(flt1[-1]), rgb2opp(flt2[-1])], dim=-1),
                                  bflow[t], bocc[t])
            priors = (wt[..., :c], wt[..., c:2 * c])
        f11 = filter_frame(n_opp, priors[0], v1, None, sigma, p1, block_bytes)
        f21 = filter_frame(n_opp, priors[1], v1, f11, sigma, p2, block_bytes)
        flt1.append(opp2rgb(f11))
        flt2.append(opp2rgb(f21))
    return torch.stack(flt1), torch.stack(flt2)


def clip_mse(clean: np.ndarray, out: np.ndarray, first_frame: int, border: int) -> float:
    """Mean over frames from ``first_frame`` of each frame's MSE, ``border``
    pixels cropped on each side (float64)."""
    sl = np.s_[:, border:-border, border:-border] if border else np.s_[:]
    d = np.asarray(clean, np.float64)[sl] - np.asarray(out, np.float64)[sl]
    return float(np.mean(np.mean(d * d, axis=(1, 2, 3))[first_frame:]))
