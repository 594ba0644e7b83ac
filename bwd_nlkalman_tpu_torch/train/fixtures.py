"""Training fixtures: precomputed noisy frames, flow and occlusions; the
port of ``bwd_nlkalman_tpu.train.fixtures``.

The reference's training economy rests on per-(sequence, sigma) fixtures
computed ONCE and reused across every parameter trial: noisy frames are
written to disk, TV-L1 flow runs between consecutive NOISY frames, and
occlusion masks are derived from the flow divergence
(scripts/dev-scripts/tvl1flow-seq.sh:26-79, consumed by
nlkalman-train.sh:17-28). Without this, the flow — which does not
depend on the denoiser parameters being searched — dominates every
trial's wall clock.

Flow parameters mirror the training script's tvl1flow invocation
(tvl1flow-seq.sh:39: tau .25, lambda .2, theta .3, nscales 100,
fscale 1, zfactor .5, nwarps 5, epsilon .01); the first/last frame
copies its neighbour's flow (:43, :66). The flows run on the card (K2)
unless the caller asks for the CPU, and come back to the host as numpy.
The cache file's name and ``.npz`` layout are the JAX package's, so
either package reads a cache the other wrote.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np
import torch

from .._dispatch import check_engine, entry_device
from ..flow.occlusion import occlusion_mask
from ..flow.tvl1 import flow_bases, luma, tvl1_flow
from ..ops.bases import make_bases
from ..pipeline.gt import add_noise_sequence


@dataclasses.dataclass
class Fixtures:
    """Per-(sequence, sigma) training fixtures: numpy arrays on the host,
    or float32 tensors on a device after :meth:`to`."""

    noisy: np.ndarray          # (T, H, W, C)
    bflow: np.ndarray          # (T, H, W, 2) flow t -> t-1; [0] copies [1]
    bocc: np.ndarray           # (T, H, W)    255 = occluded
    fflow: np.ndarray | None   # (T, H, W, 2) flow t -> t+1; [-1] copies [-2]
    focc: np.ndarray | None

    def to(self, device) -> "Fixtures":
        """These fixtures as contiguous float32 tensors on ``device``: one
        upload per array; an array already there is not copied. ``self``
        may be any object with the five fields, such as the JAX package's
        ``Fixtures`` (``Fixtures.to(fx, device)``)."""
        def t(a):
            return None if a is None else torch.as_tensor(
                a, dtype=torch.float32, device=device).contiguous()

        return Fixtures(*(t(getattr(self, f.name)) for f in dataclasses.fields(Fixtures)))


def make_fixtures(
    clean: np.ndarray,
    sigma: float,
    seeds,
    directions: str = "all",       # "bwd" | "fwd" | "all" (tvl1flow-seq.sh $5)
    fscale: int = 1,
    lambda_: float = 0.2,
    occ_threshold: float = 0.75,
    engine: str = "auto",
    device="cuda",
) -> Fixtures:
    """Compute fixtures for one clean sequence (T, H, W, C): the noise on
    the host (reference-exact AWGN per frame), the flows and masks on
    ``device`` (the card unless the caller asks for the CPU)."""
    check_engine(engine)
    dev = entry_device(device, "make_fixtures")
    clean = np.asarray(clean, np.float32)
    t, h, w = clean.shape[:3]
    noisy = add_noise_sequence(clean, sigma, seeds)
    bases = make_bases(flow_bases(h, w), dev)
    lum = [luma(f) for f in torch.from_numpy(noisy).to(dev)]

    def flow_to(i, j):
        u = tvl1_flow(lum[i], lum[j], lambda_=lambda_, fscale=fscale,
                      bases=bases, engine=engine)
        return u.cpu().numpy(), occlusion_mask(u, occ_threshold).cpu().numpy()

    bflow = bocc = fflow = focc = None
    if directions in ("bwd", "all"):
        bflow = np.zeros(clean.shape[:3] + (2,), np.float32)
        bocc = np.zeros(clean.shape[:3], np.float32)
        for i in range(1, t):
            bflow[i], bocc[i] = flow_to(i, i - 1)
        bflow[0], bocc[0] = bflow[1], bocc[1]      # tvl1flow-seq.sh:43
    if directions in ("fwd", "all"):
        fflow = np.zeros(clean.shape[:3] + (2,), np.float32)
        focc = np.zeros(clean.shape[:3], np.float32)
        for i in range(t - 1):
            fflow[i], focc[i] = flow_to(i, i + 1)
        fflow[t - 1], focc[t - 1] = fflow[t - 2], focc[t - 2]
    return Fixtures(noisy, bflow, bocc, fflow, focc)


def _cache_key(name: str, clean: np.ndarray, sigma: float, seeds,
               directions: str, fscale: int, lambda_: float,
               occ_threshold: float) -> str:
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(clean[0]).tobytes()[:4096])
    h.update(repr((clean.shape, float(sigma), tuple(int(s) for s in seeds),
                   directions, fscale, lambda_, occ_threshold)).encode())
    return f"{name}_s{sigma:g}_{h.hexdigest()[:12]}"


def cached_fixtures(
    cache_dir: str,
    name: str,
    clean: np.ndarray,
    sigma: float,
    seeds,
    directions: str = "all",
    fscale: int = 1,
    lambda_: float = 0.2,
    occ_threshold: float = 0.75,
    engine: str = "auto",
    device="cuda",
) -> Fixtures:
    """Disk-cached :func:`make_fixtures` (the `if [ ! -f $file ]` reuse
    of tvl1flow-seq.sh:35,48). Key = content + every flow parameter; a
    cache file found is read and nothing runs on a device."""
    os.makedirs(cache_dir, exist_ok=True)
    key = _cache_key(name, np.asarray(clean, np.float32), sigma, seeds,
                     directions, fscale, lambda_, occ_threshold)
    path = os.path.join(cache_dir, key + ".npz")
    if os.path.exists(path):
        z = np.load(path)
        return Fixtures(
            z["noisy"],
            z["bflow"] if "bflow" in z else None,
            z["bocc"] if "bocc" in z else None,
            z["fflow"] if "fflow" in z else None,
            z["focc"] if "focc" in z else None,
        )
    fx = make_fixtures(clean, sigma, seeds, directions, fscale, lambda_,
                       occ_threshold, engine, device)
    arrs = {"noisy": fx.noisy}
    for k in ("bflow", "bocc", "fflow", "focc"):
        v = getattr(fx, k)
        if v is not None:
            arrs[k] = v
    np.savez(path, **arrs)
    return fx
