"""The one generator of the benchmark's inputs, driven by a traffic file.

A traffic mix (``traffic/<name>.json``) names the content and its
parameters; everything is drawn from the run's ``--seed``, so the same
seed gives the same inputs:

- ``content``: "scene", a Brownian surface (the double cumulative sum of
  white noise) scaled into ``range``; or "texture", white noise uniform
  in ``range``, on which TV-L1 runs longer than on the scene.
- ``wrap`` and ``shift``: frame t is the field's window at offset
  ``(t * shift) % wrap`` on both axes (a diagonal translation that jumps
  back every ``wrap // shift`` frames).
- ``pool``: how many distinct clips a run makes; the window's requests
  cycle through them in an order drawn from the seed.
- ``noise``: "gaussian", the configuration's sigma times N(0, 1) drawn on
  the device; or "awgn", per-frame seeds for the reference-exact AWGN
  that the program's fixtures add themselves.
- ``draws``: for search trials, the ranges that each trial's parameters
  are drawn from, in the order ``random_search`` draws them.
"""

from __future__ import annotations

import numpy as np
import torch

SEED_STREAMS = {"content": 1, "order": 2, "draws": 3, "check": 4, "noise": 5, "warmup": 6}


def rng(seed: int, stream: str) -> np.random.Generator:
    """The numpy generator of one named use of the run's seed."""
    return np.random.default_rng([int(seed), SEED_STREAMS[stream]])


def torch_generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(rng(seed, stream).integers(0, 2 ** 63 - 1)))
    return g


def field(traffic: dict, h: int, w: int, gen: torch.Generator, device) -> torch.Tensor:
    """One (h, w) clean field of the traffic's content, float32 on ``device``."""
    lo, hi = traffic["range"]
    if traffic["content"] == "scene":
        b = torch.randn(h, w, generator=gen, device=device, dtype=torch.float64)
        b = b.cumsum(0).cumsum(1)
        b = (b - b.min()) / (b.max() - b.min())
    elif traffic["content"] == "texture":
        b = torch.rand(h, w, generator=gen, device=device, dtype=torch.float64)
    else:
        raise ValueError(f"unknown content {traffic['content']!r}")
    return (b * (hi - lo) + lo).to(torch.float32)


def clean_clips(traffic: dict, n: int, frames: int, h: int, w: int, channels: int,
                seed: int, device) -> list[torch.Tensor]:
    """``n`` clean (frames, h, w, channels) clips on ``device``."""
    wrap, shift = int(traffic["wrap"]), int(traffic.get("shift", 1))
    gen = torch_generator(seed, "content", device)
    clips = []
    for _ in range(n):
        fields = torch.stack([field(traffic, h + wrap, w + wrap, gen, device)
                              for _ in range(channels)], dim=-1)
        offs = [(t * shift) % wrap for t in range(frames)]
        clips.append(torch.stack([fields[o:o + h, o:o + w] for o in offs]))
    return clips


def noisy_clips(traffic: dict, clean: list, sigma: float, seed: int) -> list[torch.Tensor]:
    """Each clip plus sigma times N(0, 1), drawn on its device."""
    if traffic["noise"] != "gaussian":
        raise ValueError("noisy_clips adds Gaussian noise; 'awgn' noise is the program's")
    gen = torch_generator(seed, "noise", clean[0].device)
    return [c + sigma * torch.randn(c.shape, generator=gen, device=c.device) for c in clean]


def awgn_seeds(n: int, frames: int, seed: int) -> np.ndarray:
    """(n, frames) SRAND seeds of the per-frame AWGN."""
    return rng(seed, "noise").integers(0, 2 ** 31 - 1, size=(n, frames))


def request_order(traffic: dict, n_requests: int, seed: int) -> list[int]:
    """Which pool clip each request takes: the pool in a seeded order, over
    and over."""
    pool = int(traffic["pool"])
    order = []
    r = rng(seed, "order")
    while len(order) < n_requests:
        order.extend(int(i) for i in r.permutation(pool))
    return order[:n_requests]


def trial_draws(traffic: dict, seed: int, stream: str = "draws"):
    """An endless sequence of trial parameter draws {name: value}, each
    drawn as ``random_search`` draws it: integers in [lo, hi), the rest
    uniform in [lo, hi)."""
    r = rng(seed, stream)
    while True:
        out = {}
        for name, (lo, hi) in traffic["draws"].items():
            out[name] = int(r.integers(lo, hi)) if isinstance(lo, int) and isinstance(
                hi, int) else float(r.uniform(lo, hi))
        yield out
