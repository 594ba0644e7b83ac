"""The multichip dry run: the production sharded pipeline on an n-device
mesh (the port's twin of ``__graft_entry__.dryrun_multichip``).

Run ``python -m bwd_nlkalman_tpu_torch.parallel.dryrun [n]`` (n = 4 by
default) on a machine with a card. With fewer than n cards the mesh
repeats ``cuda:0``; the summary line says which.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..flow.tvl1 import luma, warm_gate_probe
from ..params import FilterMode, default_params
from ..pipeline.sequence import FlowConfig
from .flow import STATS as FLOW_STATS
from .mesh import make_mesh
from .sequence import denoise_sequence_sharded
from .spatial import _spatial_pass, resolve_engine, shard_halo


def _devices(n: int, devices):
    """(devices, how they were chosen): ``devices`` as given, else n cards
    where there are as many, else ``cuda:0`` n times."""
    if devices is not None:
        return [torch.device(d) for d in devices], "as given"
    if not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device; pass devices=['cpu'] * n")
    have = torch.cuda.device_count()
    if have >= n:
        return [torch.device("cuda", i) for i in range(n)], f"{n} cards"
    return [torch.device("cuda", 0)] * n, f"cuda:0 x {n} ({have} card(s) visible)"


def dryrun_multichip(n_devices: int, devices=None) -> str:
    """Run the production sharded pipeline on an n-device mesh; returns
    (and prints) the summary line.

    1. ``denoise_sequence_sharded`` on a dp=1 x sp=n mesh: production
       NL-Kalman parameters (psz 8, search 10/5, 20-row step-aligned
       halos), production flow (``FlowConfig(fscale=1, warm_start=True)``,
       sharded: ``parallel/flow.py``), frames (3, 40 n, 512, 1): the
       forward loop and the RTS reverse loop, with the flow levels that ran
       sharded and those the small-level rule ran whole;
       the engine the passes ran on (``resolve_engine``) and the warm-gate
       branch of the second step, recomputed through ``warm_gate_probe``
       from the carry the sharded sequence seeds;
    2. for even n > 1, a batched dp=2 x sp=n/2 sharded pass.
    """
    devs, how = _devices(n_devices, devices)
    sigma = 20.0
    p1, p2, ps = (default_params(sigma, m) for m in
                  (FilterMode.FLT1, FilterMode.FLT2, FilterMode.SMO1))

    sp = n_devices
    mesh1 = make_mesh(dp=1, sp=sp, devices=devs)
    t, h, w = 3, 40 * sp, 512       # 40-row shard blocks >= the 20-row halo
    cfg = FlowConfig(fscale=1, warm_start=True)
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.arange(h + 8), np.arange(w + 8), indexing="ij")
    base = (110 + 70 * np.sin(0.09 * xx) * np.cos(0.12 * yy)).astype(np.float32)
    clean = np.stack([base[i:i + h, i:i + w] for i in range(t)])[..., None]
    noisy = torch.from_numpy(
        clean + sigma * rng.standard_normal(clean.shape).astype(np.float32)).to(mesh1.first)
    FLOW_STATS.reset()
    flt1, flt2, smo1 = denoise_sequence_sharded(noisy, sigma, mesh1, p1, p2, ps,
                                                flow_cfg=cfg)
    levels = {"sharded": sorted(set(FLOW_STATS.levels_sharded)),
              "whole": sorted(set(FLOW_STATS.levels_whole))}
    if smo1.shape != noisy.shape or not bool(torch.isfinite(smo1).all()):
        raise RuntimeError("dryrun_multichip: the sharded sequence's smo1 is not finite "
                           "frames of the clip's shape")
    halo = shard_halo(p1, "filter")
    engine = resolve_engine(h // sp + 2 * halo, w, 1, p1, "filter", mesh1.first)
    # the warm gate of the second step, from the carry the peeled first
    # step seeds
    with torch.no_grad():
        _, u_fs = cfg.flow_cold_carry(luma(noisy[1]), luma(flt2[0]))
        gate_ok, r_warm, r_zero = warm_gate_probe(luma(noisy[2]), luma(flt2[1]), u_fs,
                                                  fscale=cfg.fscale)
    if not bool(gate_ok):
        raise RuntimeError(f"dryrun_multichip: the warm-gate branch did not run at step 2 "
                           f"(r_warm={float(r_warm):.4f} > r_zero={float(r_zero):.4f})")

    batched = "skipped (n odd or 1)"
    if n_devices % 2 == 0 and n_devices > 1:
        mesh2 = make_mesh(dp=2, sp=n_devices // 2, devices=devs)
        nb = torch.from_numpy(rng.uniform(0, 255, (2, 40 * (n_devices // 2), 96, 1))
                              .astype(np.float32)).to(mesh2.first)
        out = _spatial_pass(nb, torch.zeros_like(nb), torch.zeros(nb.shape[:3],
                            dtype=torch.bool, device=nb.device), nb, sigma, p1,
                            "filter", False, False, mesh2)
        if out.shape != nb.shape or not bool(torch.isfinite(out).all()):
            raise RuntimeError("dryrun_multichip: the dp x sp pass is not finite")
        batched = f"dp=2 x sp={n_devices // 2} batched pass OK"
    line = (f"dryrun_multichip OK: sharded end-to-end sequence (filter loop + RTS "
            f"reverse loop) on dp=1 x sp={sp} mesh of {how}, frames {tuple(noisy.shape)}, "
            f"production params psz=8 search 10/5 (halo {halo}), flow fscale=1 "
            f"full-pyramid warm-started and sharded (levels sharded {levels['sharded']}, "
            f"run whole by the small-level rule {levels['whole']}); measured: NLK engine dispatched = {engine} "
            f"(resolve_engine on this mesh), warm-gate branch executed at step 2 "
            f"(r_warm={float(r_warm):.4f} <= r_zero={float(r_zero):.4f}); {batched}")
    print(line, flush=True)
    return line


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
