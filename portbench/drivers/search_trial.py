"""Driver of the "search_trial" entry: trials of the parameter search on
training fixtures (train.sh:40-102 on nlkalman-train.sh's protocol).

Set-up builds the fixtures with the program's ``make_fixtures`` (noise,
backward TV-L1 flows and occlusion masks of every clip, once) and puts
them on the device, as a search does. A request is one trial: first-pass
parameters drawn from the seed as ``random_search`` draws them, then
``evaluate`` over every clip without smoothing. The check holds the
fixtures' noise, flows and masks, and the MSE of a trial drawn from the
seed, to the reference (``reference/search.py``), which builds its own
fixtures from the clean clips and the noise seeds.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from portbench import traffic as tr
from portbench.harness import Check
from portbench.roofline import k1_pass_work
from portbench.trace import profile_request


@dataclasses.dataclass
class State:
    cell: object
    seed: int
    device: object
    clean: list
    seeds: np.ndarray
    fixtures: list        # the program's, as numpy
    on_device: list
    draws: object
    window_dtype: str
    keep: int
    kept: tuple | None = None
    last: tuple | None = None


def _trial_params(cfg: dict, draw: dict):
    """The first pass's parameters of a trial (random_search's ``base``)."""
    from bwd_nlkalman_tpu_torch.params import NLKParams

    t = cfg["trial"]
    n = draw["npatches"]
    return NLKParams(patch_sz=t["patch_sz"], search_sz_x=t["search_sz_x"],
                     search_sz_t=t["search_sz_t"], npatches_x=n, npatches_t=n,
                     npatches_tagg=min(n, t["tagg_cap"]), dista_lambda=1.0,
                     beta_x=draw["beta_x"], beta_t=draw["beta_t"])


def _reference_fixtures(cell, clean, seeds, device, duals="float32"):
    """(noisy, bflow, bocc) of every clip as the reference builds them."""
    from portbench.reference.search import backward_fixtures, noisy_clip

    cfg = cell.config
    noisy = [torch.as_tensor(noisy_clip(c, cfg["sigma"], s), device=device)
             for c, s in zip(clean, seeds)]
    with torch.no_grad():
        fx = backward_fixtures(noisy, cfg["flow"], cfg["fixtures"]["occ_threshold"], duals)
    return noisy, fx


def setup(cell, seed: int, device, control: bool = False) -> State:
    """The clips and their fixtures on ``device``, and one trial run to warm
    up. ``control``: the fixtures built by the reference with bfloat16
    duals and the trials run with the configuration's "control" options."""
    from bwd_nlkalman_tpu_torch.train.fixtures import Fixtures, make_fixtures

    cfg, traf = cell.config, cell.traffic
    n, t = cfg["clips"], cfg["frames"]
    clean = [c.cpu().numpy() for c in tr.clean_clips(traf, n, t, cfg["height"], cfg["width"],
                                                      cfg["channels"], seed, device)]
    seeds = tr.awgn_seeds(n, t, seed)
    fx = cfg["fixtures"]
    if control:
        noisy, ref = _reference_fixtures(cell, clean, seeds, device,
                                         cfg["control"]["fixture_duals"])
        fixtures = [Fixtures(a.cpu().numpy(), f.cpu().numpy(), m.cpu().numpy(), None, None)
                    for a, (f, m) in zip(noisy, ref)]
    else:
        fixtures = [make_fixtures(c, cfg["sigma"], s, directions=fx["directions"],
                                  fscale=cfg["flow"]["fscale"], lambda_=cfg["flow"]["lambda_"],
                                  occ_threshold=fx["occ_threshold"], device=device)
                    for c, s in zip(clean, seeds)]
    state = State(cell, seed, device, clean, seeds, fixtures,
                  [Fixtures.to(f, device) for f in fixtures], tr.trial_draws(traf, seed),
                  cfg["control" if control else "program"]["window_dtype"],
                  int(tr.rng(seed, "check").integers(0, cfg["check"]["keep_within"])))
    _trial(state, next(tr.trial_draws(traf, seed, "warmup")))
    return state


def _trial(state: State, draw: dict):
    from bwd_nlkalman_tpu_torch.params import FilterMode, default_params
    from bwd_nlkalman_tpu_torch.train.search import evaluate

    cfg = state.cell.config
    s = cfg["sigma"]
    return evaluate(state.clean, s, _trial_params(cfg, draw), default_params(s, FilterMode.FLT2),
                    default_params(s, FilterMode.SMO1), first_frame=cfg["first_frame"],
                    border=cfg["border"], smoothing=cfg["trial"]["smoothing"],
                    fixtures=state.on_device, device=state.device,
                    window_dtype=state.window_dtype)


def request(state: State, i: int) -> int:
    draw = next(state.draws)
    state.last = (draw, _trial(state, draw))
    if i == state.keep:
        state.kept = state.last
    cfg = state.cell.config
    return cfg["clips"] * cfg["frames"]


def profile(state: State):
    from bwd_nlkalman_tpu_torch import kernel_counters

    cfg = state.cell.config
    draws = tr.trial_draws(state.cell.traffic, state.seed, "warmup")
    next(draws)
    draw = next(draws)
    p = _trial_params(cfg, draw)
    from bwd_nlkalman_tpu_torch.params import FilterMode, default_params

    p2 = default_params(cfg["sigma"], FilterMode.FLT2)
    h, w, c, t = cfg["height"], cfg["width"], cfg["channels"], cfg["frames"]
    passes = []
    for q, basic in ((p, False), (p2, True)):
        passes.append(k1_pass_work(h, w, c, q.patch_sz, max(q.search_sz_x, q.search_sz_t),
                                   False, basic))
        passes += [k1_pass_work(h, w, c, q.patch_sz, q.search_sz_t, True, basic)] * (t - 1)

    def run():
        _trial(state, draw)
        torch.cuda.synchronize()

    return profile_request(run, kernel_counters, cfg["clips"] * t, passes * cfg["clips"])


def check(state: State) -> list[Check]:
    """The fixtures and the kept trial against the reference."""
    from portbench.reference.params import Params, default_params
    from portbench.reference.search import clip_mse, filter_precomputed

    cfg, chk = state.cell.config, state.cell.config["check"]
    draw, result = state.kept or state.last
    prog = state.fixtures
    state.on_device = state.last = state.kept = None
    if state.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    noisy, ref = _reference_fixtures(state.cell, state.clean, state.seeds, state.device)
    t1 = time.perf_counter()
    noise_gap = max(float(np.abs(a.cpu().numpy() - f.noisy).max()) for a, f in zip(noisy, prog))
    epe, mism, npx = 0.0, 0.0, 0
    for (fl, oc), f in zip(ref, prog):
        d = fl - torch.as_tensor(f.bflow, device=fl.device)
        epe += float(torch.sqrt((d * d).sum(-1)).sum())
        mism += float(((oc != 0) != (torch.as_tensor(f.bocc, device=oc.device) != 0)).sum())
        npx += oc.numel()
    t = cfg["trial"]
    n = draw["npatches"]
    p1 = Params(t["patch_sz"], t["search_sz_x"], t["search_sz_t"], n, n, min(n, t["tagg_cap"]),
                draw["beta_x"], draw["beta_t"])
    p2 = default_params(cfg["sigma"], "flt2")
    mse = {"flt1": [], "flt2": []}
    ff = min(cfg["first_frame"], cfg["frames"] - 1)
    with torch.no_grad():
        for c, a, (fl, oc) in zip(state.clean, noisy, ref):
            outs = filter_precomputed(a, fl, oc, cfg["sigma"], p1, p2, int(chk["block_bytes"]))
            for k, o in zip(("flt1", "flt2"), outs):
                mse[k].append(clip_mse(c, o.cpu().numpy(), ff, cfg["border"]))
    gaps = {k: abs(result.mse[k] - float(np.mean(v))) / float(np.mean(v))
            for k, v in mse.items()}
    print(f"reference: fixtures {t1 - t0:.1f} s, trial {time.perf_counter() - t1:.1f} s",
          file=sys.stderr)
    print(f"trial {draw}: program mse {result.mse}, reference mse "
          f"{ {k: float(np.mean(v)) for k, v in mse.items()} }", file=sys.stderr)
    lim = chk["limits"]
    return [Check("noise_gap", noise_gap, 0.0),
            Check("flow_epe_mean", epe / npx, lim["flow_epe_mean"]),
            Check("mask_mismatch_share", mism / npx, lim["mask_mismatch_share"]),
            Check("mse_gap_flt1", gaps["flt1"], lim["mse_gap_flt1"]),
            Check("mse_gap_flt2", gaps["flt2"], lim["mse_gap_flt2"])]
