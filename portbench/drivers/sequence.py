"""Driver of the "sequence" entry: ``NLKalmanDenoiser`` over whole clips
(nlkalman-seq: two-pass forward filter with cold TV-L1 flows, then the
backward RTS smoother).

A request is one clip of the traffic's pool. The check takes the clip of
a request drawn from the seed and holds the program's flt1, flt2 and smo1
to the reference step by step (``reference/sequence.py``): frame 0's
spatial passes, every filter step and every smoother step, and the
smoother's start. Frame 0 is held on its own, each stage's steps by their
worst frame, so that a fault in any one frame shows. A frame's number is
its trimmed rms gap: the rms with the largest 0.1% of its squared
differences left out. On white-noise texture a few pixels of a frame
swing by tens of grey levels when a flow moves by a thousandth of a
pixel, which the program's and the reference's flows do by rounding
alone; those few pixels
would set a frame's plain rms, and the trimmed rms leaves them out.
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
    model: object
    clips: list
    order: list
    keep: int
    kept: tuple | None = None
    last: tuple | None = None


def setup(cell, seed: int, device, control: bool = False) -> State:
    """The model on ``device``, the traffic's clips made there from the seed,
    and one clip run to warm up. ``control`` runs the configuration's
    lower-precision control (its "control" options in place of "program")."""
    from bwd_nlkalman_tpu_torch import FlowConfig, NLKalmanDenoiser

    cfg, traf = cell.config, cell.traffic
    prog = cfg["control" if control else "program"]
    flow = FlowConfig(**cfg["flow"], occ_threshold=cfg["occ_threshold"],
                      state_dtype=prog["state_dtype"])
    model = NLKalmanDenoiser(cfg["sigma"], cfg["height"], cfg["width"], flow, device=device,
                             smoother=cfg["smoother"], window_dtype=prog["window_dtype"])
    clean = tr.clean_clips(traf, int(traf["pool"]), cfg["frames"], cfg["height"],
                           cfg["width"], cfg["channels"], seed, device)
    clips = tr.noisy_clips(traf, clean, cfg["sigma"], seed)
    del clean
    with torch.no_grad():
        model(clips[0])
    keep = int(tr.rng(seed, "check").integers(0, cfg["check"]["keep_within"]))
    return State(cell, seed, model, clips, tr.request_order(traf, 100_000, seed), keep)


def request(state: State, i: int) -> int:
    x = state.clips[state.order[i]]
    with torch.no_grad():
        outs = state.model(x)
    state.last = (x, outs)
    if i == state.keep:
        state.kept = state.last
    return x.shape[0]


def k1_passes(state: State, frames: int) -> list:
    """(FLOPs, bytes) of every NL-Kalman pass of one clip, from shapes and
    parameters: the first frame's spatial passes at the filter radius, the
    temporal filter and smoother passes at the temporal radius."""
    m = state.model
    cfg = state.cell.config
    h, w, c = cfg["height"], cfg["width"], cfg["channels"]
    out = []
    for p, basic in ((m.p1, False), (m.p2, True)):
        out.append(k1_pass_work(h, w, c, p.patch_sz, max(p.search_sz_x, p.search_sz_t),
                                False, basic))
        out += [k1_pass_work(h, w, c, p.patch_sz, p.search_sz_t, True, basic)] * (frames - 1)
    if cfg["smoother"] == "rts":
        out += [k1_pass_work(h, w, c, m.ps.patch_sz, m.ps.search_sz_t, True, False)] * (
            frames - 1)
    return out


def profile(state: State):
    from bwd_nlkalman_tpu_torch import kernel_counters

    x = state.clips[state.order[0]]

    def run():
        with torch.no_grad():
            state.model(x)
        torch.cuda.synchronize()

    return profile_request(run, kernel_counters, x.shape[0], k1_passes(state, x.shape[0]))


def check(state: State) -> list[Check]:
    """The program's outputs of the kept clip against the reference."""
    from portbench.reference.sequence import step_gaps

    cfg, chk = state.cell.config, state.cell.config["check"]
    x, (f1, f2, s1) = state.kept or state.last
    state.model = state.clips = state.last = state.kept = None
    if x.is_cuda:
        torch.cuda.empty_cache()
    t = x.shape[0]
    t0 = time.perf_counter()
    with torch.no_grad():
        g = step_gaps(x, f1, f2, s1, cfg["sigma"], cfg["flow"], cfg["occ_threshold"],
                      range(1, t), range(0, t - 1), int(chk["block_bytes"]), chk["trim"])
    print(f"reference: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    for stage in ("flt1", "flt2", "smo1"):
        print(f"{stage} trimmed rms / rms by frame: " + ", ".join(
            f"{k} {trimmed!r} {v!r}" for k, trimmed, v in g[stage]), file=sys.stderr)
    lim = chk["limits"]
    # frame 0 is the filter stages' first entry; np.max, not max, lets a NaN through
    frame0 = float(np.max([g[s][0][1] for s in ("flt1", "flt2")]))
    steps = {"flt1": g["flt1"][1:], "flt2": g["flt2"][1:], "smo1": g["smo1"]}
    worst = {s: float(np.max([v for _, v, _ in e])) for s, e in steps.items()}
    return [Check("frame0_trim_rms", frame0, lim["frame0_trim_rms"])] + [
        Check(f"{s}_trim_rms_max", worst[s], lim[f"{s}_trim_rms_max"])
        for s in ("flt1", "flt2", "smo1")] + [Check("smo1_last", g["smo1_last"], 0.0)]
