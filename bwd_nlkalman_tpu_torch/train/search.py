"""Parameter search: random search, discrete coordinate descent, line and
grid searches and numerical gradient descent; the port of
``bwd_nlkalman_tpu.train.search``.

The reference's training harness (scripts/dev-scripts): random search over
(np, beta_x, beta_t, lambda) at fixed patch/search sizes (train.sh:40-102),
and discrete coordinate descent over the group-size parameters
(train-nn-smoothing.sh:147-288). The evaluation protocol mirrors
nlkalman-train.sh: fixed noise fixtures, mean PSNR over sequences, measured
from a burn-in frame (:43-50) with an optional border crop (:35).

Every trial runs on ``device`` (the card unless the caller asks for the
CPU) with the given ``engine`` and ``window_dtype``. K1 takes the group
sizes and noise multipliers as launch arguments, so a trial builds and
compiles nothing new; ``dynamic`` is kept so that callers port unchanged
and changes no result. Fixtures go to the device once per search, and a
trial's outputs come back to the host once per sequence, for
``sequence_psnr``.

Results accumulate in the 16-column table format of
scripts/dev-scripts/run-nlk-set.sh:94-96:
sigma f1_nx f1_bx f1_nt f1_ntagg f1_bt f2_nx f2_bx f2_nt f2_ntagg f2_bt
s1_nt s1_bt f1_mse f2_mse s1_mse
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._dispatch import check_engine, check_window_dtype, entry_device
from ..ops.bases import make_bases
from ..params import NLKParams, FilterMode, default_params
from ..pipeline import add_noise_sequence, denoise_sequence, sequence_psnr
from ..pipeline.sequence import (FlowConfig, filter_sequence_precomputed,
                                 pipeline_bases, smooth_sequence_precomputed)
from .fixtures import Fixtures

_STAGES = ("flt1", "flt2", "smo1")


@dataclasses.dataclass
class TrialResult:
    sigma: float
    p1: NLKParams
    p2: NLKParams
    ps: NLKParams
    mse: dict          # {"flt1": .., "flt2": .., "smo1": ..}
    psnr: dict


def format_table_row(r: TrialResult) -> str:
    """16-column row (run-nlk-set.sh:94-96)."""
    return (
        f"{r.sigma:3.0f} "
        f"{r.p1.npatches_x:3d} {r.p1.beta_x:6.3f} {r.p1.npatches_t:3d} "
        f"{r.p1.npatches_tagg:3d} {r.p1.beta_t:6.3f} "
        f"{r.p2.npatches_x:3d} {r.p2.beta_x:6.3f} {r.p2.npatches_t:3d} "
        f"{r.p2.npatches_tagg:3d} {r.p2.beta_t:6.3f} "
        f"{r.ps.npatches_t:3d} {r.ps.beta_t:6.3f} "
        f"{r.mse['flt1']:9.4f} {r.mse['flt2']:9.4f} {r.mse['smo1']:9.4f}"
    )


def _append_row(table_path, r: TrialResult) -> None:
    if table_path:
        with open(table_path, "a") as fh:
            fh.write(format_table_row(r) + "\n")


def _flow_cfgs(flow_cfg, smooth_flow_cfg, flow_dyn, sflow_dyn):
    """The filtering and smoothing FlowConfigs a trial runs: the overrides
    of ``flow_dyn`` / ``sflow_dyn`` ('max_iters', 'lambda_',
    'occ_threshold') applied with ``dataclasses.replace``; the smoothing
    flow starts from ``smooth_flow_cfg or flow_cfg`` and inherits
    ``flow_dyn`` where ``sflow_dyn`` is None (JAX sequence.py:449-450)."""
    if flow_cfg is None:
        flow_cfg = FlowConfig()
    scfg = smooth_flow_cfg or flow_cfg
    sdyn = flow_dyn if sflow_dyn is None else sflow_dyn
    return (dataclasses.replace(flow_cfg, **(flow_dyn or {})),
            dataclasses.replace(scfg, **(sdyn or {})))


def _on_device(fixtures, device):
    """``fixtures`` (the port's or the JAX package's) with every array on
    ``device``; None stays None."""
    return None if fixtures is None else [Fixtures.to(fx, device) for fx in fixtures]


def evaluate(
    clean_seqs,
    sigma: float,
    p1: NLKParams,
    p2: NLKParams,
    ps: NLKParams,
    seeds=None,
    first_frame: int = 10,
    border: int = 10,
    smoothing: bool = True,
    flow_cfg=None,
    smooth_flow_cfg=None,
    fixtures=None,
    dynamic: bool = False,
    flow_dyn: dict | None = None,
    sflow_dyn: dict | None = None,
    engine: str = "auto",
    device="cuda",
    window_dtype: str = "float32",
) -> TrialResult:
    """Mean per-stage MSE/PSNR of one parameter set over clean sequences.

    ``fixtures``: optional list of :class:`..train.fixtures.Fixtures`
    (one per sequence), numpy or already on ``device``. When given, the
    evaluation runs the reference's TRAINING protocol — precomputed noise
    and noisy-frame flow reused across trials (nlkalman-train.sh:17-28) —
    instead of recomputing TV-L1 inside every trial. ``dynamic`` changes
    no result (K1 takes every group size and beta at launch).
    """
    check_engine(engine)
    check_window_dtype(window_dtype)
    dev = entry_device(device, "evaluate")
    if fixtures is not None and (flow_dyn or sflow_dyn):
        raise ValueError(
            "flow_dyn/sflow_dyn have no effect with fixtures (their flow "
            "is precomputed); rebuild fixtures with the new flow "
            "parameters or evaluate without fixtures"
        )
    fcfg, scfg = _flow_cfgs(flow_cfg, smooth_flow_cfg, flow_dyn, sflow_dyn)
    fixtures = _on_device(fixtures, dev)
    kw = dict(engine=engine, window_dtype=window_dtype)
    mses = {k: [] for k in _STAGES}
    psnrs = {k: [] for k in _STAGES}
    for si, clean in enumerate(clean_seqs):
        t, h, w = clean.shape[:3]
        seq_seeds = (
            [1000 * si + i for i in range(t)] if seeds is None else seeds[si]
        )
        with torch.no_grad():
            if fixtures is not None:
                fx = fixtures[si]
                kw["bases"] = make_bases(pipeline_bases(h, w, (), (p1, p2, ps)), dev)
                outs = filter_sequence_precomputed(fx.noisy, fx.bflow, fx.bocc,
                                                   sigma, p1, p2, **kw)
                if smoothing:
                    outs += (smooth_sequence_precomputed(outs[1], fx.fflow, fx.focc,
                                                         sigma, ps, **kw),)
            else:
                noisy = add_noise_sequence(
                    np.asarray(clean, np.float32), sigma, seq_seeds
                )
                kw["bases"] = make_bases(
                    pipeline_bases(h, w, (fcfg, scfg), (p1, p2, ps)), dev)
                outs = denoise_sequence(torch.from_numpy(noisy).to(dev), sigma,
                                        p1, p2, ps, fcfg, smoothing, scfg, **kw)
                outs = outs if smoothing else outs[:2]
            # the trial's outputs come to the host in one copy
            stacks = torch.stack(outs).cpu().numpy()
        ff = min(first_frame, t - 1)
        for k, v in zip(_STAGES, stacks):
            m = sequence_psnr(clean, v, first_frame=ff, border=border)
            mses[k].append(m["mse"])
            psnrs[k].append(m["psnr"])
    agg_mse = {k: float(np.mean(v)) if v else float("nan") for k, v in mses.items()}
    agg_psnr = {k: float(np.mean(v)) if v else float("nan") for k, v in psnrs.items()}
    return TrialResult(sigma, p1, p2, ps, agg_mse, agg_psnr)


def random_search(
    clean_seqs,
    sigma: float,
    n_trials: int,
    rng=None,
    table_path: str | None = None,
    first_frame: int = 10,
    smoothing: bool = False,
    fixtures=None,
    dynamic: bool | None = None,
    respect_lambda: bool = False,
    engine: str = "auto",
    device="cuda",
    window_dtype: str = "float32",
):
    """Random search a la train.sh:40-102: samples np in [0,99),
    beta_x in [0,8), beta_t in [2,12), lambda in [0,1) at p=8, w=10.

    The fixtures go to ``device`` once, before the first trial. train.sh
    samples a distance lambda but the shipped reference build ignores it
    (K_SIMILAR_PATCHES without LAMBDA_DISTANCE, src/nlkalman.c:686);
    respect_lambda=True exercises the LAMBDA_DISTANCE v2 variant instead,
    which K1 does not take: its passes run the plain pass, by the engine
    rule of ``core.nlkalman.k1_supported``, with its warning."""
    if dynamic is None:
        dynamic = fixtures is not None
    if rng is None:
        rng = np.random.default_rng(0)
    fixtures = _on_device(fixtures, entry_device(device, "random_search"))
    results = []
    for _ in range(n_trials):
        npx = int(rng.integers(1, 99))
        bx = float(rng.uniform(0, 8))
        bt = float(rng.uniform(2, 12))
        lam = float(rng.uniform(0, 1))
        base = NLKParams(
            patch_sz=8, search_sz_x=10, search_sz_t=5,
            npatches_x=npx, npatches_t=npx, npatches_tagg=min(npx, 20),
            dista_lambda=lam if respect_lambda else 1.0,
            beta_x=bx, beta_t=bt,
        )
        p2 = default_params(sigma, FilterMode.FLT2)
        ps = default_params(sigma, FilterMode.SMO1)
        r = evaluate(clean_seqs, sigma, base, p2, ps,
                     first_frame=first_frame, smoothing=smoothing,
                     fixtures=fixtures, dynamic=dynamic, engine=engine,
                     device=device, window_dtype=window_dtype)
        results.append(r)
        _append_row(table_path, r)
    results.sort(key=lambda r: r.mse["flt2"])
    return results


def coordinate_descent(
    clean_seqs,
    sigma: float,
    fields=("f1_nx", "f1_nt", "f1_ntagg", "f2_nx", "f2_nt", "s1_nt"),
    step: int = 5,
    max_rounds: int = 3,
    objective: str = "smo1",
    first_frame: int = 10,
    table_path: str | None = None,
    engine: str = "auto",
    device="cuda",
    window_dtype: str = "float32",
):
    """Discrete coordinate descent (train-nn-smoothing.sh:147-288): walk
    each group-size field by +-step while the objective MSE improves."""
    kw = dict(first_frame=first_frame, engine=engine, device=device,
              window_dtype=window_dtype)
    p1 = default_params(sigma, FilterMode.FLT1)
    p2 = default_params(sigma, FilterMode.FLT2)
    ps = default_params(sigma, FilterMode.SMO1)

    def get(field, p1, p2, ps):
        obj = {"f1": p1, "f2": p2, "s1": ps}[field[:2]]
        attr = {"nx": "npatches_x", "nt": "npatches_t", "ntagg": "npatches_tagg"}[
            field.split("_")[1]
        ]
        return obj, attr

    def with_field(field, val, p1, p2, ps):
        obj, attr = get(field, p1, p2, ps)
        new = dataclasses.replace(obj, **{attr: max(1, val)})
        return {
            "f1": (new, p2, ps), "f2": (p1, new, ps), "s1": (p1, p2, new)
        }[field[:2]]

    best = evaluate(clean_seqs, sigma, p1, p2, ps, **kw)
    history = [best]
    for _ in range(max_rounds):
        improved = False
        for field in fields:
            for direction in (+1, -1):
                while True:
                    obj, attr = get(field, p1, p2, ps)
                    cand_val = getattr(obj, attr) + direction * step
                    if cand_val < 1:
                        break
                    c1, c2, cs = with_field(field, cand_val, p1, p2, ps)
                    r = evaluate(clean_seqs, sigma, c1, c2, cs, **kw)
                    history.append(r)
                    _append_row(table_path, r)
                    if r.mse[objective] < best.mse[objective]:
                        best = r
                        p1, p2, ps = c1, c2, cs
                        improved = True
                    else:
                        break
        if not improved:
            break
    return best, history


def line_search(
    clean_seqs,
    sigma: float,
    field: str,
    values,
    objective: str = "smo1",
    first_frame: int = 10,
    table_path: str | None = None,
    engine: str = "auto",
    device="cuda",
    window_dtype: str = "float32",
):
    """1-D line search over one beta/group-size field (the
    line-search-smoothing.sh / line-search-filtering-oflow.sh family).
    field: e.g. "f1_bx", "f2_bt", "s1_bt", "f1_nx", "s1_nt"."""
    attr_map = {"nx": "npatches_x", "nt": "npatches_t",
                "ntagg": "npatches_tagg", "bx": "beta_x", "bt": "beta_t"}
    which, key = field.split("_", 1)
    attr = attr_map[key]
    results = []
    for v in values:
        p1 = default_params(sigma, FilterMode.FLT1)
        p2 = default_params(sigma, FilterMode.FLT2)
        ps = default_params(sigma, FilterMode.SMO1)
        tgt = {"f1": p1, "f2": p2, "s1": ps}[which]
        tgt = dataclasses.replace(tgt, **{attr: v})
        p1, p2, ps = {
            "f1": (tgt, p2, ps), "f2": (p1, tgt, ps), "s1": (p1, p2, tgt)
        }[which]
        r = evaluate(clean_seqs, sigma, p1, p2, ps, first_frame=first_frame,
                     engine=engine, device=device, window_dtype=window_dtype)
        results.append((v, r))
        _append_row(table_path, r)
    results.sort(key=lambda t: t[1].mse[objective])
    return results


_BETA_ATTR = {"bx": "beta_x", "bt": "beta_t"}


def _with_betas(sigma, betas: dict):
    """Params triple with the given {"f1_bx": v, ...} beta overrides."""
    p1 = default_params(sigma, FilterMode.FLT1)
    p2 = default_params(sigma, FilterMode.FLT2)
    ps = default_params(sigma, FilterMode.SMO1)
    out = {"f1": p1, "f2": p2, "s1": ps}
    for field, v in betas.items():
        which, key = field.split("_", 1)
        out[which] = dataclasses.replace(out[which], **{_BETA_ATTR[key]: v})
    return out["f1"], out["f2"], out["s1"]


def gradient_descent(
    clean_seqs,
    sigma: float,
    fields=("f1_bx", "f1_bt", "f2_bx", "f2_bt", "s1_bt"),
    n_iters: int = 10,
    step: float = 0.05,
    gs: float = 0.01,
    objective: str = "smo1",
    first_frame: int = 10,
    table_path: str | None = None,
    engine: str = "auto",
    device="cuda",
    window_dtype: str = "float32",
):
    """Numerical-gradient descent on the beta parameters, mirroring
    scripts/dev-scripts/train-gd-smoothing.sh: forward-difference gradient
    of the objective MSE (gs step, :125-146) and update x -= step * grad
    (:155-160). Returns (history, final_betas); history entries are
    TrialResults at the visited points."""
    kw = dict(first_frame=first_frame, engine=engine, device=device,
              window_dtype=window_dtype)
    betas = {}
    p1 = default_params(sigma, FilterMode.FLT1)
    p2 = default_params(sigma, FilterMode.FLT2)
    ps = default_params(sigma, FilterMode.SMO1)
    src = {"f1": p1, "f2": p2, "s1": ps}
    for field in fields:
        which, key = field.split("_", 1)
        betas[field] = float(getattr(src[which], _BETA_ATTR[key]))

    history = []
    for _ in range(n_iters):
        r0 = evaluate(clean_seqs, sigma, *_with_betas(sigma, betas), **kw)
        history.append(r0)
        _append_row(table_path, r0)
        grad = {}
        for field in fields:
            bumped = dict(betas)
            bumped[field] += gs
            rb = evaluate(clean_seqs, sigma, *_with_betas(sigma, bumped), **kw)
            grad[field] = (rb.mse[objective] - r0.mse[objective]) / gs
        for field in fields:
            betas[field] -= step * grad[field]
    return history, betas


def grid_search_2d(
    clean_seqs,
    sigma: float,
    field_a: str,
    values_a,
    field_b: str,
    values_b,
    objective: str = "flt2",
    first_frame: int = 10,
    table_path: str | None = None,
    engine: str = "auto",
    device="cuda",
    window_dtype: str = "float32",
):
    """2-D grid search mirroring
    scripts/dev-scripts/2d-search-filtering-oflow.sh:83-100.

    Fields may be NLK beta/group fields ("f1_bx", "s1_bt", ...) or the
    flow data-weight / occlusion-threshold pairs the reference script
    sweeps: "fflow_lambda"/"fflow_occ" (filtering flow) and
    "sflow_lambda"/"sflow_occ" (smoothing flow); "fflow_fscale" /
    "sflow_fscale" change the FlowConfig itself. Returns results sorted
    by the objective MSE as [((va, vb), TrialResult), ...]."""

    def apply(field, v, betas, fcfg, scfg, fdyn, sdyn):
        if field.startswith("fflow_") or field.startswith("sflow_"):
            attr = {"lambda": "lambda_", "occ": "occ_threshold",
                    "fscale": "fscale"}[field.split("_", 1)[1]]
            if attr == "fscale":
                if field.startswith("fflow_"):
                    fcfg = dataclasses.replace(fcfg, **{attr: v})
                else:
                    scfg = dataclasses.replace(scfg, **{attr: v})
            else:
                d = fdyn if field.startswith("fflow_") else sdyn
                d[attr] = float(v)
        else:
            betas = dict(betas)
            betas[field] = v
        return betas, fcfg, scfg, fdyn, sdyn

    results = []
    for va in values_a:
        for vb in values_b:
            st = ({}, FlowConfig(), FlowConfig(), {}, {})
            st = apply(field_a, va, *st)
            betas, fcfg, scfg, fdyn, sdyn = apply(field_b, vb, *st)
            r = evaluate(
                clean_seqs, sigma, *_with_betas(sigma, betas),
                first_frame=first_frame, flow_cfg=fcfg,
                smooth_flow_cfg=scfg,
                flow_dyn=fdyn or None,
                # {} = "no overrides" for the smoothing direction (evaluate
                # would otherwise inherit flow_dyn when sflow_dyn is None)
                sflow_dyn=sdyn if sdyn else ({} if fdyn else None),
                engine=engine, device=device, window_dtype=window_dtype,
            )
            results.append(((va, vb), r))
            _append_row(table_path, r)
    results.sort(key=lambda t: t[1].mse[objective])
    return results
