"""The port's search drivers and ``view_results`` against the JAX package's.

The drivers' control flow is held with ``evaluate`` replaced, in both
``search`` modules, by the same deterministic stub: a quadratic in the
parameters and in the flow settings the trial would run. Each driver
must then visit JAX's points in JAX's order, return the same results and
write the same table rows; ``grid_search_2d`` must also hand ``evaluate``
the same flow overrides and run the same effective flow settings, case by
case. No JAX function is compiled here. Then each driver runs once for
real, port only, on a tiny clip on the CPU, and ``view_results`` is held
to JAX's on one table: identical results.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from bwd_nlkalman_tpu.pipeline import sequence as j_seq
from bwd_nlkalman_tpu.train import search as j_search
from bwd_nlkalman_tpu.train import view_results as j_view
from bwd_nlkalman_tpu_torch.train import search, view_results

torch.set_num_threads(1)
SIGMA = 20.0

# the stub's optimum: a few steps from the sigma=20 defaults
TARGET = {"npatches_x": 7.0, "npatches_t": 12.0, "npatches_tagg": 3.0,
          "beta_x": 2.7, "beta_t": 3.3}


def _q(p, scale):
    return sum(scale * (getattr(p, k) - v) ** 2 for k, v in TARGET.items())


def _f32(x):
    return float(np.float32(float(x)))


def _effective_flow(pkg, flow_cfg, smooth_flow_cfg, flow_dyn, sflow_dyn):
    """(lambda, occ, fscale, max_iters) of the filtering and the smoothing
    flow a trial runs: JAX's by its own FlowConfig rules (``_kw``,
    ``occ_th`` and denoise_sequence's inheritance, sequence.py:449-450),
    the port's from ``search._flow_cfgs``."""
    if pkg == "jax":
        fcfg = flow_cfg or j_seq.FlowConfig()
        scfg = smooth_flow_cfg or fcfg
        sdyn = flow_dyn if sflow_dyn is None else sflow_dyn
        return tuple((_f32(c._kw(d)["lambda_"]), _f32(c.occ_th(d)), c.fscale,
                      c._kw(d)["max_iters"]) for c, d in ((fcfg, flow_dyn), (scfg, sdyn)))
    fcfg, scfg = search._flow_cfgs(flow_cfg, smooth_flow_cfg, flow_dyn, sflow_dyn)
    return tuple((_f32(c.lambda_), _f32(c.occ_threshold), c.fscale, c.max_iters)
                 for c in (fcfg, scfg))


def _dyn(d):
    return None if d is None else {k: _f32(v) for k, v in d.items()}


class Stub:
    """A deterministic ``evaluate`` for one package's ``search`` module."""

    def __init__(self, pkg, module):
        self.pkg, self.module, self.calls = pkg, module, []

    def __call__(self, clean_seqs, sigma, p1, p2, ps, flow_cfg=None, smooth_flow_cfg=None,
                 flow_dyn=None, sflow_dyn=None, **kw):
        flow = _effective_flow(self.pkg, flow_cfg, smooth_flow_cfg, flow_dyn, sflow_dyn)
        self.calls.append((tuple(dataclasses.astuple(p) for p in (p1, p2, ps)), flow,
                           _dyn(flow_dyn), _dyn(sflow_dyn)))
        (f_lam, f_occ, _, _), (s_lam, s_occ, _, _) = flow
        m1 = 20.0 + _q(p1, 0.05) + 30 * (f_lam - 0.3) ** 2
        m2 = m1 + _q(p2, 0.02) - 3.0 + 20 * (f_occ - 0.6) ** 2
        ms = m2 + _q(ps, 0.03) - 2.0 + 30 * (s_lam - 0.2) ** 2 + 10 * (s_occ - 0.7) ** 2
        mse = {"flt1": m1, "flt2": m2, "smo1": ms}
        psnr = {k: 10 * np.log10(255.0 ** 2 / v) for k, v in mse.items()}
        return self.module.TrialResult(sigma, p1, p2, ps, mse, psnr)


def _run_both(monkeypatch, tmp_path, driver, *args, **kw):
    """Run ``driver`` of each package with the stub (the port's with
    device="cpu"); (JAX's, the port's), each as (return value, evaluate
    calls, table text)."""
    out = []
    for pkg, module, extra in (("jax", j_search, {}), ("port", search, {"device": "cpu"})):
        stub = Stub(pkg, module)
        monkeypatch.setattr(module, "evaluate", stub)
        table = tmp_path / f"{pkg}.txt"
        table.unlink(missing_ok=True)
        ret = getattr(module, driver)([np.zeros((2, 8, 8, 1), np.float32)], SIGMA, *args,
                                      table_path=str(table), **kw, **extra)
        out.append((ret, stub.calls, table.read_text()))
    return out


def _trial(r):
    return (r.sigma, *(dataclasses.astuple(p) for p in (r.p1, r.p2, r.ps)),
            r.mse, r.psnr)


@pytest.mark.parametrize("fields,max_rounds", [
    (("f1_nx", "f1_nt", "f1_ntagg", "f2_nx", "f2_nt", "s1_nt"), 3),
    (("s1_nt",), 1),
    (("f1_ntagg", "f2_nx"), 2),
])
def test_coordinate_descent_matches_jax(monkeypatch, tmp_path, fields, max_rounds):
    (jr, jcalls, jtab), (pr, pcalls, ptab) = _run_both(
        monkeypatch, tmp_path, "coordinate_descent", fields=fields, max_rounds=max_rounds)
    assert pcalls == jcalls and len(pcalls) > 3
    assert ptab == jtab
    (jbest, jhist), (pbest, phist) = jr, pr
    assert _trial(pbest) == _trial(jbest)
    assert [_trial(r) for r in phist] == [_trial(r) for r in jhist]


@pytest.mark.parametrize("field,values", [
    ("s1_bt", [1.0, 2.5, 4.0]), ("f1_nx", [5, 10, 15]), ("f2_bx", [0.5, 3.0]),
    ("s1_nt", [10, 60])])
def test_line_search_matches_jax(monkeypatch, tmp_path, field, values):
    (jr, jcalls, jtab), (pr, pcalls, ptab) = _run_both(
        monkeypatch, tmp_path, "line_search", field, values)
    assert pcalls == jcalls and len(pcalls) == len(values)
    assert ptab == jtab
    assert [(v, _trial(r)) for v, r in pr] == [(v, _trial(r)) for v, r in jr]


@pytest.mark.parametrize("fields,n_iters", [
    (("f1_bx", "f1_bt", "f2_bx", "f2_bt", "s1_bt"), 3), (("f1_bx", "s1_bt"), 1)])
def test_gradient_descent_matches_jax(monkeypatch, tmp_path, fields, n_iters):
    (jr, jcalls, jtab), (pr, pcalls, ptab) = _run_both(
        monkeypatch, tmp_path, "gradient_descent", fields=fields, n_iters=n_iters)
    assert pcalls == jcalls and len(pcalls) == n_iters * (len(fields) + 1)
    assert ptab == jtab
    (jhist, jbetas), (phist, pbetas) = jr, pr
    assert [_trial(r) for r in phist] == [_trial(r) for r in jhist]
    assert pbetas == jbetas


@pytest.mark.parametrize("field_a,values_a,field_b,values_b", [
    ("fflow_lambda", [0.15, 0.3], "f1_bx", [2.0, 3.0]),       # filtering flow
    ("sflow_occ", [0.5, 0.9], "s1_bt", [2.0, 4.0]),           # smoothing flow
    ("fflow_lambda", [0.2, 0.35], "sflow_lambda", [0.1, 0.25]),  # both
    ("fflow_occ", [0.5, 0.75], "sflow_occ", [0.6]),           # both, thresholds
    ("f1_bx", [2.0, 3.5], "s1_bt", [1.5, 3.0]),               # neither
    ("fflow_fscale", [0, 1], "sflow_lambda", [0.2]),          # a static field
])
def test_grid_search_2d_matches_jax(monkeypatch, tmp_path, field_a, values_a, field_b,
                                    values_b):
    (jr, jcalls, jtab), (pr, pcalls, ptab) = _run_both(
        monkeypatch, tmp_path, "grid_search_2d", field_a, values_a, field_b, values_b)
    # the same points, effective flow settings and overrides, call by call
    assert pcalls == jcalls and len(pcalls) == len(values_a) * len(values_b)
    assert ptab == jtab
    assert [(k, _trial(r)) for k, r in pr] == [(k, _trial(r)) for k, r in jr]
    # a filtering-flow override never reaches the smoothing flow
    if field_a.startswith("fflow_") and not field_b.startswith("sflow_"):
        assert all(c[3] == {} for c in pcalls)


@pytest.mark.parametrize("respect_lambda", [False, True])
def test_random_search_draws_match_jax(monkeypatch, tmp_path, respect_lambda):
    """The same numpy draws (each package's default default_rng(0)) in the
    same order, the same sort."""
    (jr, jcalls, jtab), (pr, pcalls, ptab) = _run_both(
        monkeypatch, tmp_path, "random_search", 6, respect_lambda=respect_lambda)
    assert pcalls == jcalls and ptab == jtab
    assert [_trial(r) for r in pr] == [_trial(r) for r in jr]


def _scene(t=3, h=32, w=40, seed=5):
    rng = np.random.default_rng(seed)
    base = np.cumsum(np.cumsum(rng.normal(size=(h + 2 * t, w + 2 * t)), 0), 1)
    base = (base - base.min()) / (base.max() - base.min()) * 200 + 20
    return np.stack([base[i: i + h, 2 * i: 2 * i + w] for i in range(t)])[..., None] \
        .astype(np.float32)


def _row_params(r):
    return [r.sigma, r.p1.npatches_x, r.p1.beta_x, r.p1.npatches_t, r.p1.npatches_tagg,
            r.p1.beta_t, r.p2.npatches_x, r.p2.beta_x, r.p2.npatches_t,
            r.p2.npatches_tagg, r.p2.beta_t, r.ps.npatches_t, r.ps.beta_t]


@pytest.mark.parametrize("driver", ["coordinate_descent", "line_search",
                                    "gradient_descent", "grid_search_2d"])
def test_driver_runs_on_cpu(tmp_path, driver):
    """One real run of each driver, port only, on a 32x40 3-frame clip:
    finite MSEs that denoise, and every table row parses back to the
    parameters that ran."""
    clean = [_scene()]
    table = tmp_path / "t.txt"
    kw = dict(table_path=str(table), device="cpu", first_frame=1)
    if driver == "coordinate_descent":
        best, trials = search.coordinate_descent(clean, SIGMA, fields=("s1_nt",),
                                                 max_rounds=1, **kw)
        trials = trials[1:]          # the start point writes no row
    elif driver == "line_search":
        trials = [r for _, r in search.line_search(clean, SIGMA, "s1_bt", [1.0, 3.0], **kw)]
    elif driver == "gradient_descent":
        hist, betas = search.gradient_descent(clean, SIGMA, fields=("f1_bx",), n_iters=1,
                                              **kw)
        trials = hist
        assert np.isfinite(betas["f1_bx"])
    else:
        trials = [r for _, r in search.grid_search_2d(clean, SIGMA, "fflow_lambda", [0.2],
                                                      "f1_bx", [2.0, 3.0], **kw)]
    rows = view_results.load_table(str(table))
    assert rows.shape == (len(trials), 16)
    noisy_psnr = 10 * np.log10(255.0 ** 2 / SIGMA ** 2)
    for r in trials:
        assert all(np.isfinite(v) for v in r.mse.values())
        assert r.psnr["smo1"] > noisy_psnr + 3
    # rows in the order written; sorted results carry the same set
    written = sorted(map(tuple, rows[:, :13].tolist()))
    ran = sorted(tuple(_row_params(r)) for r in trials)
    np.testing.assert_allclose(written, ran, atol=5e-4)


def _table(tmp_path):
    """A results table of format_table_row rows at two sigmas, with a header
    and a malformed line for the parser to skip."""
    rng = np.random.default_rng(11)
    p = tmp_path / "results.txt"
    lines = ["sigma f1_nx f1_bx ... (header)", "20 1 2 3"]
    for i in range(40):
        sigma = (10.0, 20.0)[i % 2]
        base = j_search.default_params(sigma, j_search.FilterMode.FLT1)
        p1 = dataclasses.replace(base, npatches_x=int(rng.integers(1, 99)),
                                 beta_x=float(rng.uniform(0, 8)))
        p2 = j_search.default_params(sigma, j_search.FilterMode.FLT2)
        ps = dataclasses.replace(j_search.default_params(sigma, j_search.FilterMode.SMO1),
                                 beta_t=float(rng.uniform(1, 6)))
        mse = {k: float(rng.uniform(5, 60)) for k in ("flt1", "flt2", "smo1")}
        lines.append(j_search.format_table_row(
            j_search.TrialResult(sigma, p1, p2, ps, mse, {})))
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def test_format_table_row_matches_jax():
    for sigma, nx, bx in ((20.0, 98, 7.999), (5.0, 1, 0.0), (40.0, 150, 12.3456)):
        jp = dataclasses.replace(j_search.default_params(sigma, j_search.FilterMode.FLT1),
                                 npatches_x=nx, beta_x=bx)
        pp = dataclasses.replace(search.default_params(sigma, search.FilterMode.FLT1),
                                 npatches_x=nx, beta_x=bx)
        mse = {"flt1": 12.345678, "flt2": 1234.5, "smo1": float("nan")}
        assert search.format_table_row(search.TrialResult(sigma, pp, pp, pp, mse, {})) == \
            j_search.format_table_row(j_search.TrialResult(sigma, jp, jp, jp, mse, {}))


@pytest.mark.parametrize("objective", ["f1_mse", "f2_mse", "s1_mse"])
def test_view_results_match_jax(tmp_path, objective):
    path = _table(tmp_path)
    t, jt = view_results.load_table(path), j_view.load_table(path)
    assert t.shape == (40, 16)
    np.testing.assert_array_equal(t, jt)
    for (s, row, psnr), (js, jrow, jpsnr) in zip(view_results.best_rows(t, objective),
                                                 j_view.best_rows(jt, objective),
                                                 strict=True):
        assert (s, psnr) == (js, jpsnr)
        np.testing.assert_array_equal(row, jrow)
    for x, y, sigma in (("f1_nx", "f1_bx", None), ("f1_bx", "s1_bt", 20.0),
                        ("s1_bt", "f1_nx", 7.0)):
        assert view_results.ascii_landscape(t, x, y, objective, sigma) == \
            j_view.ascii_landscape(jt, x, y, objective, sigma)
    argv = [path, "--objective", objective, "--landscape", "f1_nx", "s1_bt"]
    outs = []
    for main in (view_results.main, j_view.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "40 trials" in outs[0]


def test_harness_runs_on_the_card_by_default():
    """Without a device argument the harness asks for the card: on a machine
    without one it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from bwd_nlkalman_tpu_torch.train import fixtures

    clean = _scene()
    p = [search.default_params(SIGMA, m) for m in search.FilterMode]
    for call in (lambda: fixtures.make_fixtures(clean, SIGMA, [0, 1, 2]),
                 lambda: search.evaluate([clean], SIGMA, *p),
                 lambda: search.random_search([clean], SIGMA, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_harness_never_imports_jax(tmp_path):
    """A CPU run of the fixtures, a search, view_results and the plambda
    command loads neither JAX nor any module of the JAX package."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys, numpy as np\n"
        "from bwd_nlkalman_tpu_torch.train import (cached_fixtures, random_search,"
        " load_table, best_rows)\n"
        "from bwd_nlkalman_tpu_torch.cli import plambda\n"
        "from bwd_nlkalman_tpu_torch.utils import imprintf\n"
        "rng = np.random.default_rng(0)\n"
        "clean = rng.uniform(0, 255, (3, 24, 32, 1)).astype(np.float32)\n"
        "d = sys.argv[1]\n"
        "fx = cached_fixtures(d, 'c', clean, 20.0, [0, 1, 2], device='cpu')\n"
        "res = random_search([clean], 20.0, 1, fixtures=[fx], first_frame=1,"
        " table_path=d + '/t.txt', device='cpu')\n"
        "assert best_rows(load_table(d + '/t.txt'), 'f2_mse')\n"
        "assert plambda.main(['-c', '255', str(res[0].mse['flt2']), 'sqrt', '/',"
        " 'log10', '20', '*']) == 0\n"
        "imprintf('%v', clean[0])\n"
        "bad = [m for m in sys.modules if m in ('jax', 'bwd_nlkalman_tpu')"
        " or m.startswith(('jax.', 'bwd_nlkalman_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=repo), cwd=repo,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
