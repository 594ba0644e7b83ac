"""The port's training harness against the JAX package's, on the CPU.

One set of JAX fixtures (``cached_fixtures`` on a 24x32 gray scene, T=4,
sigma=20) serves the whole module. The JAX drivers run in the dynamic
form JAX's ``evaluate(dynamic=True)`` uses, so one compile of each serves
every trial here. Bars: the precomputed drivers 0.01 dB of PSNR per
frame; ``evaluate`` and ``random_search`` 0.05 dB per stage, with the
same sampled parameters; the port's own fixtures with bit-identical
noise, flows within a mean end-point error of 1e-3 px at the XLA path's
stopping granularity (``_k_check`` monkeypatched to 10, as
tests/test_torch_pipeline.py does) and masks that differ at no more than
0.5% of the pixels; either package reads the other's cache exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu import params as j_params
from bwd_nlkalman_tpu.pipeline import sequence as j_seq
from bwd_nlkalman_tpu.train import fixtures as j_fixtures
from bwd_nlkalman_tpu.train import search as j_search
from bwd_nlkalman_tpu_torch.flow import tvl1
from bwd_nlkalman_tpu_torch.params import FilterMode, default_params
from bwd_nlkalman_tpu_torch.pipeline import sequence as seq
from bwd_nlkalman_tpu_torch.train import fixtures, search

torch.set_num_threads(1)
SIGMA = 20.0
T, H, W = 4, 24, 32
SEEDS = list(range(T))
EVAL = dict(first_frame=1, border=2)   # a 4-frame clip: PSNR from frame 1


def _scene(t, h, w, c, rng):
    """Slowly translating smooth texture (tests/test_round3.py:18-24)."""
    base = np.cumsum(np.cumsum(rng.normal(size=(h + 2 * t, w + 2 * t, c)), 0), 1)
    base = (base - base.min()) / (base.max() - base.min()) * 200 + 20
    return np.stack(
        [base[2 * i: 2 * i + h, i: i + w] for i in range(t)]
    ).astype(np.float32)


@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """(clean, cache dir, JAX fixtures) written by JAX's cached_fixtures."""
    clean = _scene(T, H, W, 1, np.random.default_rng(7))
    d = str(tmp_path_factory.mktemp("jax_fixtures"))
    return clean, d, j_fixtures.cached_fixtures(d, "toy", clean, SIGMA, SEEDS)


@pytest.fixture
def xla_granularity(monkeypatch):
    monkeypatch.setattr(tvl1, "_k_check", lambda npx: 10)


def _j_params(p):
    return j_params.NLKParams(**dataclasses.asdict(p))


def _defaults():
    return tuple(default_params(SIGMA, m)
                 for m in (FilterMode.FLT1, FilterMode.FLT2, FilterMode.SMO1))


def _frame_psnr(clean, x):
    d = np.asarray(x, np.float64) - clean
    return 10 * np.log10(255.0 ** 2 / np.mean(d * d, axis=(1, 2, 3)))


def _jax_drivers(fx, p1, p2, ps):
    """JAX's precomputed drivers as evaluate(dynamic=True) calls them, so
    that the compile serves the evaluate tests too."""
    k1, d1 = j_search._dyn_split(_j_params(p1))
    k2, d2 = j_search._dyn_split(_j_params(p2))
    ks, ds = j_search._dyn_split(_j_params(ps))
    flt1, flt2 = j_seq.filter_sequence_precomputed(
        jnp.asarray(fx.noisy), jnp.asarray(fx.bflow), jnp.asarray(fx.bocc), SIGMA,
        k1, k2, dyn1=d1, dyn2=d2)
    smo1 = j_seq.smooth_sequence_precomputed(
        flt2, jnp.asarray(fx.fflow), jnp.asarray(fx.focc), SIGMA, ks, dyns=ds)
    return tuple(np.asarray(x) for x in (flt1, flt2, smo1))


def test_precomputed_drivers_match_jax(jax_cache):
    clean, _, jfx = jax_cache
    p1, p2, ps = _defaults()
    want = _jax_drivers(jfx, p1, p2, ps)
    flt1, flt2 = seq.filter_sequence_precomputed(
        torch.from_numpy(jfx.noisy), torch.from_numpy(jfx.bflow),
        torch.from_numpy(jfx.bocc), SIGMA, p1, p2)
    smo1 = seq.smooth_sequence_precomputed(
        flt2, torch.from_numpy(jfx.fflow), torch.from_numpy(jfx.focc), SIGMA, ps)
    for name, got, ref in zip(("flt1", "flt2", "smo1"), (flt1, flt2, smo1), want):
        assert got.shape == ref.shape and torch.isfinite(got).all()
        d_psnr = np.abs(_frame_psnr(clean, got.numpy()) - _frame_psnr(clean, ref))
        gap = float(np.abs(got.numpy() - ref).max())
        assert d_psnr.max() <= 0.01, f"{name}: per-frame |dPSNR| {d_psnr}, max abs {gap}"
    # frame 0 is the spatial-only pass pair, with no prior
    f11, f21 = seq.filter_frame_pair(torch.from_numpy(jfx.noisy[0]), None, None,
                                     SIGMA, p1, p2)
    assert torch.equal(flt1[0], f11) and torch.equal(flt2[0], f21)


def test_precomputed_drivers_take_the_stored_mask(jax_cache, monkeypatch):
    """The drivers warp with bocc[t] / focc[t] as given: no mask is rebuilt
    from the flow (an all-occluded mask leaves no valid prior)."""
    _, _, jfx = jax_cache
    monkeypatch.setattr(seq, "occlusion_mask", None)   # would raise if called
    seen = []
    warp = seq.warp_bicubic_nan
    monkeypatch.setattr(seq, "warp_bicubic_nan",
                        lambda im, flow, occ, engine: seen.append(occ) or
                        warp(im, flow, occ, engine=engine))
    occ = torch.full((T, H, W), 255.0)
    p1, p2, ps = _defaults()
    _, flt2 = seq.filter_sequence_precomputed(
        torch.from_numpy(jfx.noisy), torch.from_numpy(jfx.bflow), occ, SIGMA, p1, p2)
    seq.smooth_sequence_precomputed(flt2, torch.from_numpy(jfx.fflow), occ, SIGMA, ps)
    # the filter warps frames 1..T-1, the smoother frames T-2..0, each with
    # its own frame's slice of the stored mask
    order = list(range(1, T)) + list(range(T - 2, -1, -1))
    assert [m.data_ptr() for m in seen] == [occ[t].data_ptr() for t in order]


def _dev_params():
    """The defaults, and group sizes above the window's candidate count:
    121 temporal candidates (search_sz_t 5) and 20 spatial ones at most."""
    p1, p2, ps = _defaults()
    big = (dataclasses.replace(p1, npatches_t=150, npatches_x=130, npatches_tagg=20),
           p2, dataclasses.replace(ps, npatches_t=150, npatches_tagg=20))
    return {"defaults": (p1, p2, ps), "k above the candidates": big}


@pytest.mark.parametrize("case", ["defaults", "k above the candidates"])
def test_evaluate_on_fixtures_matches_jax(jax_cache, case):
    clean, _, jfx = jax_cache
    p1, p2, ps = _dev_params()[case]
    if case != "defaults":
        rad = p1.search_sz_t
        assert p1.npatches_t > (2 * rad + 1) ** 2 and ps.npatches_t > (2 * rad + 1) ** 2
    want = j_search.evaluate([clean], SIGMA, *(_j_params(p) for p in (p1, p2, ps)),
                             fixtures=[jfx], dynamic=True, **EVAL)
    got = search.evaluate([clean], SIGMA, p1, p2, ps, fixtures=[jfx], device="cpu",
                          **EVAL)
    for k in ("flt1", "flt2", "smo1"):
        assert abs(got.psnr[k] - want.psnr[k]) <= 0.05, (k, got.psnr, want.psnr)
    assert got.psnr["smo1"] > 10 * np.log10(255.0 ** 2 / SIGMA ** 2) + 4


def test_zero_gain_corner_copies_the_input():
    """Random search's corner np 1, beta_x 0: a site with no previous patch
    keeps one member, so its spatial gain and weight are 0/0. Both passes
    copy the input under that member; JAX's XLA pass also spreads NaN over
    the site's whole window (its dense aggregation weighs every offset,
    0 x NaN), where the port's plain pass (and K1, which follows it) keeps
    the other sites' estimates. Elsewhere the two agree exactly."""
    from bwd_nlkalman_tpu.core import engine as j_engine
    from bwd_nlkalman_tpu_torch.core.engine import dense_pass_v2
    from bwd_nlkalman_tpu_torch.tools.k1_bench import nlk_inputs, search_cases

    name, mode, has_prev, has_basic, p = search_cases()[0]
    assert name == "npx 1" and p.beta_x == 0.0
    cur, prev, valid, _ = nlk_inputs(np.random.default_rng(40), 32, 40, 1)
    want = np.asarray(j_engine.dense_pass_v2(
        *(jnp.asarray(a) for a in (cur, prev, valid, cur)), SIGMA, _j_params(p), mode,
        has_prev, has_basic))
    got = dense_pass_v2(*(torch.from_numpy(a) for a in (cur, prev, valid, cur)), SIGMA, p,
                        mode, has_prev, has_basic).numpy()
    nan = np.isnan(want)
    assert nan.any() and np.isfinite(got).all()
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert (got == cur).any()


def test_random_search_on_fixtures_matches_jax(jax_cache, tmp_path):
    clean, _, jfx = jax_cache
    want = j_search.random_search([clean], SIGMA, 2, rng=np.random.default_rng(0),
                                  fixtures=[jfx], first_frame=1)
    table = str(tmp_path / "t.txt")
    got = search.random_search([clean], SIGMA, 2, rng=np.random.default_rng(0),
                               fixtures=[jfx], first_frame=1, device="cpu",
                               table_path=table)
    key = lambda r: dataclasses.astuple(r.p1)  # noqa: E731
    assert sorted(map(key, got)) == sorted(map(key, want))
    ref = {key(r): r for r in want}
    for r in got:
        psnr = lambda m: 10 * np.log10(255.0 ** 2 / m)  # noqa: E731
        assert abs(psnr(r.mse["flt1"]) - psnr(ref[key(r)].mse["flt1"])) <= 0.05
        assert abs(psnr(r.mse["flt2"]) - psnr(ref[key(r)].mse["flt2"])) <= 0.05
        assert np.isnan(r.mse["smo1"])
    assert len(open(table).read().splitlines()) == 2


def test_make_fixtures_matches_jax(jax_cache, xla_granularity):
    clean, _, jfx = jax_cache
    fx = fixtures.make_fixtures(clean, SIGMA, SEEDS, device="cpu")
    np.testing.assert_array_equal(fx.noisy, jfx.noisy)
    for flow, jflow, occ, jocc in ((fx.bflow, jfx.bflow, fx.bocc, jfx.bocc),
                                   (fx.fflow, jfx.fflow, fx.focc, jfx.focc)):
        epe = float(np.mean(np.linalg.norm(flow - jflow, axis=-1)))
        assert epe <= 1e-3, epe
        assert float(np.mean(occ != jocc)) <= 0.005
        assert set(np.unique(occ)) <= {0.0, 255.0}
    # the first / last frame copies its neighbour (tvl1flow-seq.sh:43, :66)
    np.testing.assert_array_equal(fx.bflow[0], fx.bflow[1])
    np.testing.assert_array_equal(fx.focc[-1], fx.focc[-2])


def test_fixture_caches_read_across_packages(jax_cache, tmp_path, monkeypatch):
    clean, jdir, jfx = jax_cache
    assert fixtures._cache_key("toy", clean, SIGMA, SEEDS, "all", 1, 0.2, 0.75) == \
        j_fixtures._cache_key("toy", clean, SIGMA, SEEDS, "all", 1, 0.2, 0.75)
    # JAX reads the port's file
    pdir = str(tmp_path)
    mine = fixtures.cached_fixtures(pdir, "toy", clean, SIGMA, SEEDS, directions="bwd",
                                    device="cpu")
    # the port reads JAX's, and computes nothing
    monkeypatch.setattr(fixtures, "make_fixtures", None)
    got = fixtures.cached_fixtures(jdir, "toy", clean, SIGMA, SEEDS, device="cpu")
    back = j_fixtures.cached_fixtures(pdir, "toy", clean, SIGMA, SEEDS, directions="bwd")
    assert mine.fflow is None and back.fflow is None and back.focc is None
    for a, b in ((got, jfx), (back, mine)):
        for name in ("noisy", "bflow", "bocc", "fflow", "focc"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def test_fixtures_go_to_the_device_once(jax_cache, monkeypatch):
    """random_search uploads each clip's fixtures once per search; evaluate
    then finds them on the device and copies nothing."""
    clean, _, jfx = jax_cache
    calls = []
    to = fixtures.Fixtures.to
    monkeypatch.setattr(fixtures.Fixtures, "to",
                        lambda self, dev: calls.append(type(self.noisy)) or to(self, dev))
    on_dev = fixtures.Fixtures.to(jfx, "cpu")
    assert on_dev.to("cpu").noisy.data_ptr() == on_dev.noisy.data_ptr()
    calls.clear()
    search.random_search([clean], SIGMA, 3, fixtures=[jfx], first_frame=1, device="cpu")
    assert calls.count(np.ndarray) == 1 and calls.count(torch.Tensor) == 3


def test_flow_overrides_rejected_with_fixtures(jax_cache):
    clean, _, jfx = jax_cache
    p1, p2, ps = _defaults()
    with pytest.raises(ValueError, match="no effect with fixtures"):
        search.evaluate([clean], SIGMA, p1, p2, ps, fixtures=[jfx],
                        flow_dyn={"lambda_": 0.3}, device="cpu")
    with pytest.raises(ValueError, match="no effect with fixtures"):
        search.evaluate([clean], SIGMA, p1, p2, ps, fixtures=[jfx],
                        sflow_dyn={"occ_threshold": 0.5}, device="cpu")
