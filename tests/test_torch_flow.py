"""The port's TV-L1 against the JAX package's, on the same numpy inputs.

- One level: the plain version of K2 against the JAX single-scale XLA
  solver at the same convergence granularity (k_check = check_every = 8),
  with the bars the JAX suite holds its own K2 to (tests/test_round3.py):
  2e-3 after 32 iterations, 1e-5 after one.
- The whole pyramid and the warm path: by mean end-point error against
  JAX ``tvl1_flow(backend="xla")``. The granularity differs there (the
  XLA path checks convergence every 10 iterations, K2's semantics every
  8 on fine levels and 24 on coarse ones), so the iterates are not the
  same and the bar is a mean EPE of 0.05 px.
- The dispatch: a level beyond K2's plan takes the tiled solver (K3's
  path); tests/test_torch_fullres.py holds that solver to JAX.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.flow import tvl1 as j_tvl1
from bwd_nlkalman_tpu_torch.flow import tvl1, tvl1_fused, tvl1_tiled
from bwd_nlkalman_tpu_torch.flow.tvl1_fused import tvl1_level_plain

torch.set_num_threads(1)


def _smooth_base(rng, h, w, pad=8):
    base = np.cumsum(np.cumsum(rng.normal(size=(h + pad, w + pad)), 0), 1)
    return ((base - base.min()) / (base.max() - base.min()) * 255).astype(np.float32)


def _epe(a, b):
    return float(np.mean(np.linalg.norm(np.asarray(a) - np.asarray(b), axis=-1)))


@pytest.mark.parametrize("nwarps,k_check,max_iters,atol",
                         [(2, 8, 32, 2e-3), (1, 1, 1, 1e-5)])
def test_level_matches_xla_single_scale(rng, nwarps, k_check, max_iters, atol):
    h, w = 25, 41
    base = _smooth_base(rng, h, w)
    i0, i1 = base[4:4 + h, 4:4 + w], base[2:2 + h, 5:5 + w]
    u0 = np.zeros((h, w, 2), np.float32)
    ref = j_tvl1.tvl1_flow_single_scale(
        jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(u0), nwarps=nwarps,
        check_every=k_check, max_iters=max_iters)
    got = tvl1_level_plain(torch.from_numpy(i0), torch.from_numpy(i1),
                           torch.from_numpy(u0), nwarps=nwarps, k_check=k_check,
                           max_iters=max_iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol)


def _pair(rng, h=48, w=64, dx=2, dy=1):
    base = _smooth_base(rng, h, w)
    return base[4:4 + h, 4:4 + w], base[4 + dy:4 + dy + h, 4 + dx:4 + dx + w]


def test_pyramid_flow_epe(rng):
    i0, i1 = _pair(rng)
    ref, ref_fs = j_tvl1.tvl1_flow(jnp.asarray(i0), jnp.asarray(i1), fscale=1,
                                   lambda_=0.25, backend="xla", return_carry=True)
    got, got_fs = tvl1.tvl1_flow(torch.from_numpy(i0), torch.from_numpy(i1),
                                 fscale=1, lambda_=0.25, return_carry=True)
    assert got.shape == ref.shape and got_fs.shape == ref_fs.shape
    assert _epe(got, ref) <= 0.05
    assert _epe(got_fs, ref_fs) <= 0.05


@pytest.mark.parametrize("stale", [False, True])
def test_warm_flow_and_gate_epe(rng, stale):
    """Warm step from the JAX cold carry; a stale carry trips the gate and
    both take the cold pyramid."""
    i0, i1 = _pair(rng)
    _, carry = j_tvl1.tvl1_flow(jnp.asarray(i0), jnp.asarray(i1), fscale=1,
                                lambda_=0.25, backend="xla", return_carry=True)
    carry = np.array(carry)
    if stale:
        carry = -carry - 6.0
    j_i0, j_i1 = jnp.asarray(i0), jnp.asarray(i1)
    a, b = j_tvl1._prep_pair(j_i0, j_i1)
    a, b = j_tvl1.zoom_out(a, 0.5), j_tvl1.zoom_out(b, 0.5)
    j_ok = bool(j_tvl1.warm_gate_ok(a, b, jnp.asarray(carry))[0])
    assert j_ok == (not stale)
    ref, ref_fs = j_tvl1.tvl1_flow_warm(j_i0, j_i1, jnp.asarray(carry), fscale=1,
                                        lambda_=0.25, backend="xla", warm_nwarps=3)

    t0, t1 = torch.from_numpy(i0), torch.from_numpy(i1)
    pa, pb = tvl1._prep_pair(t0, t1)
    pa, pb = tvl1.zoom_out(pa, 0.5), tvl1.zoom_out(pb, 0.5)
    assert tvl1.warm_gate_ok(pa, pb, torch.from_numpy(carry)) == j_ok
    got, got_fs = tvl1.tvl1_flow_warm(t0, t1, torch.from_numpy(carry), fscale=1,
                                      lambda_=0.25, warm_nwarps=3)
    assert _epe(got, ref) <= 0.05
    assert _epe(got_fs, ref_fs) <= 0.05


def test_level_beyond_plan_raises(rng, monkeypatch):
    """A level beyond K2's plan raises nothing any more: it reaches the
    tiled solver (K3's path), as the JAX package dispatches. With the plan's
    budget patched down to a 48x64 level, only the finest level of a
    48x64 pyramid goes there; tests/test_torch_fullres.py holds the result
    to JAX."""
    budget = tvl1_fused._plan(48, 64)[2]
    monkeypatch.setattr(tvl1, "fused_level_supported",
                        lambda h, w: tvl1_fused.fused_level_supported(h, w, budget))
    tiled = []

    def record(a, *args, **kw):
        tiled.append(tuple(a.shape))
        return tvl1_tiled.tvl1_single_scale_tiled(a, *args, **kw)

    monkeypatch.setattr(tvl1, "tvl1_single_scale_tiled", record)
    i0, i1 = _pair(rng)
    got = tvl1.tvl1_flow(torch.from_numpy(i0), torch.from_numpy(i1), fscale=0,
                         lambda_=0.25)
    assert tiled == [(48, 64)]
    assert got.shape == (48, 64, 2) and torch.isfinite(got).all()


@pytest.mark.parametrize("h,w", [(12, 16), (20, 24)])
def test_fscale_past_the_coarsest_level(rng, monkeypatch, h, w):
    """Where fscale reaches the pyramid's coarsest level (small frames,
    such as a multiscale pipeline's coarse levels), no level is solved:
    the cold flow and its carry are zero, as JAX's are. The warm flow
    solves the level-fscale scale from a zero carry where the gate takes
    it (20x24), and from the zero flow when the gate refuses a stale one,
    as JAX's does (at the XLA path's check granularity, 10, so that the
    iterates are the same)."""
    base = _smooth_base(rng, h, w)
    i0, i1 = base[4:4 + h, 4:4 + w], base[3:3 + h, 5:5 + w]
    ns = tvl1.num_scales(w, h, 100, 0.5)
    want, want_fs = j_tvl1.tvl1_flow(jnp.asarray(i0), jnp.asarray(i1), fscale=ns,
                                     backend="xla", return_carry=True)
    got, got_fs = tvl1.tvl1_flow(torch.from_numpy(i0), torch.from_numpy(i1),
                                 fscale=ns, return_carry=True)
    assert got.shape == want.shape and got_fs.shape == want_fs.shape
    assert not got.any() and not np.asarray(want).any() and not got_fs.any()
    monkeypatch.setattr(tvl1, "_k_check", lambda npx: 10)
    shape = tvl1.flow_carry_shape(h, w, fscale=ns)
    for carry in (np.zeros(shape, np.float32), np.full(shape, -9.0, np.float32)):
        want, want_fs = j_tvl1.tvl1_flow_warm(jnp.asarray(i0), jnp.asarray(i1),
                                              jnp.asarray(carry), fscale=ns,
                                              backend="xla")
        got, got_fs = tvl1.tvl1_flow_warm(torch.from_numpy(i0), torch.from_numpy(i1),
                                          torch.from_numpy(carry), fscale=ns)
        assert got.shape == want.shape and got_fs.shape == want_fs.shape
        assert _epe(got, want) <= 0.05
