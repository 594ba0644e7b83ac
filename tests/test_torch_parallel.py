"""The port's row-sharded passes (``bwd_nlkalman_tpu_torch.parallel``)
against the JAX package's, on the CPU.

The port's mesh is ``make_mesh(1, 4, ["cpu"] * 4)``: one process, four
shards on the CPU with the same halo exchange as across cards. JAX's is
its 4-device virtual CPU mesh (tests/conftest.py). The inputs and
``PRMS`` are those of ``tests/test_parallel.py``, made with numpy from a
seed, and so is its bar (rtol 1e-4, atol 2e-3: the sharded fold sums in
another order than the whole frame's). K1's sharded arguments on the
card are held in ``tests/test_torch_kernels_cuda.py``.
"""

import ast
import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bwd_nlkalman_tpu import parallel as j_par
from bwd_nlkalman_tpu.core.engine import dense_pass_v2 as j_dense_pass_v2
from bwd_nlkalman_tpu.params import NLKParams as JNLKParams
from bwd_nlkalman_tpu.parallel.spatial import _spatial_pass as j_spatial_pass
from bwd_nlkalman_tpu_torch import parallel
from bwd_nlkalman_tpu_torch.core import nlkalman_filter_frame, nlkalman_smooth_frame
from bwd_nlkalman_tpu_torch.core.engine import dense_pass_v2, nlk_bases
from bwd_nlkalman_tpu_torch.ops.bases import make_bases
from bwd_nlkalman_tpu_torch.params import FilterMode, NLKParams, default_params
from bwd_nlkalman_tpu_torch.parallel.spatial import _shard_bases, _spatial_pass, shard_halo

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 2e-3
SIGMA = 15.0
PRMS = NLKParams(patch_sz=8, search_sz_x=6, search_sz_t=3, npatches_x=12,
                 npatches_t=8, npatches_tagg=4, dista_lambda=1.0, beta_x=3.0,
                 beta_t=2.0)
SPRMS = NLKParams(patch_sz=8, search_sz_x=0, search_sz_t=3, npatches_x=0,
                  npatches_t=8, npatches_tagg=8, dista_lambda=1.0, beta_x=0.0,
                  beta_t=4.0)
H, W = 96, 64
PKG = pathlib.Path(parallel.__file__).parent


def _j(p: NLKParams) -> JNLKParams:
    return JNLKParams(**dataclasses.asdict(p))


def _frame(rng, h=H, w=W, c=1):
    """tests/test_parallel.py's frame: a smooth pattern + noise."""
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 100 + 60 * np.sin(0.11 * xx) * np.cos(0.13 * yy)
    return (base[..., None].repeat(c, -1) + 15 * rng.standard_normal((h, w, c))).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _inputs():
    """noisy, prev (noisy + noise), validity with an invalid region, and a
    basic estimate, (96, 64); one draw serves every test."""
    rng = np.random.default_rng(0)
    noisy = _frame(rng)
    prev = noisy + 3 * rng.standard_normal(noisy.shape).astype(np.float32)
    valid = np.ones((H, W), bool)
    valid[40:50, 10:30] = False
    basic = noisy + 2 * rng.standard_normal(noisy.shape).astype(np.float32)
    return noisy, prev, valid, basic


@pytest.fixture(scope="module")
def j_mesh4():
    return j_par.make_mesh(dp=1, sp=4, devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def mesh4():
    return parallel.make_mesh(1, 4, ["cpu"] * 4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------- (1) the plain pass's arguments
def _extended_block(x, idx, block, halo):
    """Rows [idx*block - halo, (idx+1)*block + halo) of x, zeros off the frame:
    what shard idx of the sharded path holds."""
    out = np.zeros((block + 2 * halo,) + x.shape[1:], x.dtype)
    lo, hi = idx * block - halo, (idx + 1) * block + halo
    out[max(lo, 0) - lo: min(hi, x.shape[0]) - lo] = x[max(lo, 0): min(hi, x.shape[0])]
    return out


PASSES = {"filter spatial": ("filter", False, False),
          "filter prev basic": ("filter", True, True),
          "smoother": ("smooth", True, False)}


@pytest.mark.parametrize("idx", [0, 1, 3], ids=["edge0", "interior1", "edge3"])
@pytest.mark.parametrize("kind", list(PASSES))
def test_plain_pass_shard_arguments_match_jax(kind, idx):
    """The port's plain ``dense_pass_v2`` with ``site_rows``, ``qy_bounds``
    and ``return_accum`` against JAX's ``dense_pass_v2`` with the same
    arguments, on shard ``idx`` of 4 of a 96x64 frame (its halo-extended
    block, as the sharded path builds it)."""
    mode, has_prev, has_basic = PASSES[kind]
    prms = SPRMS if mode == "smooth" else PRMS
    noisy, prev, valid, basic = _inputs()
    step, block, halo = prms.patch_sz // 2, H // 4, shard_halo(prms, mode)
    ext = functools.partial(_extended_block, idx=idx, block=block, halo=halo)
    cur_e = ext(noisy)
    prev_e = ext(np.where(valid[..., None], prev, 0.0).astype(np.float32)) if has_prev \
        else np.zeros_like(cur_e)
    val_e = ext(valid) if has_prev else np.zeros(cur_e.shape[:2], bool)
    basic_e = ext(basic) if has_basic else cur_e
    g0, hh_g = idx * block, H - prms.patch_sz + 1
    site_rows = (halo // step, (halo + block) // step)
    qy = (halo - g0, hh_g + halo - g0)
    j_out, j_agg = j_dense_pass_v2(
        jnp.asarray(cur_e), jnp.asarray(prev_e), jnp.asarray(val_e), jnp.asarray(basic_e),
        SIGMA, _j(prms), mode, has_prev, has_basic, site_rows=site_rows,
        qy_bounds=jnp.asarray(qy, jnp.int32), return_accum=True)
    out, agg = dense_pass_v2(_t(cur_e), _t(prev_e), _t(val_e), _t(basic_e), SIGMA, prms,
                             mode, has_prev, has_basic, site_rows=site_rows,
                             qy_bounds=qy, return_accum=True)
    j_out, j_agg = np.asarray(j_out), np.asarray(j_agg)
    assert float(j_agg.max()) > 0.0
    # the sums are scaled by the weights (1 / group variance): compare
    # them relative to their own size
    np.testing.assert_allclose(agg.numpy(), j_agg, rtol=RTOL, atol=1e-4 * j_agg.max())
    np.testing.assert_allclose(out.numpy(), j_out, rtol=RTOL,
                               atol=1e-4 * np.abs(j_out).max())
    # rows no member of an owned site covers hold nothing
    rad = prms.search_sz_t if mode == "smooth" else max(prms.search_sz_x, prms.search_sz_t)
    own = slice(halo - rad, halo + block - step + rad + prms.patch_sz)
    assert float(agg[:own.start].abs().max()) == 0.0
    assert float(agg[own.stop:].abs().max()) == 0.0


# ------------------------------------------------ (2) the sharded frame passes
FRAME_CASES = ["spatial", "temporal invalid region", "temporal basic", "smoother"]


def _frame_case(name, xp):
    """(kind, args) of a frame case, arrays made by ``xp`` (jnp.asarray or _t)."""
    noisy, prev, valid, basic = _inputs()
    if name == "spatial":
        return "filter", (xp(noisy), None, None, None, SIGMA, PRMS)
    if name == "temporal invalid region":
        return "filter", (xp(noisy), xp(prev), xp(valid), None, SIGMA, PRMS)
    if name == "temporal basic":
        return "filter", (xp(noisy), xp(prev), xp(valid), xp(basic), SIGMA, PRMS)
    # the smoother's case of tests/test_parallel.py: the first 9 rows invalid
    sval = np.ones((H, W), bool)
    sval[:9, :] = False
    return "smooth", (xp(noisy), xp(prev), xp(sval), SIGMA, SPRMS)


@pytest.mark.parametrize("name", FRAME_CASES)
def test_spatial_frame_passes_match_jax(name, mesh4, j_mesh4):
    """``spatial_filter_frame`` / ``spatial_smooth_frame`` on four CPU
    shards against JAX's on its 4-device mesh, and against the port's own
    whole-frame pass, at tests/test_parallel.py's bar."""
    kind, args = _frame_case(name, _t)
    _, j_args = _frame_case(name, jnp.asarray)
    if kind == "filter":
        got = parallel.spatial_filter_frame(*args, mesh4)
        j_got = j_par.spatial_filter_frame(*j_args[:5], _j(PRMS), j_mesh4)
        whole = nlkalman_filter_frame(*args)
    else:
        got = parallel.spatial_smooth_frame(*args, mesh4)
        j_got = j_par.spatial_smooth_frame(*j_args[:4], _j(SPRMS), j_mesh4)
        whole = nlkalman_smooth_frame(*args)
    assert got.shape == (H, W, 1) and got.device == torch.device("cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(j_got), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=RTOL, atol=ATOL)


# ----------------------------------------------------- (3) the sharded step
def test_sharded_filter_step_matches_jax():
    """``sharded_filter_step`` on dp=2 x sp=2 against JAX's on (2, 96, 64, 1),
    along a smooth nonzero flow with an occlusion mask, both made with
    numpy from a seed, at the default parameters of sigma 20."""
    rng = np.random.default_rng(3)
    noisy = np.stack([_frame(rng), _frame(rng)])
    flt1 = noisy + 4 * rng.standard_normal(noisy.shape).astype(np.float32)
    flt2 = noisy + 2 * rng.standard_normal(noisy.shape).astype(np.float32)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    flow = np.stack([np.stack([1.3 + 0.8 * np.sin(0.05 * yy + b),
                               -0.7 + 0.6 * np.cos(0.07 * xx - b)], -1)
                     for b in (0.0, 1.0)]).astype(np.float32)
    occ = np.where(rng.uniform(size=(2, H, W)) < 0.05, 255.0, 0.0).astype(np.float32)
    p1, p2 = default_params(20.0, FilterMode.FLT1), default_params(20.0, FilterMode.FLT2)

    step = parallel.sharded_filter_step(parallel.make_mesh(2, 2, ["cpu"] * 4), 20.0, p1, p2)
    f1, f2 = step(*map(_t, (noisy, flt1, flt2, flow, occ)))
    j_step = j_par.sharded_filter_step(
        j_par.make_mesh(dp=2, sp=2, devices=jax.devices()[:4]), 20.0, _j(p1), _j(p2))
    j_f1, j_f2 = j_step(*map(jnp.asarray, (noisy, flt1, flt2, flow, occ)))
    assert f1.shape == f2.shape == noisy.shape
    np.testing.assert_allclose(f1.numpy(), np.asarray(j_f1), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(f2.numpy(), np.asarray(j_f2), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------- (4) the refusals
PROD = default_params(20.0, FilterMode.FLT1)   # search 10/5, psz 8: a 20-row halo


def _refusal(case):
    """(mesh sizes (dp, sp, n devices), frame shape, params): one of the
    layouts JAX's sharded passes refuse."""
    return {
        "dp*sp != n": ((2, 2, 3), None, PRMS),
        "H % sp": ((1, 4, 4), (90, W, 1), PRMS),
        "block % step": ((1, 4, 4), (88, W, 1), PRMS),
        "block < halo": ((1, 4, 4), (64, W, 1), PROD),
        "B % dp": ((2, 2, 4), (3, H, W, 1), PRMS),
    }[case]


@pytest.mark.parametrize("case", ["dp*sp != n", "H % sp", "block % step", "block < halo",
                                  "B % dp"])
def test_refusals_match_jax(case):
    """Each ValueError of JAX's mesh and sharded pass is raised by the port
    on the same layout."""
    (dp, sp, n), shape, prms = _refusal(case)
    if shape is None:
        with pytest.raises(ValueError, match="dp\\*sp"):
            j_par.make_mesh(dp=dp, sp=sp, devices=jax.devices()[:n])
        with pytest.raises(ValueError, match="dp\\*sp"):
            parallel.make_mesh(dp, sp, ["cpu"] * n)
        return
    x = np.zeros(shape, np.float32)
    v = np.zeros(shape[:-1], bool)
    j_mesh = j_par.make_mesh(dp=dp, sp=sp, devices=jax.devices()[:n])
    with pytest.raises(ValueError) as j_err:
        j_spatial_pass(jnp.asarray(x), jnp.asarray(x), jnp.asarray(v), jnp.asarray(x),
                       SIGMA, _j(prms), "filter", False, False, j_mesh, 256)
    with pytest.raises(ValueError) as err:
        _spatial_pass(_t(x), _t(x), _t(v), _t(x), SIGMA, prms, "filter", False, False,
                      parallel.make_mesh(dp, sp, ["cpu"] * n))
    assert str(err.value) == str(j_err.value)


# ------------------------------------------------------- (5) mesh and imports
def test_make_mesh_needs_a_card_by_default():
    """With no devices given, the mesh is every CUDA device; none raises
    (there is no CPU fallback). A given list may repeat a device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh()
    mesh = parallel.make_mesh(2, None, ["cpu"] * 4)
    assert mesh.shape == {"dp": 2, "sp": 2}
    assert mesh.first == torch.device("cpu")


def test_shard_constants_reuse_the_callers():
    """A pass's shards on the caller's ``bases`` device take that dict; with
    none given, one is built for the call on each shard device."""
    cpu = torch.device("cpu")
    bases = make_bases(nlk_bases(8), cpu)
    got = _shard_bases(bases, [cpu] * 4, 8)
    assert list(got) == [cpu] and got[cpu] is bases
    built = _shard_bases(None, [cpu] * 2, 8)[cpu]
    assert built.keys() == bases.keys()


def test_no_chunk_sites_argument(mesh4):
    """JAX's ``chunk_sites`` (a memory knob of its plain pass) has no
    counterpart: the arguments after the mesh are keywords, so a positional
    value is refused rather than dropped."""
    _, args = _frame_case("spatial", _t)
    with pytest.raises(TypeError):
        parallel.spatial_filter_frame(*args, mesh4, 256)


def test_parallel_imports_no_jax():
    """No module of the port's parallel package imports JAX or the JAX package."""
    for path in sorted(PKG.glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "bwd_nlkalman_tpu"), (path.name, name)
