"""The public names of the JAX package's subpackages, in the port.

Each name the JAX package's ``flow``, ``ops``, ``core`` and ``models``
export is held against its JAX function on the same inputs, made from a
seed with numpy, at 32x40 or less. Bars, with what the CPU measured: the
flow measures equal; the TV-L1 energy rtol 1e-5; the reference's
single-scale TV-L1 at 25x41 atol 1e-5 (2.9e-6 after 2 warps of one
iteration, 2.6e-6 of 3; 9.5e-7 where it stops early: one warp tested
every 10 iterations at epsilon 0.05 stops after 30 of at most 60, the
mean squared update 2.8e-3 after 20 and 1.1e-3 after 30 against 2.5e-3,
where a test after every iteration would stop at 22, 0.54 px away, and
20 or 40 iterations are 0.68 and 0.55 px away); the windows equal; the patch DCTs atol 1e-3
on values of order 255 (1.2e-4); the whole-image DCT 2.6e-3 (8.6e-6);
the bicubic sampler 1e-4 (equal); patch validity equal. The re-exports
of ``models`` and the top-level ``params`` are the port's own objects.

Two tests read both packages' sources with ``ast`` (no JAX import): every
public name of a JAX subpackage's ``__init__.py`` is in the port's, and
every public module-level function or class of a JAX module is in the
port's module of the same path, apart from ``NOT_PORTED``, each with its
reason.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bwd_nlkalman_tpu_torch as port
from bwd_nlkalman_tpu import flow as j_flow
from bwd_nlkalman_tpu import io as j_io
from bwd_nlkalman_tpu import ops as j_ops
from bwd_nlkalman_tpu.core import nlkalman as j_nlk
from bwd_nlkalman_tpu.ops import dct as j_dct
from bwd_nlkalman_tpu_torch import flow, models, ops, pipeline
from bwd_nlkalman_tpu_torch.core import nlkalman
from bwd_nlkalman_tpu_torch.ops import dct

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "bwd_nlkalman_tpu", ROOT / "bwd_nlkalman_tpu_torch"

# name -> why the port has no counterpart
NOT_PORTED = {
    "cli/_common.py:setup_jax": "sets up JAX's platform and compilation cache",
    "core/engine.py:auto_rows_per_block": "sizes the Pallas kernel's row blocks to "
                                          "the TPU's VMEM; K1 plans its own blocks",
    "ops/dct.py:dct_image_all_patches_matmul": "default MXU precision for the TPU's bf16 "
                                               "band path; K1 computes its bands itself",
    "ops/warp.py:build_taps16": "the tap stack of the XLA gather path, a TPU workaround; "
                                "K4 gathers its taps itself",
    "core/engine_pallas.py": "the Pallas kernel K1 (csrc/nlk_pass.cu)",
    "flow/tvl1_pallas.py": "the Pallas kernel K3 (csrc/tvl1_block.cu)",
    "ops/warp_pallas.py": "the Pallas kernel K4 (csrc/warp.cu)",
}


def _rng():
    return np.random.default_rng(11)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0.0, atol=atol)


def _pair(h, w, dx=2, dy=1):
    rng = _rng()
    base = np.cumsum(np.cumsum(rng.normal(size=(h + 8, w + 8)), 0), 1)
    base = ((base - base.min()) / (base.max() - base.min()) * 255).astype(np.float32)
    return base[4:4 + h, 4:4 + w].copy(), base[4 + dy:4 + dy + h, 4 + dx:4 + dx + w].copy()


# two JAX compiles: nwarps and check_every are static there, max_iters traced
@pytest.mark.parametrize("kw", [dict(nwarps=2, check_every=1, max_iters=1),
                                dict(nwarps=2, check_every=1, max_iters=3),
                                dict(nwarps=1, check_every=10, max_iters=60, epsilon=0.05)],
                         ids=["one-iteration", "two-warps", "early-stop"])
def test_tvl1_flow_single_scale(kw):
    i0, i1 = _pair(25, 41)
    u0 = np.zeros((25, 41, 2), np.float32)
    want = j_flow.tvl1_flow_single_scale(jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(u0),
                                         **kw)
    got = flow.tvl1_flow_single_scale(torch.from_numpy(i0), torch.from_numpy(i1),
                                      torch.from_numpy(u0), **kw)
    assert got.shape == (25, 41, 2) and got.dtype == torch.float32
    _close(got, want, 1e-5)


def test_flow_energy():
    i0, i1 = _pair(32, 40)
    fl = (_rng().normal(0, 1.5, (32, 40, 2))).astype(np.float32)
    want = j_flow.flow_energy(jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(fl), 0.2)
    got = flow.flow_energy(torch.from_numpy(i0), torch.from_numpy(i1), torch.from_numpy(fl),
                           0.2)
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_flow_measures(tmp_path):
    rng = _rng()
    gt = rng.normal(0, 2, (3, 16, 20, 2)).astype(np.float32)
    gt[:, 0, 0] = 1e10                        # Middlebury's unknown
    est = gt + rng.normal(0, 0.5, gt.shape).astype(np.float32)
    for f in ("endpoint_error", "angular_error"):
        assert getattr(flow, f)(est[0], gt[0]) == getattr(j_flow, f)(est[0], gt[0])
    for t in range(3):
        j_io.write_flo(str(tmp_path / f"e{t}.flo"), est[t])
        j_io.write_flo(str(tmp_path / f"g{t}.flo"), gt[t])
    args = (str(tmp_path / "e%d.flo"), str(tmp_path / "g%d.flo"), 0, 2)
    assert flow.measure_sequence(*args) == j_flow.measure_sequence(*args)


@pytest.mark.parametrize("kind", ["parzen", "welch", "sine", "hanning", "hamming",
                                  "blackman", "gaussian", "flat"])
@pytest.mark.parametrize("n", [4, 7, 8])
def test_window_function(kind, n):
    got = ops.window_function(kind, n)
    assert got.shape == (n, n) and got.dtype == torch.float32
    _close(got, j_ops.window_function(kind, n), 0.0)
    assert ops.window_function(kind, n, torch.float64).dtype == torch.float64


@pytest.mark.parametrize("psz", [4, 8])
def test_patch_dcts(psz):
    p = _rng().uniform(0, 255, (3, 5, psz, psz)).astype(np.float32)
    flat = p.reshape(3, 5, psz * psz)
    _close(ops.patch_dct_matrix(psz), j_ops.patch_dct_matrix(psz), 0.0)
    _close(dct.patch_dct_matrix_2d(psz), j_dct.patch_dct_matrix_2d(psz), 0.0)
    for name, x in (("dct2_patches", p), ("idct2_patches", p)):
        _close(getattr(ops, name)(torch.from_numpy(x)), getattr(j_ops, name)(jnp.asarray(x)),
               1e-3)
    for name in ("dct2_flat", "idct2_flat"):
        _close(getattr(dct, name)(torch.from_numpy(flat), psz),
               getattr(j_dct, name)(jnp.asarray(flat), psz), 1e-3)
    # each inverse undoes its transform
    x = torch.from_numpy(p)
    _close(ops.idct2_patches(ops.dct2_patches(x)), p, 1e-3)
    _close(dct.idct2_flat(dct.dct2_flat(x.reshape(3, 5, -1), psz), psz), flat, 1e-3)


def test_image_dcts():
    img = _rng().uniform(0, 255, (24, 32, 3)).astype(np.float32)
    want = j_ops.dct2_image(jnp.asarray(img))
    got = ops.dct2_image(torch.from_numpy(img))
    _close(got, want, 1e-5 * 255)
    _close(ops.idct2_image(got), j_ops.idct2_image(want), 1e-3)


@pytest.mark.parametrize("border_out", [False, True])
def test_bicubic_sample(border_out):
    rng = _rng()
    im = rng.uniform(0, 255, (24, 32)).astype(np.float32)
    yy, xx = np.mgrid[:24, :32].astype(np.float32)
    uu = (xx + rng.normal(0, 3, xx.shape)).astype(np.float32)
    vv = (yy + rng.normal(0, 3, yy.shape)).astype(np.float32)
    want = j_ops.bicubic_sample(jnp.asarray(im), jnp.asarray(uu), jnp.asarray(vv), border_out)
    got = ops.bicubic_sample(torch.from_numpy(im), torch.from_numpy(uu), torch.from_numpy(vv),
                             border_out)
    _close(got, want, 1e-4)
    if border_out:
        assert bool((got == 0).any())


@pytest.mark.parametrize("psz", [2, 5, 8])
def test_patch_validity(psz):
    v = _rng().uniform(size=(30, 40)) > 0.02
    want = np.asarray(j_nlk.patch_validity(jnp.asarray(v), psz))
    got = nlkalman.patch_validity(torch.from_numpy(v), psz).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)


def test_models_and_params_reexports():
    for name in ("denoise_batch", "denoise_sequence", "filter_sequence", "fsmo_sequence",
                 "lsmo_sequence", "smooth_sequence", "ms_denoise_sequence"):
        assert getattr(models, name) is getattr(pipeline, name)
    assert models.tvl1_flow is flow.tvl1_flow and models.occlusion_mask is flow.occlusion_mask
    assert models.nlkalman_filter_frame is nlkalman.nlkalman_filter_frame
    assert models.nlkalman_smooth_frame is nlkalman.nlkalman_smooth_frame
    assert models.NLKParams is port.params.NLKParams
    assert models.FilterMode is port.params.FilterMode
    assert models.default_params is port.params.default_params


def _public(path: Path) -> set[str]:
    """Public names a module binds at its top level: defs, classes,
    imports and assignments."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update(a.asname or a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in out if not n.startswith("_")}


def _defs(path: Path) -> set[str]:
    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")}


def test_every_public_subpackage_name_is_ported():
    """The names of each JAX ``__init__.py`` (the package's and each
    subpackage's) are in the port's ``__init__.py`` of the same path."""
    missing = []
    for init in sorted(JAX_PKG.rglob("__init__.py")):
        rel = init.relative_to(JAX_PKG)
        sub = ".".join(rel.parent.parts)
        ported = _public(PORT_PKG / rel) if (PORT_PKG / rel).exists() else set()
        missing += [f"{sub}.{n}" if sub else n for n in sorted(_public(init) - ported)
                    if f"{sub}.{n}" not in NOT_PORTED]
    assert not missing, f"public JAX names the port lacks: {missing}"


def test_every_public_module_function_is_ported():
    """Every public function or class a JAX module defines is bound at the
    top level of the port's module of the same path (defined there or
    imported), and every JAX module has its port."""
    missing = []
    for mod in sorted(JAX_PKG.rglob("*.py")):
        rel = mod.relative_to(JAX_PKG)
        if mod.name == "__init__.py" or str(rel) in NOT_PORTED:
            continue
        if not (PORT_PKG / rel).exists():
            missing.append(str(rel))
            continue
        missing += [f"{rel}:{n}" for n in sorted(_defs(mod) - _public(PORT_PKG / rel))
                    if f"{rel}:{n}" not in NOT_PORTED]
    assert not missing, f"JAX modules or functions the port lacks: {missing}"
