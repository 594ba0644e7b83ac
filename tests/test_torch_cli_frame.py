"""The per-frame commands and the rest of the io and measure layer, run
in-process through the JAX package's and the port's ``main(argv)`` (the
port with ``--device cpu``) on the same files.

- ``nlkalman-flt`` (both passes with the previous outputs warped along a
  backward flow ``-o`` and occlusion mask ``-k``, and ``--f1_p 0`` reading
  the first pass's output) and ``nlkalman-smo`` on float ``.tif`` frames
  at 32x40 RGB: within K1's bar, rtol 1e-3 and atol 5e-2 (the NLK passes'
  reduction orders can flip a selection tie).
- ``awgn``, ``iion``, ``psnr``: equal; ``decompose`` and ``recompose``
  within atol 1e-4 or rtol 1e-5 (each transform is two float32 matrix
  products, summed in other orders: 1.3e-6 relative at these sizes).
- ``flow/measure.py``: equal. ``flow_energy``: rel 1e-4;
  ``warm_gate_probe``: the same verdict, residuals to rel 1e-4.
- The capability report runs and names the port and its commands.

The JAX commands' ``setup_jax`` (which points JAX at a persistent
compilation cache the suite does not use) is replaced by a no-op, and
``BNLK_NO_NATIVE`` keeps the JAX io on its pure-Python codecs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.cli import decompose as j_decompose
from bwd_nlkalman_tpu.cli import nlkalman_flt as j_flt
from bwd_nlkalman_tpu.cli import nlkalman_smo as j_smo
from bwd_nlkalman_tpu.cli import recompose as j_recompose
from bwd_nlkalman_tpu.cli import awgn as j_awgn
from bwd_nlkalman_tpu.cli import iion as j_iion
from bwd_nlkalman_tpu.cli import psnr as j_psnr
from bwd_nlkalman_tpu.flow import measure as j_measure
from bwd_nlkalman_tpu.flow import tvl1 as j_tvl1
from bwd_nlkalman_tpu_torch import __main__ as report
from bwd_nlkalman_tpu_torch.cli import (awgn, decompose, iion, nlkalman_flt, nlkalman_smo,
                                        psnr, recompose)
from bwd_nlkalman_tpu_torch.flow import measure, tvl1
from bwd_nlkalman_tpu_torch.io import read_image, write_image
from test_torch_smoothers import scene

torch.set_num_threads(1)

SIGMA = 20.0
H, W = 32, 40


def _flow(h, w, shift=(-1.3, 0.8)):
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    u = shift[0] + 0.3 * np.sin(0.2 * yy)
    v = shift[1] + 0.2 * np.cos(0.15 * xx)
    return np.stack([u, v], -1).astype(np.float32)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Files of one RGB scene: noisy frames 0 and 1, frame 0's two passes
    (as the previous outputs), a backward and a forward flow and their
    occlusion masks."""
    d = tmp_path_factory.mktemp("frames")
    clean, noisy = scene(2, H, W, c=3, seed=4)
    rng = np.random.default_rng(4)
    files = {"clean1": clean[1], "nisy0": noisy[0], "nisy1": noisy[1],
             "flt10": clean[0] + 3 * rng.standard_normal(clean[0].shape),
             "flt20": clean[0] + 2 * rng.standard_normal(clean[0].shape),
             "bflo": _flow(H, W), "fflo": _flow(H, W, (1.2, -0.7))}
    occ = np.zeros((H, W, 1), np.float32)
    occ[10:14, 20:24] = 255.0
    files["bocc"] = files["focc"] = occ
    paths = {}
    for k, a in files.items():
        paths[k] = str(d / (k + (".flo" if k.endswith("flo") else ".tif")))
        write_image(paths[k], np.ascontiguousarray(a, np.float32))
    return d, paths


@pytest.fixture(autouse=True)
def _jax_cli(monkeypatch):
    monkeypatch.setenv("BNLK_NO_NATIVE", "1")
    for mod in (j_flt, j_smo, j_decompose, j_recompose):
        monkeypatch.setattr(mod, "setup_jax", lambda: None)


def _both(tmp, jax_main, port_main, argv_of):
    """Run the JAX and the port command, each writing under its own prefix."""
    assert jax_main(argv_of("j")) == 0
    assert port_main(argv_of("p") + ["--device", "cpu"]) == 0
    return lambda name, who: read_image(str(tmp / f"{who}-{name}.tif"))


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=5e-2)


def test_nlkalman_flt_both_passes(frames):
    d, p = frames
    argv = lambda who: ["-i", p["nisy1"], "-o", p["bflo"], "-k", p["bocc"],
                        "--flt10", p["flt10"], "--flt20", p["flt20"],
                        "--flt11", str(d / f"{who}-flt11.tif"),
                        "--flt21", str(d / f"{who}-flt21.tif"), "-s", f"{SIGMA:g}"]
    out = _both(d, j_flt.main, nlkalman_flt.main, argv)
    for name in ("flt11", "flt21"):
        got, want = out(name, "p"), out(name, "j")
        assert got.shape == (H, W, 3)
        _close(got, want)
    clean = read_image(p["clean1"])
    noisy = read_image(p["nisy1"])
    assert np.mean((out("flt21", "p") - clean) ** 2) < 0.5 * np.mean((noisy - clean) ** 2)


def test_nlkalman_flt_skips_pass_one(frames):
    """``--f1_p 0``: the first pass is read from ``--flt11``, the second
    runs with it as its basic estimate (and with the patch flags of -f2)."""
    d, p = frames
    argv = lambda who: ["-i", p["nisy1"], "-o", p["bflo"], "--flt20", p["flt20"],
                        "--flt11", p["flt10"], "--f1_p", "0", "--f2_p", "6",
                        "--flt21", str(d / f"{who}-skip21.tif"), "-s", f"{SIGMA:g}"]
    out = _both(d, j_flt.main, nlkalman_flt.main, argv)
    _close(out("skip21", "p"), out("skip21", "j"))


def test_nlkalman_smo(frames, capsys):
    d, p = frames
    argv = lambda who: ["--flt1", p["flt20"], "--smo0", p["flt10"], "-o", p["fflo"],
                        "-k", p["focc"], "--smo1", str(d / f"{who}-smo1.tif"),
                        "-s", f"{SIGMA:g}", "-v", "1"]
    out = _both(d, j_smo.main, nlkalman_smo.main, argv)
    _close(out("smo1", "p"), out("smo1", "j"))
    # the -v dump is the JAX command's, line for line
    dumps = capsys.readouterr().out.split("data input:")
    assert len(dumps) == 3 and dumps[1] == dumps[2].replace("p-smo1", "j-smo1")


def test_awgn_iion(frames, tmp_path):
    _, p = frames
    for mod, who in ((j_awgn, "j"), (awgn, "p")):
        assert mod.main([f"{SIGMA:g}", p["clean1"], str(tmp_path / f"{who}.tif"),
                         "--seed", "7"]) == 0
    np.testing.assert_array_equal(read_image(str(tmp_path / "p.tif")),
                                  read_image(str(tmp_path / "j.tif")))
    for mod, who in ((j_iion, "j"), (iion, "p")):
        assert mod.main([p["nisy1"], str(tmp_path / f"{who}.png")]) == 0
    assert (open(tmp_path / "p.png", "rb").read() == open(tmp_path / "j.png", "rb").read())


def test_psnr_prints_the_jax_lines(frames, capsys):
    _, p = frames
    assert j_psnr.main([p["clean1"], p["nisy1"], "--border", "2"]) == 0
    want = capsys.readouterr().out
    assert psnr.main([p["clean1"], p["nisy1"], "--border", "2"]) == 0
    assert capsys.readouterr().out == want and "PSNR" in want


def test_decompose_recompose(frames, tmp_path):
    _, p = frames
    for mod, who in ((j_decompose, "j"), (decompose, "p")):
        extra = ["--device", "cpu"] if who == "p" else []
        assert mod.main([p["nisy1"], str(tmp_path / f"{who}-l"), "3", ".tif",
                         "-r", "2", *extra]) == 0
    for i in range(3):
        np.testing.assert_allclose(read_image(str(tmp_path / f"p-l{i}.tif")),
                                   read_image(str(tmp_path / f"j-l{i}.tif")),
                                   rtol=1e-5, atol=1e-4)
    for mod, who in ((j_recompose, "j"), (recompose, "p")):
        extra = ["--device", "cpu"] if who == "p" else []
        assert mod.main([str(tmp_path / "j-l"), "3", ".tif", str(tmp_path / f"{who}-r.tif"),
                         "-c", "0.8", *extra]) == 0
    np.testing.assert_allclose(read_image(str(tmp_path / "p-r.tif")),
                               read_image(str(tmp_path / "j-r.tif")), rtol=1e-5, atol=1e-4)


def test_flow_measures_equal():
    rng = np.random.default_rng(5)
    gt = _flow(H, W)
    gt[3, 4] = 1e10                       # Middlebury's unknown
    flow = gt + rng.normal(0, 0.8, gt.shape).astype(np.float32)
    flow[3, 4] = 0.0
    assert measure.endpoint_error(flow, gt) == j_measure.endpoint_error(flow, gt)
    assert measure.angular_error(flow, gt) == j_measure.angular_error(flow, gt)


def test_flow_measure_sequence_equal(tmp_path):
    from bwd_nlkalman_tpu_torch.io import write_flo

    rng = np.random.default_rng(6)
    for i in range(2):
        write_flo(str(tmp_path / f"f-{i}.flo"), _flow(H, W) + rng.normal(0, 1, (H, W, 2))
                  .astype(np.float32))
        write_flo(str(tmp_path / f"g-{i}.flo"), _flow(H, W))
    args = (str(tmp_path / "f-%d.flo"), str(tmp_path / "g-%d.flo"), 0, 1)
    assert measure.measure_sequence(*args) == j_measure.measure_sequence(*args)


def test_flow_energy_and_warm_gate_probe():
    clean, noisy = scene(2, H, W, seed=8)
    i0, i1 = noisy[1, ..., 0], noisy[0, ..., 0]
    flow = _flow(H, W, (1.0, 0.5))
    want = float(j_tvl1.flow_energy(jnp.asarray(i0), jnp.asarray(i1), jnp.asarray(flow)))
    got = float(tvl1.flow_energy(torch.from_numpy(i0), torch.from_numpy(i1),
                                 torch.from_numpy(flow)))
    assert got == pytest.approx(want, rel=1e-4)
    for carry in (np.zeros((H, W, 2), np.float32), flow, 40.0 + flow):
        j_ok, j_rw, j_rz = j_tvl1.warm_gate_probe(jnp.asarray(i0), jnp.asarray(i1),
                                                  jnp.asarray(carry))
        ok, rw, rz = tvl1.warm_gate_probe(torch.from_numpy(i0), torch.from_numpy(i1),
                                          torch.from_numpy(carry))
        assert bool(ok) == bool(j_ok)
        assert float(rw) == pytest.approx(float(j_rw), rel=1e-4)
        assert float(rz) == pytest.approx(float(j_rz), rel=1e-4)


def test_capability_report(capsys):
    assert report.main() == 0
    out = capsys.readouterr().out
    assert "bwd_nlkalman_tpu_torch" in out and "nlkalman-flt" in out
    assert "1080x1920x3 bfloat16 bands: K1 takes every default pass" in out
