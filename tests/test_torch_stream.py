"""The port's streaming runner (``pipeline/stream.py``) and its checkpoints.

- ``StreamingDenoiser`` with each streaming smoother (none, fsmo, lsmo)
  equals the port's own whole-clip drivers frame for frame, cold and
  with warm-started flow, to 1e-4 (the same arithmetic in the same
  order: only the frames' grouping differs).
- ``run_streaming`` killed after a checkpoint and resumed reproduces the
  uninterrupted run (as ``tests/test_round3.py``'s kill/resume test).
- Checkpoints interchange with the JAX package: a JAX-written one (and a
  live JAX stream carried across by ``convert.streaming_from_jax``)
  resumes in the port to JAX's frames within the parity bar, 0.05 dB at
  the XLA path's TV-L1 check granularity (10); a port-written one loads
  in JAX's ``load_state`` with every array equal.
- ``flow_carry_shape`` equals JAX's, and the carry the flow returns.
"""

import numpy as np
import pytest
import torch

from bwd_nlkalman_tpu.flow import tvl1 as j_tvl1
from bwd_nlkalman_tpu.params import NLKParams as JParams
from bwd_nlkalman_tpu.pipeline import stream as j_stream
from bwd_nlkalman_tpu_torch import convert
from bwd_nlkalman_tpu_torch.flow import tvl1
from bwd_nlkalman_tpu_torch.pipeline import sequence as seq
from bwd_nlkalman_tpu_torch.pipeline.stream import StreamingDenoiser, run_streaming
from test_torch_smoothers import psnr, scene

torch.set_num_threads(1)
SIGMA = 20.0
WARM = seq.FlowConfig(warm_start=True, warm_nwarps=3)
# the JAX suite's small parameters for its streaming tests
# (tests/test_stream_warm.py:20-29)
J_P1 = JParams(patch_sz=8, search_sz_x=6, search_sz_t=3, npatches_x=12,
               npatches_t=8, npatches_tagg=4, dista_lambda=1.0, beta_x=3.0,
               beta_t=2.0)
J_P2 = JParams(patch_sz=8, search_sz_x=6, search_sz_t=3, npatches_x=10,
               npatches_t=8, npatches_tagg=4, dista_lambda=1.0, beta_x=2.5,
               beta_t=1.8)
P1, P2 = convert.params_from_jax(J_P1), convert.params_from_jax(J_P2)


def _stream(noisy, smoother, cfg=seq.FlowConfig(), **kw):
    """Every step's outputs of a CPU stream: flt1, flt2, and smo (fsmo) or
    lsm (lsmo: frame t-1's, then the last frame's passthrough)."""
    sd = StreamingDenoiser(SIGMA, smoother=smoother, flow_cfg=cfg, device="cpu", **kw)
    f1, f2, sm = [], [], []
    for frame in noisy:
        a, b = sd.step(frame)
        f1.append(a)
        f2.append(b)
        if smoother == "fsmo":
            sm.append(sd.smo)
        elif sd.lsm is not None:
            sm.append(sd.lsm)
    if smoother == "lsmo":
        sm.append(sd.finalize())
    return sd, torch.stack(f1), torch.stack(f2), (torch.stack(sm) if sm else None)


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-4)


@pytest.mark.parametrize("smoother", ["none", "fsmo", "lsmo"])
def test_streaming_matches_whole_clip_drivers(smoother):
    _, noisy = scene(4, 24, 32, c=3)
    x = torch.from_numpy(noisy)
    _, f1, f2, sm = _stream(noisy, smoother)
    if smoother == "fsmo":
        w1, w2, wsm = seq.fsmo_sequence(x, SIGMA)
    else:
        w1, w2 = seq.filter_sequence(x, SIGMA)
        wsm = seq.lsmo_sequence(w2, SIGMA) if smoother == "lsmo" else None
    _close(f1, w1)
    _close(f2, w2)
    if wsm is not None:
        _close(sm, wsm)


def test_warm_streaming_matches_warm_filter_sequence():
    _, noisy = scene(4, 32, 40)
    sd, f1, f2, _ = _stream(noisy, "none", WARM)
    assert sd.u_fs is not None and tuple(sd.u_fs.shape) == tvl1.flow_carry_shape(32, 40, fscale=1)
    w1, w2 = seq.filter_sequence(torch.from_numpy(noisy), SIGMA, flow_cfg=WARM)
    _close(f1, w1)
    _close(f2, w2)


@pytest.mark.parametrize("cfg", [seq.FlowConfig(), WARM], ids=["cold", "warm"])
def test_run_streaming_kill_resume(tmp_path, cfg):
    """Periodic asynchronous checkpoints, a run stopped after frame 2 and a
    resumed one: frames 3-5 as the uninterrupted run's, and the resumed
    run writes only those."""
    _, noisy = scene(6, 24, 32)
    ck = str(tmp_path / "state.npz")
    kw = dict(smoother="fsmo", flow_cfg=cfg, device="cpu")
    full = run_streaming(lambda i: noisy[i], 0, 5, SIGMA, checkpoint_every=2, **kw)
    run_streaming(lambda i: noisy[i], 0, 2, SIGMA, checkpoint_path=ck,
                  checkpoint_every=1, **kw)
    written = []
    resumed = run_streaming(lambda i: noisy[i], 0, 5, SIGMA, checkpoint_path=ck,
                            checkpoint_every=2, write_frame=lambda n, i, a: written.append(
                                (n, i, type(a))), **kw)
    assert len(resumed) == 3
    assert sorted(set(i for _, i, _ in written)) == [3, 4, 5]
    assert {n for n, _, _ in written} == {"flt1", "flt2", "smo1"}
    assert {t for _, _, t in written} == {np.ndarray}
    for (f1a, f2a), (f1b, f2b) in zip(full[3:], resumed):
        np.testing.assert_allclose(f1b, f1a, rtol=0, atol=1e-4)
        np.testing.assert_allclose(f2b, f2a, rtol=0, atol=1e-4)


def test_streaming_refuses_rts():
    with pytest.raises(ValueError, match="anti-causal"):
        StreamingDenoiser(SIGMA, smoother="rts", device="cpu")


@pytest.fixture(scope="module")
def jax_stream(tmp_path_factory):
    """A JAX fsmo stream on 4 gray frames: its checkpoint after frame 1,
    its live state there, and its frames 2-3."""
    clean, noisy = scene(4, 32, 40, seed=3)
    path = str(tmp_path_factory.mktemp("jax") / "state.npz")
    sd = j_stream.StreamingDenoiser(SIGMA, J_P1, J_P2, smoother="fsmo")
    for i in range(2):
        sd.step(noisy[i])
    sd.save_state(path)
    live = convert.streaming_from_jax(sd, device="cpu")
    rest = []
    for i in range(2, 4):
        rest.append(sd.step(noisy[i]) + (np.asarray(sd.smo),))
    return clean, noisy, path, live, rest


@pytest.mark.parametrize("how", ["checkpoint", "convert"])
def test_jax_stream_resumes_in_port(jax_stream, monkeypatch, how):
    clean, noisy, path, live, want = jax_stream
    monkeypatch.setattr(tvl1, "_k_check", lambda npx: 10)
    if how == "checkpoint":
        sd = StreamingDenoiser(SIGMA, P1, P2, smoother="fsmo", device="cpu")
        sd.load_state(path)
    else:
        sd = live
    assert sd.index == 1 and sd.smo is not None and sd.u_fs is None
    got = []
    for i in range(2, 4):
        got.append(tuple(x.numpy() for x in sd.step(noisy[i])) + (sd.smo.numpy(),))
    for k, name in enumerate(("flt1", "flt2", "smo1")):
        g = np.stack([f[k] for f in got])
        w = np.stack([f[k] for f in want])
        gap = psnr(clean[2:], g) - psnr(clean[2:], w)
        print(f"{how} {name}: {gap:+.4f} dB, max abs diff {np.abs(g - w).max():.3f}")
        assert abs(gap) <= 0.05, name


def test_port_checkpoint_loads_in_jax(tmp_path):
    """A warm fsmo stream's checkpoint (all five arrays filled) read by the
    JAX package's load_state."""
    _, noisy = scene(3, 32, 40, c=3)
    sd, *_ = _stream(noisy, "fsmo", WARM, p1=P1, p2=P2)
    path = str(tmp_path / "state.npz")
    writer = sd.save_state(path, background=True)
    writer.join(timeout=60)
    assert not writer.is_alive()
    jd = j_stream.StreamingDenoiser(SIGMA, J_P1, J_P2, smoother="fsmo",
                                    flow_cfg=j_stream.FlowConfig(warm_start=True))
    jd.load_state(path)
    assert jd.index == sd.index == 2
    for name in ("flt1", "flt2", "smo", "u_fs"):
        np.testing.assert_array_equal(np.asarray(getattr(jd, name)),
                                      getattr(sd, name).numpy())


@pytest.mark.parametrize("h,w", [(24, 32), (37, 53), (48, 64), (540, 960), (1080, 1920)])
def test_flow_carry_shape_matches_jax(h, w):
    for fscale in range(4):
        assert tvl1.flow_carry_shape(h, w, fscale=fscale) == \
            j_tvl1.flow_carry_shape(h, w, fscale=fscale)


@pytest.mark.parametrize("fscale", [0, 1, 2])
def test_flow_carry_shape_is_the_carry(fscale):
    _, noisy = scene(2, 37, 53)
    x = torch.from_numpy(noisy[..., 0])
    _, u_fs = tvl1.tvl1_flow(x[0], x[1], fscale=fscale, max_iters=4,
                             return_carry=True)
    assert tuple(u_fs.shape) == tvl1.flow_carry_shape(37, 53, fscale=fscale)
