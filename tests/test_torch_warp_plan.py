"""K4's wrappers and its TV-L1 entry's plain version, on the CPU.

- The wrappers refuse what the kernel cannot take (an empty frame, no
  channel, output rows outside the frame) and CPU tensors.
- ``tvl1_stage_consts_plain`` against the JAX package's warp stage
  (``warp_bicubic_zero_multi`` and the constants of
  ``flow/tvl1_pallas.py:274-275``) on the same numpy inputs, along a
  noisy flow, one with a band shifted by hundreds of pixels and one with
  huge values. Tolerance: 1e-3 absolute on the warped planes, as for
  every warp (a 16-tap cubic in float32 in another order); grad and rho_c
  are products of those with gradients of up to ~30 and flow of up to
  ~15, so 2e-2 absolute on them (on the CPU both sides agree bit for
  bit); where a tap leaves the frame the samples are exactly 0 and rho_c
  exactly -i0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.ops import warp as j_warp
from bwd_nlkalman_tpu_torch.flow import tvl1_tiled
from bwd_nlkalman_tpu_torch.ops import warp_cuda
from bwd_nlkalman_tpu_torch.ops.grad import centered_gradient
from bwd_nlkalman_tpu_torch.ops.warp import bicubic_warp_plain

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


@pytest.mark.parametrize("kw", [dict(h=0), dict(w=0), dict(c=0), dict(y0=1)])
def test_k4_wrapper_refuses_frames_the_kernel_cannot_take(kw):
    args = dict(h=25, w=41, c=2, y0=0) | kw
    h, w, c = args["h"], args["w"], args["c"]
    with pytest.raises(ValueError, match="empty frame|channels|rows"):
        warp_cuda.bicubic_warp_cuda(torch.zeros((h, w, c)), torch.zeros((h, w, 2)),
                                    y0=args["y0"])


def test_k4_wrappers_take_cuda_tensors_only():
    z = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        warp_cuda.bicubic_warp_cuda(z[..., None], torch.zeros((4, 4, 2)))
    with pytest.raises(ValueError, match="CUDA"):
        warp_cuda.warp_tvl1_consts_cuda(torch.zeros((4, 4, 3)), torch.zeros((6, 4, 4)), z)


def _stage_inputs(rng, h, w, flow="noisy"):
    base = np.cumsum(np.cumsum(rng.normal(size=(h + 8, w + 8)), 0), 1)
    base = ((base - base.min()) / (base.max() - base.min()) * 255).astype(np.float32)
    i0, i1 = base[4:4 + h, 4:4 + w], base[2:2 + h, 5:5 + w]
    i1x, i1y = (g.numpy() for g in centered_gradient(_t(i1)))
    u = (1.5 * rng.standard_normal((2, h, w))).astype(np.float32)
    u[1, : max(1, h // 5)] -= 9.0          # the top rows leave the frame
    u[0, :, -max(1, w // 6):] += 12.5      # and the right columns
    if flow == "band":                     # rows sent hundreds of pixels away
        u[0, h // 3: h // 3 + 2] -= 0.45 * max(w, 400)
    elif flow == "huge":                   # far outside any frame
        u[0, h // 2, :: 3] = 1e30
        u[1, h // 2, 1:: 3] = -1e30
    state = np.concatenate([u, rng.normal(0, 0.3, (4, h, w)).astype(np.float32)])
    return np.stack([i1, i1x, i1y], -1), state, i0


@pytest.mark.parametrize("flow", ["noisy", "band", "huge"])
@pytest.mark.parametrize("h,w", [(9, 11), (17, 16), (25, 41), (48, 64)])
def test_stage_consts_plain_matches_jax(rng, h, w, flow):
    i1s, state, i0 = _stage_inputs(rng, h, w, flow)
    got = tvl1_tiled.tvl1_stage_consts_plain(_t(i1s), _t(state), _t(i0)).numpy()
    u1, u2 = jnp.asarray(state[0]), jnp.asarray(state[1])
    wrp = j_warp.warp_bicubic_zero_multi(jnp.asarray(i1s), u1, u2)
    i1w, i1wx, i1wy = wrp[..., 0], wrp[..., 1], wrp[..., 2]
    grad = i1wx * i1wx + i1wy * i1wy
    rho_c = i1w - i1wx * u1 - i1wy * u2 - jnp.asarray(i0)
    np.testing.assert_allclose(got[0], np.asarray(i1wx), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1], np.asarray(i1wy), rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[2], np.asarray(grad), rtol=0, atol=2e-2)
    np.testing.assert_allclose(got[3], np.asarray(rho_c), rtol=0, atol=2e-2)
    # out of the frame: the samples are 0 and rho_c is -i0, on both sides
    _, valid = bicubic_warp_plain(_t(i1s), _t(np.moveaxis(state[:2], 0, -1)))
    out = ~valid.numpy()
    assert 0 < out.sum() < h * w
    assert not got[:3, out].any()
    np.testing.assert_array_equal(got[3, out], -i0[out])
    np.testing.assert_array_equal(np.asarray(rho_c)[out], -i0[out])


def test_stage_consts_dispatch_takes_the_plain_version_on_the_cpu(rng):
    i1s, state, i0 = (_t(a) for a in _stage_inputs(rng, 25, 41))
    assert torch.equal(tvl1_tiled.tvl1_stage_consts(i1s, state, i0),
                       tvl1_tiled.tvl1_stage_consts_plain(i1s, state, i0))
    with pytest.raises(ValueError):
        tvl1_tiled.tvl1_stage_consts(i1s, state, i0, engine="fast")
