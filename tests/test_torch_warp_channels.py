"""K4's warp at any channel count, on the CPU.

- The port's ``warp_bicubic_nan`` at C = 4, 10, 12, 14 and 21, with and
  without occlusion, on 32x40 and 37x53 frames, against JAX's
  ``warp_bicubic_nan`` on the same numpy inputs: max abs error <= 1e-4
  (a 16-tap cubic in float32 in another order; 0 measured on the CPU) and
  identical masks. At C = 12 also against JAX's Pallas warp
  (``bicubic_warp_pallas`` in interpret mode), at the same bar.
- The channel-group plan (``warp_cuda.channel_groups``) that a launch
  takes covers every channel exactly once at C = 1..24: one group up to
  9, groups of 8 past it; where C is even every group starts and ends on
  an even channel (the kernel's float2 loads).

The kernel itself is held against the plain version on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py`` phase 3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.ops import warp as j_warp
from bwd_nlkalman_tpu.ops.warp_pallas import bicubic_warp_pallas
from bwd_nlkalman_tpu_torch.ops import warp_cuda
from bwd_nlkalman_tpu_torch.ops.warp import warp_bicubic_nan

torch.set_num_threads(1)
ATOL = 1e-4


def _inputs(c, h, w, seed=0):
    """A C-channel frame, a noisy flow with the top rows and right columns
    sent out of the frame, and an occlusion mask on a tenth of the pixels."""
    rng = np.random.default_rng(seed + c)
    im = rng.uniform(0, 255, (h, w, c)).astype(np.float32)
    flow = (1.5 * rng.standard_normal((h, w, 2))).astype(np.float32)
    flow[: h // 5, :, 1] -= 9.0
    flow[:, -(w // 6):, 0] += 12.5
    occl = np.where(rng.uniform(size=(h, w)) < 0.1, 255.0, 0.0).astype(np.float32)
    return im, flow, occl


@pytest.mark.parametrize("occluded", [False, True])
@pytest.mark.parametrize("h,w", [(32, 40), (37, 53)])
@pytest.mark.parametrize("c", [4, 10, 12, 14, 21])
def test_warp_matches_jax_at_any_channel_count(c, h, w, occluded):
    im, flow, occl = _inputs(c, h, w)
    oc = occl if occluded else None
    got, gv = warp_bicubic_nan(torch.from_numpy(im), torch.from_numpy(flow),
                               None if oc is None else torch.from_numpy(oc))
    want, wv = j_warp.warp_bicubic_nan(jnp.asarray(im), jnp.asarray(flow),
                                       None if oc is None else jnp.asarray(oc))
    assert got.shape == (h, w, c) and gv.dtype == torch.bool
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert 0 < int(gv.sum()) < h * w
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert not got.numpy()[~gv.numpy()].any()


def test_warp_matches_jax_pallas_kernel_at_12_channels():
    """fsmo's warp of a 4-channel clip (flt1|flt2|smo, 12 channels) against
    the TPU kernel K4 itself, run in interpret mode; the occlusion is
    applied to its mask as ``warp_bicubic_nan`` applies it."""
    h, w, c = 32, 40, 12
    im, flow, occl = _inputs(c, h, w, seed=7)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    want, wv = bicubic_warp_pallas(jnp.asarray(im), jnp.asarray(xx + flow[..., 0]),
                                   jnp.asarray(yy + flow[..., 1]), interpret=True)
    wv = np.asarray(wv) & (occl == 0)
    want = np.where(wv[..., None], np.asarray(want), 0.0)
    got, gv = warp_bicubic_nan(torch.from_numpy(im), torch.from_numpy(flow),
                               torch.from_numpy(occl))
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("c", range(1, 25))
def test_channel_groups_cover_every_channel_once(c):
    groups = warp_cuda.channel_groups(c)
    covered = [ch for c0, n in groups for ch in range(c0, c0 + n)]
    assert covered == list(range(c))
    if c <= warp_cuda.ONE_GROUP_C:
        assert groups == [(0, c)]
    else:
        assert all(n == warp_cuda.GROUP_C for _, n in groups[:-1])
        assert 1 <= groups[-1][1] <= warp_cuda.GROUP_C
        assert len(groups) == -(-c // warp_cuda.GROUP_C)
    if c % 2 == 0:
        assert all(c0 % 2 == 0 and n % 2 == 0 for c0, n in groups)


@pytest.mark.parametrize("c,want", [
    (9, [(0, 9)]),
    (10, [(0, 8), (8, 2)]),
    (16, [(0, 8), (8, 8)]),
    (21, [(0, 8), (8, 8), (16, 5)]),
])
def test_channel_groups_of_a_launch(c, want):
    """The groups of the main path's counts: fsmo's 9-channel warp of an
    RGB clip is one, the filter's of a 5-channel clip two."""
    assert warp_cuda.channel_groups(c) == want


@pytest.mark.parametrize("c", [0, -1, -8, -9])
def test_channel_groups_refuse_what_the_kernel_cannot_launch(c):
    with pytest.raises(ValueError, match="channels"):
        warp_cuda.channel_groups(c)
