"""The port's image ops against the JAX package's, on the same numpy inputs.

Tolerances: 1e-4 absolute on a 0-255 scale for the ops (float32 rounding
of the same arithmetic in another order); 1e-3 for the warps (a 16-tap
cubic in float32) with identical validity masks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bwd_nlkalman_tpu.flow.occlusion import occlusion_mask as j_occlusion
from bwd_nlkalman_tpu.ops import color as j_color
from bwd_nlkalman_tpu.ops import dct as j_dct
from bwd_nlkalman_tpu.ops import gaussian as j_gauss
from bwd_nlkalman_tpu.ops import grad as j_grad
from bwd_nlkalman_tpu.ops import warp as j_warp
from bwd_nlkalman_tpu.ops import windows as j_windows
from bwd_nlkalman_tpu.ops import zoom as j_zoom
from bwd_nlkalman_tpu_torch.flow.occlusion import occlusion_mask
from bwd_nlkalman_tpu_torch.ops import color, dct, gaussian, grad, warp, windows, zoom

torch.set_num_threads(1)
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def _img(rng, *shape):
    return (rng.uniform(0, 255, shape)).astype(np.float32)


@pytest.mark.parametrize("c", [1, 3])
def test_color_roundtrip(rng, c):
    im = _img(rng, 9, 11, c)
    _close(color.rgb2opp(_t(im)), j_color.rgb2opp(jnp.asarray(im)))
    _close(color.opp2rgb(_t(im)), j_color.opp2rgb(jnp.asarray(im)))
    _close(color.opp2rgb(color.rgb2opp(_t(im))), im)


def test_window_and_dct_bases():
    _close(windows.window_np(8), j_windows.window_function("gaussian", 8), atol=0)
    np.testing.assert_array_equal(dct._ortho_basis_np(8), j_dct._ortho_basis_np(8))
    np.testing.assert_array_equal(dct._ortho_basis_kron_np(8),
                                  j_dct._ortho_basis_kron_np(8))


@pytest.mark.parametrize("c", [1, 2])
def test_all_patch_dct(rng, c):
    im = _img(rng, 17, 21, c)
    _close(dct.dct_image_all_patches(_t(im), 8),
           j_dct.dct_image_all_patches(jnp.asarray(im), 8), atol=2e-3)


def test_gradients_and_divergence(rng):
    a, b = _img(rng, 12, 15), _img(rng, 12, 15)
    for mine, ref in zip(grad.forward_gradient(_t(a)),
                         j_grad.forward_gradient(jnp.asarray(a))):
        _close(mine, ref)
    for mine, ref in zip(grad.centered_gradient(_t(a)),
                         j_grad.centered_gradient(jnp.asarray(a))):
        _close(mine, ref)
    _close(grad.divergence(_t(a), _t(b)),
           j_grad.divergence(jnp.asarray(a), jnp.asarray(b)))


def test_gaussian_blur(rng):
    im = _img(rng, 20, 26)
    np.testing.assert_array_equal(gaussian.blur_matrix_np(26, 0.8),
                                  j_gauss.blur_matrix_np(26, 0.8))
    _close(gaussian.gaussian_blur(_t(im), 0.8),
           j_gauss.gaussian_blur(jnp.asarray(im), 0.8))


def test_zoom(rng):
    im = _img(rng, 25, 41)
    _close(zoom.zoom_out(_t(im), 0.5), j_zoom.zoom_out(jnp.asarray(im), 0.5))
    _close(zoom.zoom_in(_t(im), 82, 50), j_zoom.zoom_in(jnp.asarray(im), 82, 50))
    assert zoom.zoom_size(41, 25, 0.5) == j_zoom.zoom_size(41, 25, 0.5)


def test_occlusion(rng):
    flow = (2.0 * rng.standard_normal((14, 18, 2))).astype(np.float32)
    _close(occlusion_mask(_t(flow), 0.75), j_occlusion(jnp.asarray(flow), 0.75), atol=0)


def _flow(rng, h, w):
    """Smooth flow plus patches that push the footprint out of the frame."""
    f = 1.5 * rng.standard_normal((h, w, 2)).astype(np.float32)
    f[:6, :, 1] -= 9.0          # top rows sample above the frame
    f[:, -7:, 0] += 12.5        # right columns sample beyond it
    f[10:14, 5:9] = [-30.0, 40.0]
    return f


@pytest.mark.parametrize("c", [1, 2, 3])
def test_warp_bicubic_nan(rng, c):
    h, w = 32, 40
    im, flow = _img(rng, h, w, c), _flow(rng, h, w)
    occl = np.where(rng.uniform(size=(h, w)) < 0.1, 255.0, 0.0).astype(np.float32)
    out, valid = warp.warp_bicubic_nan(_t(im), _t(flow), _t(occl))
    j_out, j_valid = j_warp.warp_bicubic_nan(
        jnp.asarray(im), jnp.asarray(flow), jnp.asarray(occl))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
    assert 0 < valid.sum() < h * w
    _close(out, j_out, atol=1e-3)


@pytest.mark.parametrize("c", [1, 2, 3])
def test_warp_bicubic_zero(rng, c):
    h, w = 32, 40
    im, flow = _img(rng, h, w, c), _flow(rng, h, w)
    u, v = flow[..., 0], flow[..., 1]
    out = warp.warp_bicubic_zero_multi(_t(im), _t(u), _t(v))
    _close(out, j_warp.warp_bicubic_zero_multi(jnp.asarray(im), jnp.asarray(u),
                                               jnp.asarray(v)), atol=1e-3)
    out1 = warp.warp_bicubic_zero(_t(im[..., 0]), _t(u), _t(v))
    _close(out1, j_warp.warp_bicubic_zero(jnp.asarray(im[..., 0]), jnp.asarray(u),
                                          jnp.asarray(v)), atol=1e-3)


@pytest.mark.parametrize("h,w", [(2, 2), (3, 3), (2, 5), (5, 4)])
def test_warp_bicubic_tiny_frames(rng, h, w):
    """Frames under 4 px a side, as the coarsest TV-L1 levels: no pixel's
    16 taps fit, and no tap may index past the frame."""
    im = _img(rng, h, w, 3)
    u, v = (0.3 * rng.standard_normal((h, w))).astype(np.float32), np.zeros((h, w), np.float32)
    out = warp.warp_bicubic_zero_multi(_t(im), _t(u), _t(v))
    _close(out, j_warp.warp_bicubic_zero_multi(jnp.asarray(im), jnp.asarray(u),
                                               jnp.asarray(v)), atol=1e-3)
    out, valid = warp.warp_bicubic_nan(_t(im), _t(np.stack([u, v], -1)))
    assert not valid.any()
