"""The port's plambda, plambda_calc, imprintf and ``plambda`` command against
the JAX package's, on the expressions and directives the JAX suite uses
(tests/test_plambda_ext.py, tests/test_utils.py, tests/test_round2.py).

Both packages are numpy, so every output must be identical: arrays equal
bit for bit (NaN where NaN), strings equal, the same errors.
"""

import contextlib
import io

import numpy as np
import pytest

from bwd_nlkalman_tpu.cli import plambda as j_cli
from bwd_nlkalman_tpu.utils import imprintf as j_imprintf
from bwd_nlkalman_tpu.utils import plambda as j_plambda
from bwd_nlkalman_tpu.utils.plambda import plambda_calc as j_calc
from bwd_nlkalman_tpu_torch.cli import plambda as cli
from bwd_nlkalman_tpu_torch.io import read_image, write_image
from bwd_nlkalman_tpu_torch.utils import imprintf, plambda
from bwd_nlkalman_tpu_torch.utils.plambda import plambda_calc


def _images(n_channels):
    rng = np.random.default_rng(n_channels)
    if n_channels == 4:      # well-conditioned 2x2 matrices (test_matrix_ops)
        m = rng.normal(0, 1, (6, 7, 4)).astype(np.float32)
        m[..., 0] += 3.0
        m[..., 3] += 3.0
        return (m,)
    if n_channels == 2:      # a flow field (the occlusion formula, polar ops)
        return ((3 * rng.standard_normal((12, 14, 2))).astype(np.float32),)
    a = rng.uniform(1, 200, (16, 24, n_channels)).astype(np.float32)
    b = rng.uniform(1, 200, (16, 24, n_channels)).astype(np.float32)
    return a, b


EXPRS = [
    # stack ops (test_plambda_ext.py)
    (3, "x[0] x[2] x[1] join3"), (3, "x[0] x[2] x[1] join join"),
    (3, "x[0] x[1] x[2] rot join3"), (3, "x split rot join join"),
    (3, "x split rot join3"), (3, "x 5 del"), (3, "x dup + 2 /"),
    (3, "x[0] x[1] x[2] 3 njoin"),
    # registers, colon variables
    (3, "x[0] >1 <1 <1 *"), (3, "x[0] >1 <1 <1 * sqrt"), (3, ":i :j +"),
    (3, ":w :h *"), (3, ":r"), (3, ":i :j + :w /"),
    (3, ":x :y :t :I :J :P :Q :L :R :W :H :n 12 njoin"),
    # vector and matrix operators
    (3, "x vavg"), (3, "x vnorm"), (3, "x vdim"), (3, "x x sprod"), (3, "x x vprod"),
    (3, "x vsum x vmin x vmax x vmul join join join"),
    (2, "x topolar frompolar"), (2, "x x cprod"),
    (4, "x x minv mprod"), (4, "x mtrace"), (4, "x mdet"), (4, "x mtrans"),
    # ternaries and libm
    (3, "x 50 150 bound"), (3, "x[0] 100 > 255 0 if"), (3, "x[0] x[1] hypot"),
    (3, "x 0 360 range"), (3, "x -1 * q255"), (3, "x 0 255 qe 0 255 iqe"),
    (3, "x 3 fmod x 7 remainder x 2 atan2 x 2 fdim join join join"),
    (3, "x log x sqrt x exp2 inftozero nantozero notfintozero join join"),
    # the scripts' expressions (test_utils.py, test_round2.py)
    (1, "x y - 2 ^"), (1, "x x%v -"), (1, "x%s"), (1, "x%r"), (1, "x%q25"),
    (1, "x%i x%a x%m x%q90 join join join"),
    (2, "x(0,0)[0] x(-1,0)[0] - x(0,0)[1] x(0,-1)[1] - + fabs 0.75 > 255 *"),
    (1, "x(1,-2) y(-3,0) + pi * e /"),
]


@pytest.mark.parametrize("channels,expr", EXPRS)
def test_plambda_matches_jax(channels, expr):
    imgs = _images(channels)
    got, want = plambda(expr, *imgs), j_plambda(expr, *imgs)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("expr", ["<3", "x y", "x bogus", "x 1 + 2",
                                  "x x%z"])
def test_plambda_errors_match_jax(expr):
    imgs = _images(3)
    with pytest.raises(Exception) as got:
        plambda(expr, imgs[0])
    with pytest.raises(Exception) as want:
        j_plambda(expr, imgs[0])
    assert (type(got.value), str(got.value)) == (type(want.value), str(want.value))


@pytest.mark.parametrize("expr", ["255 12.5 / log10 20 *", "3 4 2 ^ +",
                                  "255 36.7 sqrt / log10 20 *", "2 pi * sin fabs",
                                  "1 0 / 0 0 / +"])
def test_plambda_calc_matches_jax(expr):
    got, want = plambda_calc(expr), j_calc(expr)
    assert got == want or (np.isnan(got) and np.isnan(want))


FORMATS = ["%N", "%v", "min=%i max=%a", "50% off %v",
           "%q[0] %q[25] %q[100] %r %s %k %y %Y %w %h %c",
           "%v %n %N %i %a %m %e %r %s %k %y %Y %w %h %c %d "
           "%q[0] %q[25] %q[50] %q[75] %q[100] %b %V %S",
           "%I %A %%\\n\\t%V"]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape,seed", [((3, 4), 0), ((17, 23, 1), 7), ((16, 20, 1), 8),
                                        ((11, 13, 3), 9), ((5,), 1)])
def test_imprintf_matches_jax(fmt, shape, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-50, 300, shape).astype(np.float32)
    x.reshape(-1)[0] = x.reshape(-1)[-1]     # a duplicate, for %k
    if seed == 9:
        x[0, 1, 2], x[2, 2, 0] = np.nan, np.inf
    assert imprintf(fmt, x) == j_imprintf(fmt, x)


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("argv", [["-c", "255", "12.5", "/", "log10", "20", "*"],
                                  ["-c", "3 4 2 ^ +"]])
def test_plambda_command_calc_matches_jax(argv):
    assert _stdout(cli.main, argv) == _stdout(j_cli.main, argv)


def test_plambda_command_on_images_matches_jax(tmp_path):
    a, b = _images(1)
    pa, pb = str(tmp_path / "a.tif"), str(tmp_path / "b.png")
    write_image(pa, a)
    write_image(pb, np.round(b))
    expr = "x y - 2 ^"
    # printed statistics, then the written image
    assert _stdout(cli.main, [pa, pb, expr]) == _stdout(j_cli.main, [pa, pb, expr])
    for main, out in ((cli.main, "p.tif"), (j_cli.main, "j.tif")):
        _stdout(main, [pa, pb, expr, "-o", str(tmp_path / out)])
    got, want = read_image(str(tmp_path / "p.tif")), read_image(str(tmp_path / "j.tif"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plambda(expr, a, read_image(pb)))
