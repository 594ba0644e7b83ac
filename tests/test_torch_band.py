"""The band forms G applies (``ops/band_cuda.py``) and the dense products
that stay the plain version, on the CPU.

Every band form scattered back is its numpy matrix exactly, lies in range
and is as wide as the matrix's widest row; G's launch plan holds every
tile of the flow's products at the three pyramids below. The kernel
itself runs on the card only (``tests/test_torch_kernels_cuda.py``).
"""

import numpy as np
import pytest
import torch

from bwd_nlkalman_tpu_torch import kernel_counters
from bwd_nlkalman_tpu_torch.core.engine import nlk_bases
from bwd_nlkalman_tpu_torch.flow import tvl1
from bwd_nlkalman_tpu_torch.ops import band_cuda, gaussian, pyramid, zoom
from bwd_nlkalman_tpu_torch.ops.bases import basis_name, make_bases
from bwd_nlkalman_tpu_torch.pipeline import sequence as seq

SIZES = [(1080, 1920), (400, 400), (25, 41)]
LZ3_SIGMA = 0.7   # the Lanczos-3 recompose's blur at the multiscale default rec


def _dense_keys() -> dict:
    """key -> build of every matrix of the flows at SIZES and of the 1080p
    Lanczos-3 recompose's blur."""
    out = {}
    for h, w in SIZES:
        out.update(tvl1.flow_bases(h, w))
    out.update(pyramid.lanczos3_pyramid_keys(1080, 1920, 4, LZ3_SIGMA))
    return out


DENSE = _dense_keys()


def _pairs(h: int, w: int) -> list:
    """(key_y, key_x, build) of each product of a flow on (h, w) frames."""
    out = [(("blur", h, tvl1.PRESMOOTHING_SIGMA), ("blur", w, tvl1.PRESMOOTHING_SIGMA),
            gaussian.blur_matrix_np)]
    sizes = tvl1._pyramid_sizes(w, h, tvl1.num_scales(w, h, 100, 0.5), 0.5)
    for (pw, ph), (nw, nh) in zip(sizes, sizes[1:]):
        out.append((*zoom.zoom_out_keys(ph, pw, 0.5), zoom._zoom_out_matrix_np))
        out.append((*zoom.zoom_in_keys(nh, nw, pw, ph), zoom._resample_matrix_np))
    return out


PAIRS = [p for h, w in SIZES for p in _pairs(h, w)]


@pytest.mark.parametrize("key", list(DENSE), ids=basis_name)
def test_band_form_is_the_matrix(key):
    m = DENSE[key](*key[1:])
    form = band_cuda.band_of(DENSE[key], *key)
    assert form.dtype == np.int32 and form.shape[0] == m.shape[0]
    lo, w = band_cuda.band_parts(form)
    taps = w.shape[1]
    assert lo.min() >= 0 and (lo + taps).max() <= m.shape[1]
    back = np.zeros_like(m)
    back[np.arange(m.shape[0])[:, None], lo[:, None] + np.arange(taps)] = w
    assert np.array_equal(back, m)
    nz = m != 0
    rows = np.flatnonzero(nz.any(axis=1))
    first = nz[rows].argmax(axis=1)
    last = m.shape[1] - 1 - nz[rows, ::-1].argmax(axis=1)
    assert taps == (last - first).max() + 1


@pytest.mark.parametrize("key_y,key_x,build", PAIRS,
                         ids=[f"{basis_name(a)}-{basis_name(b)}" for a, b, _ in PAIRS])
def test_band_plan_holds_every_tile(key_y, key_x, build):
    """Each tile's staged rows and columns, as csrc/band_sep.cu derives them
    from lo (with and without 16-byte staging), lie in the plane and within
    the plan's rows and pitch, and the plan fits one block."""
    tile_y, tile_x, rows, pitch = band_cuda.band_plan(build, key_y, key_x)
    lo_y, w_y = band_cuda.band_parts(band_cuda.band_of(build, *key_y))
    lo_x, w_x = band_cuda.band_parts(band_cuda.band_of(build, *key_x))
    h, w = build(*key_y[1:]).shape[1], build(*key_x[1:]).shape[1]
    ty, tx = w_y.shape[1], w_x.shape[1]
    staged = -(-rows // 4) * 4
    words = staged * pitch + rows * tile_x + (tx + 1) * tile_x + (ty + 1) * tile_y
    assert 4 * words <= band_cuda.SMEM_BYTES and pitch % 4 == 0 and 256 % tile_x == 0
    for i0 in range(0, len(lo_y), tile_y):
        ly = lo_y[i0:i0 + tile_y]
        assert ly.min() >= 0 and ly.max() + ty <= h and ly.max() + ty - ly.min() <= rows
    for j0 in range(0, len(lo_x), tile_x):
        lx = lo_x[j0:j0 + tile_x]
        assert lx.min() >= 0 and lx.max() + tx <= w and lx.max() + tx - lx.min() <= pitch
        if w % 4 == 0:
            cx0 = lx.min() & ~3
            assert cx0 + (lx.max() + tx - cx0 + 3) // 4 * 4 <= min(w, cx0 + pitch)


@pytest.mark.parametrize("engine", ["auto", "plain"])
def test_cpu_and_plain_take_the_dense_product(engine):
    """On CPU tensors, and with engine="plain", every layout is apply_sep
    plane by plane (the parent's bits), and G is not launched."""
    kernel_counters()["G"].reset()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(0, 255, (2, 25, 41)).astype(np.float32))
    by = torch.from_numpy(gaussian.blur_matrix_np(25, 0.8))
    bx = torch.from_numpy(gaussian.blur_matrix_np(41, 0.8))
    want = torch.stack([gaussian.apply_sep(p, by, bx) for p in x])
    assert torch.equal(gaussian.gaussian_blur(x, 0.8, engine=engine), want)
    assert torch.equal(gaussian.gaussian_blur(x[1], 0.8, engine=engine), want[1])
    last = x.permute(1, 2, 0)
    assert torch.equal(gaussian.gaussian_blur(last, 0.8, engine=engine, planes_last=True),
                       want.permute(1, 2, 0))
    u = torch.from_numpy(rng.uniform(-8, 8, (13, 21, 2)).astype(np.float32))
    want = torch.stack([zoom.zoom_in(u[..., 0], 41, 25), zoom.zoom_in(u[..., 1], 41, 25)],
                       dim=-1) * 2.0
    assert torch.equal(tvl1._zoom_flow(u, 41, 25, 0.5, None, engine), want)
    half = zoom.zoom_out(x, 0.5, engine=engine)
    assert torch.equal(half[0], zoom.zoom_out(x[0].contiguous(), 0.5, engine=engine))
    assert kernel_counters()["G"].count == 0


def test_band_forms_are_registered_buffers():
    """make_bases adds the band form of each blur and zoom matrix of a flow,
    and of no other constant, and the denoiser registers them at set-up."""
    dense = tvl1.flow_bases(24, 32)
    bases = make_bases({**dense, **nlk_bases(8)}, "cpu")
    bands = {basis_name(band_cuda.band_key(k)) for k in dense}
    assert {n for n, t in bases.items() if t.dtype == torch.int32} == bands
    assert set(bases) == bands | {basis_name(k) for k in {**dense, **nlk_bases(8)}}
    names = {n for n, _ in seq.NLKalmanDenoiser(20.0, 24, 32, device="cpu").named_buffers()}
    assert all(any(n.endswith(b) for n in names) for b in bands)
