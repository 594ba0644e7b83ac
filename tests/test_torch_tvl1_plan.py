"""The launch plan of the TV-L1 tile engine that K2 and K3 share, on the CPU.

- ``tile_plan`` fits a block's shared memory at every depth the kernels
  are built for, covers the level with its tiles, and refuses what the
  kernels cannot take.
- ``sub_rounds`` splits every round K2 and K3 run (k_check / k_iters of
  1, 8, 10 and 24) into sub-rounds that sum to it.
- The tile geometry itself: a model of the kernels' tile pass in plain
  PyTorch (regions with a halo of kt, garbage past the region's edge,
  border tests in global coordinates, interiors written back, per-tile
  error partials summed in tile order; with resident tiles, only halo
  rings read back and interior bands written between sub-rounds) gives
  K3's plain block, on ragged levels, a single tile whose halo is the
  frame border, and seams.
- ``tvl1_stage_plain`` is the Python block loop: the same state, and 13
  blocks for a cap of 300 at epsilon 1e-6 (312 iterations).
- The launch counters hold a device int that kernels add to, read once.
"""

import numpy as np
import pytest
import torch

from bwd_nlkalman_tpu_torch._dispatch import LaunchCounter
from bwd_nlkalman_tpu_torch.flow import tvl1_tile, tvl1_tiled
from bwd_nlkalman_tpu_torch.flow.tvl1_block_cuda import tvl1_stage_cuda
from bwd_nlkalman_tpu_torch.flow.tvl1_cuda import tvl1_level_cuda

torch.set_num_threads(1)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("h,w", [(1, 1), (2, 2), (17, 16), (25, 41), (270, 480),
                                 (540, 960), (1080, 1920)])
def test_tile_plan_fits_and_covers(sms, h, w):
    plan = tvl1_tile.tile_plan(h, w, sms)
    kt = plan.kt
    assert plan.smem <= tvl1_tile.SMEM_LIMIT == 227 * 1024
    assert 2 * kt < plan.rows <= tvl1_tile.MAX_ROWS
    assert plan.interior == (plan.rows - 2 * kt, tvl1_tile.COLS - 2 * kt)
    th, tw = plan.interior
    ty, tx = plan.tiles
    # the tiles cover the level, and no tile lies wholly past it
    assert (ty - 1) * th < h <= ty * th and (tx - 1) * tw < w <= tx * tw
    assert tvl1_tile.THREADS % tvl1_tile.COLS == 0


@pytest.mark.parametrize("h,w,sms,rows,tiles", [
    (540, 960, 132, 42, (16, 8)),      # 128 tiles: one wave
    (1080, 1920, 132, 41, (33, 16)),   # 528 tiles: four full waves
    (1080, 1920, 114, 39, (35, 16)),   # an H100 PCIe
])
def test_tile_plan_fills_the_sms(h, w, sms, rows, tiles):
    plan = tvl1_tile.tile_plan(h, w, sms)
    assert (plan.rows, plan.tiles) == (rows, tiles)


@pytest.mark.parametrize("kw", [dict(h=0), dict(w=0)])
def test_tile_plan_refuses(kw):
    args = dict(h=25, w=41) | kw
    with pytest.raises(ValueError):
        tvl1_tile.tile_plan(**args)


def test_tile_plan_refuses_a_region_past_shared_memory(monkeypatch):
    monkeypatch.setattr(tvl1_tile, "MAX_ROWS", 64)
    with pytest.raises(ValueError, match="shared"):
        tvl1_tile.tile_plan(25, 41)


@pytest.mark.parametrize("k", [1, 8, 10, 24])
def test_sub_rounds_sum_to_the_round(k):
    subs = tvl1_tile.sub_rounds(k)
    assert sum(subs) == k
    assert all(1 <= m <= tvl1_tile.KT for m in subs)
    assert len(subs) == -(-k // tvl1_tile.KT)


def test_sub_rounds_refuse_an_empty_round():
    with pytest.raises(ValueError):
        tvl1_tile.sub_rounds(0)


def _level(rng, h, w):
    state = torch.from_numpy(rng.normal(0, 0.5, (6, h, w)).astype(np.float32))
    consts = torch.from_numpy(rng.normal(0, 1, (4, h, w)).astype(np.float32))
    consts[2] = consts[0] ** 2 + consts[1] ** 2
    consts[2, :, : max(1, w // 5)] = 0.0      # some pixels with no gradient
    return state, consts


def _region_iter(st, cs, gy, gx, h, w, l_t, theta, taut):
    """One K3 iteration on a region as the kernel takes it: neighbours past
    the region's edge are garbage (zeros here), borders in global
    coordinates."""
    def prev(a, dim):        # value to the left (dim 1) or above (dim 0)
        return torch.cat([torch.zeros_like(a.narrow(dim, 0, 1)),
                          a.narrow(dim, 0, a.shape[dim] - 1)], dim)

    def nxt(a, dim):         # value to the right or below
        return torch.cat([a.narrow(dim, 1, a.shape[dim] - 1),
                          torch.zeros_like(a.narrow(dim, 0, 1))], dim)

    u1, u2, p11, p12, p21, p22 = st
    i1wx, i1wy, grad, rho_c = cs
    rho = rho_c + i1wx * u1 + i1wy * u2
    fi = torch.where(grad < 1e-10, 0.0, -rho / torch.clamp(grad, min=1e-10))
    lo, hi = rho < -l_t * grad, rho > l_t * grad
    d1 = torch.where(lo, l_t * i1wx, torch.where(hi, -l_t * i1wx, fi * i1wx))
    d2 = torch.where(lo, l_t * i1wy, torch.where(hi, -l_t * i1wy, fi * i1wy))

    def diff(p, g, n, dim):
        q = prev(p, dim)
        return torch.where(g == 0, p, torch.where(g == n - 1, -q, p - q))

    u1n = (u1 + d1) + theta * (diff(p11, gx, w, 1) + diff(p12, gy, h, 0))
    u2n = (u2 + d2) + theta * (diff(p21, gx, w, 1) + diff(p22, gy, h, 0))
    out = [u1n, u2n]
    for un, pa, pb in ((u1n, p11, p12), (u2n, p21, p22)):
        ux = torch.where(gx < w - 1, nxt(un, 1) - un, 0.0)
        uy = torch.where(gy < h - 1, nxt(un, 0) - un, 0.0)
        ng = 1.0 + taut * torch.sqrt(ux * ux + uy * uy)
        out += [(pa + taut * ux) / ng, (pb + taut * uy) / ng]
    return torch.stack([out[0], out[1], out[2], out[3], out[4], out[5]])


def _tiled_block(state, consts, k, sms, resident, tau=0.25, lambda_=0.15, theta=0.3):
    """A block of k iterations as the tile engine runs it: sub-rounds over
    every tile, each writing its interior; the error of the last iteration
    summed per tile, then over the tiles in order. ``resident``: as where
    the grid has a block for every tile, each tile keeps its region from
    one sub-round to the next, reads back only its halo ring, writes only
    the band of its interior that the neighbours' halos read, and its whole
    interior at the end."""
    _, h, w = state.shape
    plan = tvl1_tile.tile_plan(h, w, sms)
    kt, (th, tw), (ty, tx) = plan.kt, plan.interior, plan.tiles
    rows, cols = plan.rows, tvl1_tile.COLS
    l_t = float(np.float32(lambda_ * theta))
    taut = float(np.float32(tau / theta))
    theta = float(np.float32(theta))

    def padded(a):
        out = a.new_zeros((a.shape[0], ty * th + 2 * kt, tx * tw + 2 * kt))
        out[:, kt:kt + h, kt:kt + w] = a
        return out

    cs_p = padded(consts)
    ring = torch.ones((rows, cols), dtype=torch.bool)
    ring[kt:kt + th, kt:kt + tw] = False
    band = torch.zeros((rows, cols), dtype=torch.bool)
    band[kt:kt + th, kt:kt + tw] = True
    band[2 * kt:th, 2 * kt:tw] = False
    regions = {}
    for i, n_iter in enumerate(tvl1_tile.sub_rounds(k)):
        st_p = padded(state)
        new = torch.full_like(state, float("nan"))   # what no tile writes stays NaN
        partials = []
        for t in range(ty * tx):
            y0, x0 = (t // tx) * th, (t % tx) * tw
            gy = torch.arange(rows)[:, None] + y0 - kt
            gx = torch.arange(cols)[None, :] + x0 - kt
            st = st_p[:, y0:y0 + rows, x0:x0 + cols]
            if resident and i > 0:      # the kept region, its ring read back
                st = torch.where(ring, st, regions[t])
            cs = cs_p[:, y0:y0 + rows, x0:x0 + cols]
            for _ in range(n_iter):
                prev_u = st[:2]
                st = _region_iter(st, cs, gy, gx, h, w, l_t, theta, taut)
            regions[t] = st
            own = ((gy >= y0) & (gy < min(y0 + th, h)) & (gx >= x0)
                   & (gx < min(x0 + tw, w)))
            du = torch.where(own, st[:2] - prev_u, 0.0)
            partials.append(torch.sum(du * du))
            out = padded(new)[:, y0:y0 + rows, x0:x0 + cols]
            out = torch.where(band if resident else ~ring, st, out)
            yh, xw = min(th, h - y0), min(tw, w - x0)
            new[:, y0:y0 + yh, x0:x0 + xw] = out[:, kt:kt + yh, kt:kt + xw]
        state = new
    if resident:                        # the whole interiors at the end
        for t, st in regions.items():
            y0, x0 = (t // tx) * th, (t % tx) * tw
            yh, xw = min(th, h - y0), min(tw, w - x0)
            state[:, y0:y0 + yh, x0:x0 + xw] = st[:, kt:kt + yh, kt:kt + xw]
    return state, sum(partials) / (h * w)


@pytest.mark.parametrize("h,w", [(2, 2), (17, 16), (25, 41), (37, 53), (70, 130),
                                 (90, 250)])
@pytest.mark.parametrize("k", [1, 10, 24])
@pytest.mark.parametrize("resident", [False, True])
def test_tile_geometry_gives_the_plain_block(rng, h, w, k, resident):
    """On 8 SMs, so that the larger levels take several tiles, and so
    several region heights."""
    state, consts = _level(rng, h, w)
    got, got_err = _tiled_block(state, consts, k, 8, resident)
    want, want_err = tvl1_tiled.tvl1_block_plain(state, consts, k)
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-5)
    torch.testing.assert_close(got_err, want_err, rtol=1e-5, atol=0.0)


def test_stage_plain_is_the_block_loop(rng, monkeypatch):
    """13 blocks for a cap of 300 at epsilon 1e-6, the state of the Python
    loop over tvl1_block."""
    h, w = 25, 41
    base = np.cumsum(np.cumsum(rng.normal(size=(h + 8, w + 8)), 0), 1)
    base = ((base - base.min()) / (base.max() - base.min()) * 255).astype(np.float32)
    i0, i1 = torch.from_numpy(base[4:4 + h, 4:4 + w]), torch.from_numpy(base[2:2 + h, 5:5 + w])
    state = i0.new_zeros((6, h, w))
    consts = tvl1_tiled.tvl1_stage_consts_plain(
        torch.stack([i1, *tvl1_tiled.centered_gradient(i1)], -1), state, i0)
    calls = []

    def count(*args, **kw):
        calls.append(args[2])
        return tvl1_tiled.tvl1_block_plain(*args[:6])

    monkeypatch.setattr(tvl1_tiled, "tvl1_block", count)
    got, blocks = tvl1_tiled.tvl1_stage_plain(state, consts, 24, 300, 1e-6)
    assert blocks == 13 and calls == [24] * 13
    want, n = state, 0
    err = float("inf")
    while err > np.float32(1e-12) and n < 300:
        want, err_t = tvl1_tiled.tvl1_block_plain(want, consts, 24)
        err, n = float(err_t), n + 24
    assert n == 312
    assert torch.equal(got, want)


def test_tvl1_wrappers_take_cuda_tensors_only():
    z = torch.zeros((6, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tvl1_stage_cuda(z, z[:4], 24, 300, 0.01)
    with pytest.raises(ValueError, match="CUDA"):
        tvl1_level_cuda(z[0], z[0], torch.zeros((4, 4, 2)))


def test_launch_counter_adds_device_counts_lazily():
    c = LaunchCounter()
    c.add()
    slot = c.slot(torch.device("cpu"))
    assert c.slot(torch.device("cpu")) is slot
    slot += 12           # what a kernel does on the device
    c.add(2)
    assert c.count == 15
    c.reset()
    assert c.count == 0 and int(slot) == 0
