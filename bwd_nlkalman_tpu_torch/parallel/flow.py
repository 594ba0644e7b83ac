"""TV-L1 flow, occlusion and warps row-sharded over a mesh's 'sp' axis.

The JAX package needs no such module: its sharded sequence leaves flow,
occlusion and warps to GSPMD, which partitions them along the same 'sp'
rows as the NL-Kalman passes (JAX parallel/sequence.py:7-14). Here one
process drives the shards (``mesh.py``). Each step takes whole tensors
on the row's first device, runs every shard's rows on the shard's device
and gathers the result there:

- a level's solve, at the rule and check granularity of the whole-frame
  dispatch (``flow/tvl1.py::_solve_level``): K2's clamp form checked every
  ``tvl1._k_check`` iterations where ``fused_level_supported``, else K3's
  where form in blocks of ``tvl1_tiled.K_ITERS``. A shard keeps its rows
  and a halo of k rows from each neighbour (the rows k iterations reach)
  for the whole level (``state_dtype`` reaches K2's rounds, and K4's
  constants then take the form of K2's bf16 rule, as the whole level
  computes them). Per warp stage, K4's TV-L1 entry writes the
  constants of its rows plus halo (the source, I1 and its gradient, copied
  to each shard's device once per level: a tap reaches as far as the flow
  does). Then rounds of k iterations: each shard's round launch (K2's or
  K3's round entry) writes its owned rows' sum to its slot on its device,
  the slots go to the other devices (none where the shards share one),
  and the next round's launches add them in shard order and run, or stop
  and clear the device's flag (``tvl1_tile.RoundCtl``); then the halo
  rows are traded. The host issues every round without waiting for it; it
  reads the first device's flag (``_FlagWatch``) of a round at most
  ``FLAG_LAG`` rounds behind the one it issues, and stops issuing rounds
  once it sees a 0, so up to ``FLAG_LAG`` rounds after the stop are
  launched and exit at once;
- the warm gate's sums: each shard's own rows' partials, added in shard
  order;
- occlusion: the divergence of a shard's rows, with the one row above
  that ``dv`` reads (``flow/occlusion.py``);
- the bicubic warps (K4's shard form): each shard warps its own output
  rows and reads the whole source frame, copied to its device once a warp.

The image preparation, the pyramid's zooms and the flow's upscaling run
on whole frames on the row's first device (``tvl1.FlowOps``): a product
over a shard's rows alone sums in another order than the whole frame's,
which on an H100 moved single pixels of a 1080p flow by up to 0.39 px.

The small-level rule: a level is solved whole on the row's first device
where a shard would own fewer rows than its halo of k rows. ``STATS``
counts which ran how.

The result is the whole-frame flow up to the order of the stopping sums:
every pixel is computed as the whole frame computes it, so the flows are
the same wherever no round's error sits at epsilon.
"""

from __future__ import annotations

import dataclasses

import torch

from ..flow import tvl1, tvl1_tiled
from ..flow.occlusion import occlusion_mask
from ..flow.tvl1_fused import tvl1_level_round
from ..flow.tvl1_tile import RoundCtl
from ..flow.tvl1_tiled import tvl1_stage_consts, tvl1_stage_round
from ..ops.grad import centered_gradient
from ..ops.warp import bicubic_warp
from .mesh import Mesh

FLAG_LAG = 2    # rounds the host may issue past the last flag it has read


@dataclasses.dataclass
class FlowStats:
    """What the sharded steps ran: the levels solved whole (small-level
    rule) and sharded, as (h, w) or (h, w, sp); the rounds issued to each
    shard, by rule ("k2", "k3"); the warp stages of the sharded levels and
    the sharded warm gates (each one K4 launch a shard)."""

    levels_whole: list = dataclasses.field(default_factory=list)
    levels_sharded: list = dataclasses.field(default_factory=list)
    rounds: dict = dataclasses.field(default_factory=lambda: {"k2": 0, "k3": 0})
    stages: int = 0
    gates: int = 0

    def reset(self) -> None:
        self.__init__()


STATS = FlowStats()


def row_bounds(h: int, sp: int) -> list[tuple[int, int]]:
    """The rows [r0, r1) each of ``sp`` shards owns of an h-row frame."""
    return [(i * h // sp, (i + 1) * h // sp) for i in range(sp)]


class _FlagWatch:
    """The host's view of a level's stop-or-go flag on the first device:
    whether a round's flag read 0, at most ``FLAG_LAG`` rounds behind the
    round just issued. A CUDA flag is copied to its round's slot of one
    pinned buffer behind one of a ring of events, and the host waits only
    when it runs further ahead; a CPU flag is read at once."""

    def __init__(self, flag: torch.Tensor, n_rounds: int):
        self.flag, self.issued, self.read = flag, 0, 0
        if flag.device.type == "cuda":
            self.host = torch.empty(n_rounds, dtype=torch.int32, pin_memory=True)
            self.vals = self.host.numpy()
            self.events = [torch.cuda.Event() for _ in range(FLAG_LAG + 1)]
            self.stream = torch.cuda.current_stream(flag.device)

    def stage(self) -> None:
        """A new warp stage: the flags of the last one still unread go."""
        self.read = self.issued

    def stopped(self) -> bool:
        if self.flag.device.type != "cuda":
            return not bool(self.flag)
        i, ring = self.issued, len(self.events)
        self.host[i:i + 1].copy_(self.flag, non_blocking=True)
        self.events[i % ring].record(self.stream)
        self.issued += 1
        while self.read < self.issued:
            ev = self.events[self.read % ring]
            if self.issued - self.read <= FLAG_LAG and not ev.query():
                break
            ev.synchronize()
            self.read += 1
            if self.vals[self.read - 1] == 0:
                return True
        return False


class ShardedFlowOps(tvl1.FlowOps):
    """The steps of ``tvl1.flow_pyramid`` row-sharded over ``devs`` (the
    'sp' devices of one mesh row; whole tensors on ``devs[0]``)."""

    def __init__(self, devs, zfactor, bases, engine, tau, lambda_, theta, epsilon,
                 state_dtype="float32"):
        super().__init__(zfactor, bases, engine, tau, lambda_, theta, epsilon, state_dtype)
        self.devs = tuple(devs)

    def solve(self, a, b, u, nwarps, max_iters):
        h, w = a.shape
        k2 = tvl1.fused_level_supported(h, w)
        k = tvl1._k_check(h * w) if k2 else tvl1_tiled.K_ITERS
        own = row_bounds(h, len(self.devs))
        if min(r1 - r0 for r0, r1 in own) < k:     # the small-level rule
            STATS.levels_whole.append((h, w))
            return super().solve(a, b, u, nwarps, max_iters)
        STATS.levels_sharded.append((h, w, len(self.devs)))
        return _solve_sharded(a, b, u, self.devs, own, k, k2, nwarps, max_iters,
                              self.engine, self.state_dtype, **self.kw)

    def gate(self, a, b, u0) -> bool:
        return bool(_warm_gate(a, b, u0, self.devs, self.engine)[0])


def _trade_halos(states, own, ext) -> None:
    """Each shard's halo rows from its neighbours' own rows, in place."""
    for i, (st, (r0, r1), (e0, e1)) in enumerate(zip(states, own, ext)):
        if r0 > e0:
            p0 = ext[i - 1][0]
            st[:, :r0 - e0].copy_(states[i - 1][:, e0 - p0:r0 - p0])
        if e1 > r1:
            n0 = ext[i + 1][0]
            st[:, r1 - e0:].copy_(states[i + 1][:, r1 - n0:e1 - n0])


def _share_sums(ctls: dict, devs, r: int) -> None:
    """Each shard's sum of round r to the other devices' ``RoundCtl``."""
    if len(ctls) == 1:
        return
    p = r % 2
    for i, dev in enumerate(devs):
        src = ctls[dev].sums[p, i:i + 1]
        for other, ctl in ctls.items():
            if other != dev:
                ctl.sums[p, i:i + 1].copy_(src, non_blocking=True)


def _solve_sharded(a, b, u, devs, own, k, k2, nwarps, max_iters, engine, state_dtype, tau,
                   lambda_, theta, epsilon):
    """One level on row blocks (the module docstring); (h, w, 2) on devs[0].
    ``state_dtype`` reaches K2's rounds only, as the whole level's."""
    h, w = a.shape
    first = devs[0]
    ext = [(max(0, r0 - k), min(h, r1 + k)) for r0, r1 in own]
    halos = [(r0 - e0, e1 - r1) for (r0, r1), (e0, e1) in zip(own, ext)]
    i1s = torch.stack([b, *centered_gradient(b)], dim=-1)
    i1s_d = [i1s.to(d) for d in devs]
    a_d = [a[e0:e1].to(d).contiguous() for (e0, e1), d in zip(ext, devs)]
    states = [torch.cat([u[e0:e1].permute(2, 0, 1).to(d, torch.float32),
                         torch.zeros((4, e1 - e0, w), dtype=torch.float32, device=d)])
              for (e0, e1), d in zip(ext, devs)]
    ctls = {d: RoundCtl(len(devs), d, epsilon, h, w) for d in dict.fromkeys(devs)}
    step = tvl1_level_round if k2 else tvl1_stage_round
    kw = dict(tau=tau, lambda_=lambda_, theta=theta, engine=engine)
    if k2:
        kw["state_dtype"] = state_dtype
    n_rounds = -(-max_iters // k)
    watch = _FlagWatch(ctls[first].flag, nwarps * n_rounds)
    for _ in range(nwarps):
        STATS.stages += 1
        consts = [tvl1_stage_consts(i1s_d[i], states[i], a_d[i], engine, ext[i][0], nig=k2,
                                    state_dtype=state_dtype)
                  for i in range(len(devs))]
        watch.stage()
        for r in range(n_rounds):
            for i, d in enumerate(devs):
                states[i] = step(states[i], consts[i], k, ext[i][0], h, halos[i], ctls[d], i,
                                 r, count=i == 0, **kw)
            _share_sums(ctls, devs, r)
            _trade_halos(states, own, ext)
            STATS.rounds["k2" if k2 else "k3"] += 1
            if watch.stopped():
                break
    return torch.cat([st[:2, r0 - e0:r1 - e0].to(first)
                      for st, (r0, r1), (e0, _) in zip(states, own, ext)],
                     dim=1).permute(1, 2, 0).contiguous()


def _warm_gate(a, b, u0, devs, engine):
    """``tvl1.warm_gate`` from each shard's own rows' sums (the warp of its
    rows reads the whole of b), added in shard order on devs[0]."""
    h, w = a.shape
    STATS.gates += 1
    parts = []
    for (r0, r1), dev in zip(row_bounds(h, len(devs)), devs):
        bd = b.to(dev)
        bw, valid = bicubic_warp(bd[..., None].contiguous(), u0[r0:r1].to(dev).contiguous(),
                                 None, engine, r0)
        v = valid.to(torch.float32)
        ad = a[r0:r1].to(dev)
        parts.append(torch.stack([v.sum(), torch.sum(torch.abs(ad - bw[..., 0]) * v),
                                  torch.sum(torch.abs(ad - bd[r0:r1]) * v)]).to(devs[0]))
    vs, warm, zero = torch.stack(parts).sum(dim=0)
    n = torch.clamp(vs, min=1.0)
    r_warm, r_zero = warm / n, zero / n
    return (r_warm <= r_zero) & (vs >= 0.5 * h * w), r_warm, r_zero


def _ops(mesh: Mesh, row: int, zfactor, bases, engine, tau, lambda_, theta, epsilon,
         state_dtype):
    return ShardedFlowOps(mesh.devices[row], zfactor, bases, engine, tau, lambda_, theta,
                          epsilon, state_dtype)


def sharded_tvl1_flow(i0, i1, mesh: Mesh, tau=0.25, lambda_=0.15, theta=0.3, nscales=100,
                      fscale=0, zfactor=0.5, nwarps=5, epsilon=0.01,
                      max_iters: int | None = None, return_carry: bool = False,
                      bases=None, engine: str = "auto", row: int = 0,
                      state_dtype: str = "float32"):
    """``tvl1.tvl1_flow`` row-sharded over batch row ``row`` of the mesh:
    i0, i1 and the result on its first device (``bases`` built there)."""
    ops = _ops(mesh, row, zfactor, bases, engine, tau, lambda_, theta, epsilon, state_dtype)
    return tvl1.flow_pyramid(i0, i1, ops, nscales, fscale, zfactor, nwarps, max_iters,
                             return_carry)


def sharded_tvl1_flow_warm(i0, i1, u_carry, mesh: Mesh, tau=0.25, lambda_=0.15, theta=0.3,
                           nscales=100, fscale=0, zfactor=0.5, nwarps=5, epsilon=0.01,
                           max_iters: int | None = None, warm_nwarps: int | None = None,
                           warm_max_iters: int | None = None, bases=None,
                           engine: str = "auto", row: int = 0,
                           state_dtype: str = "float32"):
    """``tvl1.tvl1_flow_warm`` row-sharded over batch row ``row`` of the
    mesh: (flow, level-fscale carry) on its first device."""
    ops = _ops(mesh, row, zfactor, bases, engine, tau, lambda_, theta, epsilon, state_dtype)
    return tvl1.flow_pyramid_warm(i0, i1, u_carry, ops, nscales, fscale, zfactor, nwarps,
                                  max_iters, warm_nwarps, warm_max_iters)


def sharded_warm_gate(a, b, u0, mesh: Mesh, engine: str = "auto", row: int = 0):
    """``tvl1.warm_gate`` (ok, r_warm, r_zero) from the shards' sums."""
    return _warm_gate(a, b, u0, mesh.devices[row], engine)


def sharded_occlusion_mask(flow, mesh: Mesh, threshold: float = 0.75, row: int = 0):
    """``occlusion_mask`` of each shard's rows (with the row above that the
    divergence reads), whole on the row's first device."""
    devs = mesh.devices[row]
    outs = []
    for (r0, r1), dev in zip(row_bounds(flow.shape[0], len(devs)), devs):
        top = min(r0, 1)
        outs.append(occlusion_mask(flow[r0 - top:r1].to(dev), threshold, top).to(devs[0]))
    return torch.cat(outs)


def sharded_warp(im, flow, occl, mesh: Mesh, engine: str = "auto", row: int = 0):
    """``ops.warp.bicubic_warp`` (K4's shard form on the card): each shard
    warps its own output rows, reading the whole source ``im`` (H, W, C),
    copied to its device. (out, valid) whole on the row's first device."""
    devs = mesh.devices[row]
    outs, valids = [], []
    for (r0, r1), dev in zip(row_bounds(im.shape[0], len(devs)), devs):
        o, v = bicubic_warp(im.to(dev).contiguous(), flow[r0:r1].to(dev).contiguous(),
                            None if occl is None else occl[r0:r1].to(dev).contiguous(),
                            engine, r0)
        outs.append(o.to(devs[0]))
        valids.append(v.to(devs[0]))
    return torch.cat(outs), torch.cat(valids)
