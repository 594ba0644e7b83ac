"""Sequence denoising: the port of ``bwd_nlkalman_tpu.pipeline.sequence``.

Forward filtering runs over the frames with the carry {flt1, flt2} (and,
with warm-started flow, the level-fscale flow): per frame a TV-L1
backward flow on luma, the divergence occlusion mask, one bicubic warp
of the previous flt1|flt2 pair and two NL-Kalman filter passes in OPP
color. Backward RTS smoothing then runs in reverse with a forward flow,
the occlusion mask, a warp and one smoother pass per frame. The JAX
package's ``lax.scan`` is a Python loop here; the warm-start gate is a
Python branch (one host sync per frame). Given a ``parallel`` mesh, the
sequence drivers run every NL-Kalman pass, and the flows, occlusion
masks and warps (``parallel/flow.py``), row-sharded over it.

While a torch profiler runs, each flow, occlusion mask, warp and
NL-Kalman pass is a layer span, and ``NLKalmanDenoiser.forward`` the
request's span, which takes K2's iteration counter
(``utils.profiling.span``, ``last_request``).

The causal smoothers run here too: fsmo smooths each frame against the
previous smoothed frame inside the forward loop, reusing its flow and
its one warp (all three priors ride it); lsmo smooths frame t-1 against
flt2_t along the forward flow once frame t is filtered.

Frames are (T, H, W, C) float32 in [0, 255]. ``engine="auto"`` runs the
hand-written kernels on CUDA tensors and the plain versions on CPU
tensors; ``engine="plain"`` runs the plain versions on any device.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .._dispatch import (check_engine, check_state_dtype, check_window_dtype, entry_device,
                         runs_kernels)
from ..core import nlkalman_filter_frame, nlkalman_smooth_frame
from ..core.engine import nlk_bases
from ..core.nlkalman import note_plain_routes
from ..flow.occlusion import occlusion_mask
from ..flow.tvl1 import flow_bases, luma, tvl1_flow, tvl1_flow_warm
from ..flow.tvl1_cuda import ITERATIONS
from ..ops.bases import make_bases
from ..ops.color import opp2rgb, rgb2opp
from ..ops.warp import warp_bicubic_nan
from ..params import FilterMode, NLKParams, default_params
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Optical-flow parameters as the pipeline scripts pass them
    (scripts/nlkalman-seq.sh:12,47-51); fields as in the JAX package, and
    ``state_dtype``, the type of K2's dual planes ("float32" or
    "bfloat16"), which the JAX package reads from its
    ``BNLK_TVL1_STATE_DTYPE`` environment variable."""

    fscale: int = 1
    lambda_: float = 0.25
    occ_threshold: float = 0.75
    tau: float = 0.25
    theta: float = 0.3
    nscales: int = 100
    zfactor: float = 0.5
    nwarps: int = 5
    epsilon: float = 0.01
    max_iters: int | None = None      # None = MAX_ITERATIONS (300)
    warm_start: bool = False
    warm_nwarps: int | None = None
    warm_max_iters: int | None = None
    state_dtype: str = "float32"

    def __post_init__(self):
        check_state_dtype(self.state_dtype)

    def _kw(self):
        return dict(tau=self.tau, lambda_=self.lambda_, theta=self.theta,
                    nscales=self.nscales, fscale=self.fscale,
                    zfactor=self.zfactor, nwarps=self.nwarps,
                    epsilon=self.epsilon, max_iters=self.max_iters,
                    state_dtype=self.state_dtype)

    # each with a ``mesh``: row-sharded over it (parallel/flow.py); each a
    # "flow" span (utils.profiling.span)
    def flow(self, i0, i1, engine="auto", bases=None, mesh=None):
        with span("flow", i0.device):
            if mesh is not None:
                from ..parallel.flow import sharded_tvl1_flow  # parallel imports this module
                return sharded_tvl1_flow(i0, i1, mesh, engine=engine, bases=bases,
                                         **self._kw())
            return tvl1_flow(i0, i1, engine=engine, bases=bases, **self._kw())

    def flow_cold_carry(self, i0, i1, engine="auto", bases=None, mesh=None):
        """Full-pyramid solve that also returns the warm-start carry."""
        with span("flow", i0.device):
            if mesh is not None:
                from ..parallel.flow import sharded_tvl1_flow
                return sharded_tvl1_flow(i0, i1, mesh, return_carry=True, engine=engine,
                                         bases=bases, **self._kw())
            return tvl1_flow(i0, i1, return_carry=True, engine=engine,
                             bases=bases, **self._kw())

    def flow_warm(self, i0, i1, u_carry, engine="auto", bases=None, mesh=None):
        """Level-fscale-only solve initialised from the carried flow."""
        kw = dict(warm_nwarps=self.warm_nwarps, warm_max_iters=self.warm_max_iters,
                  engine=engine, bases=bases, **self._kw())
        with span("flow", i0.device):
            if mesh is not None:
                from ..parallel.flow import sharded_tvl1_flow_warm
                return sharded_tvl1_flow_warm(i0, i1, u_carry, mesh, **kw)
            return tvl1_flow_warm(i0, i1, u_carry, **kw)


def _occlusion(flow, occ, mesh=None):
    """The (H, W) occlusion mask of a warp along ``flow``: ``occ`` as it is
    where it is a ready mask (a float32 tensor, nonzero = occluded, as the
    training fixtures store it), else the divergence mask of ``flow`` at
    the threshold ``occ``, row-sharded over a ``mesh``."""
    with span("occlusion", flow.device):
        if isinstance(occ, torch.Tensor):
            return occ
        if mesh is not None:
            from ..parallel.flow import sharded_occlusion_mask  # parallel imports this module
            return sharded_occlusion_mask(flow, mesh, occ)
        return occlusion_mask(flow, occ)


def _warp(im, flow, occl, engine="auto", mesh=None):
    """``warp_bicubic_nan`` of the (H, W, C) frame ``im``, or with a mesh its
    row-sharded form (K4's shard form on the card)."""
    with span("warp", im.device):
        if mesh is None:
            return warp_bicubic_nan(im, flow, occl, engine=engine)
        from ..parallel.flow import sharded_warp  # parallel imports this module
        return sharded_warp(im, flow, occl, mesh, engine)


def _filter_pass(nisy, deno0, valid, basic, sigma, prms, mesh=None, **kw):
    """``nlkalman_filter_frame``, or with a mesh its row-sharded form."""
    with span("nlk", nisy.device):
        if mesh is None:
            return nlkalman_filter_frame(nisy, deno0, valid, basic, sigma, prms, **kw)
        from ..parallel.spatial import spatial_filter_frame  # parallel imports this module
        return spatial_filter_frame(nisy, deno0, valid, basic, sigma, prms, mesh, **kw)


def _smooth_pass(filt1, smoo0, valid, sigma, prms, mesh=None, **kw):
    """``nlkalman_smooth_frame``, or with a mesh its row-sharded form."""
    with span("nlk", filt1.device):
        if mesh is None:
            return nlkalman_smooth_frame(filt1, smoo0, valid, sigma, prms, **kw)
        from ..parallel.spatial import spatial_smooth_frame  # parallel imports this module
        return spatial_smooth_frame(filt1, smoo0, valid, sigma, prms, mesh, **kw)


def _warp_passes(noisy, prevs, flow, occ, sigma, p1, p2, engine="auto",
                 bases=None, window_dtype="float32", mesh=None):
    """The two filter passes of ``noisy`` given the backward flow and the
    previous outputs ``prevs`` (RGB: flt1, flt2 and, for fsmo, smo). All
    of them ride one warp: same flow, same validity. ``occ`` is the
    occlusion threshold or a ready mask (:func:`_occlusion`). Returns
    (f11, f21) in OPP, the warped priors after the first two (OPP) and the
    validity. With a ``mesh`` the occlusion, the warp and the two passes
    are row-sharded over it."""
    n_opp = rgb2opp(noisy)
    c = noisy.shape[-1]
    wt, v1 = _warp(torch.cat([rgb2opp(p) for p in prevs], dim=-1), flow,
                   _occlusion(flow, occ, mesh), engine, mesh)
    kw = dict(engine=engine, bases=bases, window_dtype=window_dtype)
    f11 = _filter_pass(n_opp, wt[..., :c], v1, None, sigma, p1, mesh, **kw)
    f21 = _filter_pass(n_opp, wt[..., c:2 * c], v1, f11, sigma, p2, mesh, **kw)
    return f11, f21, wt[..., 2 * c:], v1


def _filter_with_flow(noisy, flt1_prev, flt2_prev, flow, occ, sigma, p1, p2,
                      engine="auto", bases=None, window_dtype="float32", mesh=None):
    """Two-pass filtering given an already-computed backward flow and the
    occlusion threshold or a ready mask."""
    f11, f21, _, _ = _warp_passes(noisy, (flt1_prev, flt2_prev), flow, occ,
                                  sigma, p1, p2, engine, bases, window_dtype, mesh)
    return opp2rgb(f11), opp2rgb(f21)


def fsmo_step(noisy, flt1_prev, flt2_prev, smo_prev, flow, occ_th, sigma, p1,
              p2, ps, engine="auto", bases=None, window_dtype="float32"):
    """One fsmo step (JAX sequence.py:364-385) given the backward flow:
    the two filter passes and the smoother pass of the current frame
    against smo_prev, all three priors warped in one call. The smoother
    takes the second pass's output in OPP as it comes, not through an RGB
    round trip. Returns (flt1, flt2, smo) in RGB."""
    f11, f21, ws, v1 = _warp_passes(noisy, (flt1_prev, flt2_prev, smo_prev),
                                    flow, occ_th, sigma, p1, p2, engine, bases,
                                    window_dtype)
    with span("nlk", f21.device):
        smo = nlkalman_smooth_frame(f21, ws, v1, sigma, ps, engine=engine,
                                    bases=bases, window_dtype=window_dtype)
    return opp2rgb(f11), opp2rgb(f21), opp2rgb(smo)


def smooth_with_flow(frame_flt2, smo_next, flow, occ, sigma, ps,
                     engine="auto", bases=None, window_dtype="float32", mesh=None):
    """One smoother pass of ``frame_flt2`` against ``smo_next`` warped
    along ``flow`` (RGB in and out); ``occ`` is the occlusion threshold or
    a ready mask (:func:`_occlusion`). With a ``mesh`` the occlusion, the
    warp and the pass are row-sharded over it."""
    w0, v0 = _warp(rgb2opp(smo_next), flow, _occlusion(flow, occ, mesh), engine, mesh)
    return opp2rgb(_smooth_pass(rgb2opp(frame_flt2), w0, v0, sigma, ps, mesh,
                                engine=engine, bases=bases,
                                window_dtype=window_dtype))


def smooth_pair(frame, nxt, sigma, ps, flow_cfg: FlowConfig, engine="auto",
                bases=None, window_dtype="float32", mesh=None):
    """:func:`smooth_with_flow` along the cold flow from ``frame`` to
    ``nxt``: a step of the RTS smoother, of lsmo and of the lz3 smoother."""
    flow = flow_cfg.flow(luma(frame), luma(nxt), engine, bases, mesh)
    return smooth_with_flow(frame, nxt, flow, flow_cfg.occ_threshold, sigma,
                            ps, engine, bases, window_dtype, mesh)


def filter_frame_pair(noisy, flt1_prev, flt2_prev, sigma, p1, p2,
                      flow_cfg: FlowConfig = FlowConfig(), engine="auto",
                      bases=None, window_dtype="float32", mesh=None):
    """Two-pass filtering of one frame given the previous outputs (RGB
    in/out); with no previous frame, the spatial-only first-frame path."""
    if flt2_prev is None:
        n_opp = rgb2opp(noisy)
        kw = dict(engine=engine, bases=bases, window_dtype=window_dtype)
        f11 = _filter_pass(n_opp, None, None, None, sigma, p1, mesh, **kw)
        f21 = _filter_pass(n_opp, None, None, f11, sigma, p2, mesh, **kw)
        return opp2rgb(f11), opp2rgb(f21)
    flow = flow_cfg.flow(luma(noisy), luma(flt2_prev), engine, bases, mesh)
    return _filter_with_flow(noisy, flt1_prev, flt2_prev, flow,
                             flow_cfg.occ_threshold, sigma, p1, p2, engine,
                             bases, window_dtype, mesh)


def filter_step_warm(frame, carry, sigma, p1, p2, flow_cfg: FlowConfig,
                     engine="auto", bases=None, window_dtype="float32", mesh=None):
    """One warm-started forward step (the JAX scan body, sequence.py:174-181).

    carry = (flt1_prev, flt2_prev, u_fs). Returns (new carry, (flt1, flt2)).
    """
    flt1_prev, flt2_prev, u_c = carry
    flow, u_c = flow_cfg.flow_warm(luma(frame), luma(flt2_prev), u_c, engine,
                                   bases, mesh)
    f11, f21 = _filter_with_flow(frame, flt1_prev, flt2_prev, flow,
                                 flow_cfg.occ_threshold, sigma, p1, p2,
                                 engine, bases, window_dtype, mesh)
    return (f11, f21, u_c), (f11, f21)


def filter_sequence(noisy, sigma, p1: NLKParams | None = None,
                    p2: NLKParams | None = None,
                    flow_cfg: FlowConfig = FlowConfig(), engine="auto",
                    bases=None, window_dtype="float32", mesh=None):
    """Forward-filter a (T, H, W, C) sequence -> (flt1, flt2) stacks; with
    a ``mesh`` the flows, masks, warps and NL-Kalman passes are row-sharded
    over it."""
    p1 = p1 or default_params(sigma, FilterMode.FLT1)
    p2 = p2 or default_params(sigma, FilterMode.FLT2)
    f11, f21 = filter_frame_pair(noisy[0], None, None, sigma, p1, p2, flow_cfg,
                                 engine, bases, window_dtype, mesh)
    flt1, flt2 = [f11], [f21]
    if flow_cfg.warm_start and noisy.shape[0] > 1:
        # frame 1 is peeled: its flow runs the cold pyramid and seeds the
        # level-fscale carry; every further step warm-starts from it
        flow1, u_fs = flow_cfg.flow_cold_carry(luma(noisy[1]), luma(f21),
                                               engine, bases, mesh)
        f11, f21 = _filter_with_flow(noisy[1], f11, f21, flow1,
                                     flow_cfg.occ_threshold, sigma, p1, p2,
                                     engine, bases, window_dtype, mesh)
        flt1.append(f11)
        flt2.append(f21)
        carry = (f11, f21, u_fs)
        for t in range(2, noisy.shape[0]):
            carry, (f11, f21) = filter_step_warm(noisy[t], carry, sigma, p1,
                                                 p2, flow_cfg, engine, bases,
                                                 window_dtype, mesh)
            flt1.append(f11)
            flt2.append(f21)
    else:
        for t in range(1, noisy.shape[0]):
            f11, f21 = filter_frame_pair(noisy[t], f11, f21, sigma, p1, p2,
                                         flow_cfg, engine, bases, window_dtype,
                                         mesh)
            flt1.append(f11)
            flt2.append(f21)
    return torch.stack(flt1), torch.stack(flt2)


def smooth_sequence(flt2, sigma, ps: NLKParams | None = None,
                    flow_cfg: FlowConfig = FlowConfig(), engine="auto",
                    bases=None, window_dtype="float32", mesh=None):
    """Backward RTS smoothing of the filtered stack (T, H, W, C) -> smo1;
    with a ``mesh`` the flows, masks, warps and NL-Kalman passes are
    row-sharded over it."""
    ps = ps or default_params(sigma, FilterMode.SMO1)
    occ_th = flow_cfg.occ_threshold
    n = flt2.shape[0]
    smo = [None] * n
    smo[-1] = flt2[-1]
    if n == 1:
        return torch.stack(smo)
    if flow_cfg.warm_start:
        # frame T-2 is peeled: the cold pyramid seeds the carry
        flow1, u_c = flow_cfg.flow_cold_carry(luma(flt2[-2]), luma(smo[-1]),
                                              engine, bases, mesh)
        smo[-2] = smooth_with_flow(flt2[-2], smo[-1], flow1, occ_th, sigma, ps,
                                   engine, bases, window_dtype, mesh)
        for t in range(n - 3, -1, -1):
            flow, u_c = flow_cfg.flow_warm(luma(flt2[t]), luma(smo[t + 1]),
                                           u_c, engine, bases, mesh)
            smo[t] = smooth_with_flow(flt2[t], smo[t + 1], flow, occ_th, sigma,
                                      ps, engine, bases, window_dtype, mesh)
    else:
        for t in range(n - 2, -1, -1):
            smo[t] = smooth_pair(flt2[t], smo[t + 1], sigma, ps, flow_cfg,
                                 engine, bases, window_dtype, mesh)
    return torch.stack(smo)


def filter_sequence_precomputed(noisy, bflow, bocc, sigma,
                                p1: NLKParams | None = None,
                                p2: NLKParams | None = None, engine="auto",
                                bases=None, window_dtype="float32"):
    """Forward filtering with a GIVEN backward flow and occlusion mask, the
    training protocol's economy (nlkalman-train.sh:17-28): the flow is
    computed once per (sequence, sigma) from the noisy frames and reused by
    every parameter trial. bflow (T, H, W, 2): flow t -> t-1; bocc (T, H, W)
    float32, nonzero = occluded; frame 0's entries are unused (frame 0 runs
    its two passes with no prior). Returns the (flt1, flt2) stacks."""
    p1 = p1 or default_params(sigma, FilterMode.FLT1)
    p2 = p2 or default_params(sigma, FilterMode.FLT2)
    f11, f21 = filter_frame_pair(noisy[0], None, None, sigma, p1, p2,
                                 engine=engine, bases=bases,
                                 window_dtype=window_dtype)
    flt1, flt2 = [f11], [f21]
    for t in range(1, noisy.shape[0]):
        f11, f21 = _filter_with_flow(noisy[t], f11, f21, bflow[t], bocc[t], sigma,
                                     p1, p2, engine, bases, window_dtype)
        flt1.append(f11)
        flt2.append(f21)
    return torch.stack(flt1), torch.stack(flt2)


def smooth_sequence_precomputed(flt2, fflow, focc, sigma,
                                ps: NLKParams | None = None, engine="auto",
                                bases=None, window_dtype="float32"):
    """Backward RTS smoothing with a GIVEN forward flow and occlusion mask:
    fflow[t] (H, W, 2) is the flow t -> t+1 and focc[t] its mask (nonzero =
    occluded); the last frame's entries are unused. Returns smo1."""
    ps = ps or default_params(sigma, FilterMode.SMO1)
    n = flt2.shape[0]
    smo = [None] * n
    smo[-1] = flt2[-1]
    for t in range(n - 2, -1, -1):
        smo[t] = smooth_with_flow(flt2[t], smo[t + 1], fflow[t], focc[t], sigma,
                                  ps, engine, bases, window_dtype)
    return torch.stack(smo)


def fsmo_sequence(noisy, sigma, p1: NLKParams | None = None,
                  p2: NLKParams | None = None, ps: NLKParams | None = None,
                  flow_cfg: FlowConfig = FlowConfig(), engine="auto",
                  bases=None, window_dtype="float32"):
    """Causal forward smoothing interleaved with filtering
    (scripts/nlkalman-fsmo-seq.sh:60-94): frame t is smoothed against
    smo_{t-1} with the filter step's flow and warp; smo_0 = flt2_0.
    Every step solves the cold flow, as the JAX package's does: fsmo
    ignores ``warm_start``. Returns (flt1, flt2, smo1)."""
    p1 = p1 or default_params(sigma, FilterMode.FLT1)
    p2 = p2 or default_params(sigma, FilterMode.FLT2)
    ps = ps or default_params(sigma, FilterMode.SMO1)
    f11, f21 = filter_frame_pair(noisy[0], None, None, sigma, p1, p2, flow_cfg,
                                 engine, bases, window_dtype)
    outs = [(f11, f21, f21)]
    for t in range(1, noisy.shape[0]):
        f11, f21, smo = outs[-1]
        flow = flow_cfg.flow(luma(noisy[t]), luma(f21), engine, bases)
        outs.append(fsmo_step(noisy[t], f11, f21, smo, flow,
                              flow_cfg.occ_threshold, sigma, p1, p2, ps,
                              engine, bases, window_dtype))
    return tuple(torch.stack(x) for x in zip(*outs))


def lsmo_sequence(flt2, sigma, ps: NLKParams | None = None,
                  flow_cfg: FlowConfig = FlowConfig(), engine="auto",
                  bases=None, window_dtype="float32"):
    """Lag-1 smoother (scripts/nlkalman-lsmo-seq.sh:87-118): frame t-1 is
    smoothed against flt2_t along the cold forward flow flt2_{t-1} ->
    flt2_t; the last frame passes through."""
    ps = ps or default_params(sigma, FilterMode.SMO1)
    lsm = [smooth_pair(flt2[t], flt2[t + 1], sigma, ps, flow_cfg, engine, bases,
                       window_dtype)
           for t in range(flt2.shape[0] - 1)]
    return torch.stack(lsm + [flt2[-1]])


def denoise_sequence(noisy, sigma, p1: NLKParams | None = None,
                     p2: NLKParams | None = None, ps: NLKParams | None = None,
                     flow_cfg: FlowConfig = FlowConfig(), smoothing: bool = True,
                     smooth_flow_cfg: FlowConfig | None = None, engine="auto",
                     bases=None, window_dtype="float32", mesh=None):
    """Two-pass forward filtering + backward smoothing: (flt1, flt2, smo1),
    smo1 None when ``smoothing`` is False. With a ``mesh``
    (``parallel.make_mesh``) every NL-Kalman pass, flow, occlusion mask
    and warp is row-sharded over its 'sp' axis; ``noisy`` then lies on the
    mesh's first device, where whole frames and results live."""
    flt1, flt2 = filter_sequence(noisy, sigma, p1, p2, flow_cfg, engine, bases,
                                 window_dtype, mesh)
    if not smoothing:
        return flt1, flt2, None
    smo1 = smooth_sequence(flt2, sigma, ps, smooth_flow_cfg or flow_cfg,
                           engine, bases, window_dtype, mesh)
    return flt1, flt2, smo1


def denoise_batch(noisy_batch, sigma, engine="auto", bases=None,
                  window_dtype="float32", mesh=None):
    """Denoise a batch of clips (B, T, H, W, C), each with the default flow
    and parameters (JAX sequence.py:454-480). Without a mesh the clips run
    one after the other on the batch's device. With a mesh
    (``parallel.make_mesh``) the batch goes over its 'dp' axis: clips
    [k B/dp, (k+1) B/dp) run, each whole, on the first device of batch row
    k (``bases``, built for the batch's device, serve the clips there).
    Returns the (flt1, flt2, smo1) stacks, each (B, T, H, W, C), on the
    batch's device."""
    if mesh is None:
        devs = [noisy_batch.device] * noisy_batch.shape[0]
    else:
        dp = mesh.shape["dp"]
        if noisy_batch.shape[0] % dp:
            raise ValueError(f"batch {noisy_batch.shape[0]} not divisible by dp={dp}")
        per = noisy_batch.shape[0] // dp
        devs = [mesh.devices[j // per][0] for j in range(noisy_batch.shape[0])]
    outs = [denoise_sequence(clip.to(d), sigma, engine=engine,
                             bases=bases if d == noisy_batch.device else None,
                             window_dtype=window_dtype)
            for clip, d in zip(noisy_batch, devs)]
    return tuple(torch.stack([o.to(noisy_batch.device) for o in x]) for x in zip(*outs))


def pipeline_bases(h: int, w: int, flow_cfgs, params) -> dict:
    """Every numpy-built constant that flows of ``flow_cfgs`` and NLK passes
    of ``params`` use on (h, w) frames: key -> build function."""
    consts = {}
    for cfg in flow_cfgs:
        consts.update(flow_bases(h, w, cfg.nscales, cfg.zfactor))
    for p in params:
        consts.update(nlk_bases(p.patch_sz))
    return consts


SMOOTHERS = ("rts", "fsmo", "lsmo", "none")
# what a traced request takes at its entry and exit (utils.profiling.span)
REQUEST_COUNTERS = {"k2_iterations": ITERATIONS}


class PipelineModule(nn.Module):
    """What the pipeline modules share: the constants of one frame size as
    registered buffers on the device, built once, and the checks of an
    input before any launch."""

    def _setup(self, who: str, height: int, width: int, engine: str, device,
               passes, consts, window_dtype: str = "float32") -> None:
        """Build ``consts`` (key -> numpy build) as buffers on ``device``, the
        card unless the caller asks for the CPU (a card that is not there
        raises). ``passes`` ((NLKParams, mode, height, width) of each pass)
        are held against K1's rule at the first frame."""
        check_engine(engine)
        check_window_dtype(window_dtype)
        self.engine, self.window_dtype = engine, window_dtype
        self.height, self.width = height, width
        self.passes = list(passes)
        self._routed = set()
        device = entry_device(device, who)
        for name, t in make_bases(consts, device).items():
            self.register_buffer(name, t)

    def bases(self, noisy: torch.Tensor) -> dict:
        """The module's constants, once ``noisy`` (T, H, W, C) is checked
        against its frame size and device. Where the module runs the
        kernels, each pass K1 does not take at this channel count is warned
        of here, before any launch (``core.nlkalman.note_plain_routes``)."""
        h, w, c = noisy.shape[1:]
        if (h, w) != (self.height, self.width):
            raise ValueError(f"frames are {h}x{w}, the module was built for "
                             f"{self.height}x{self.width}")
        bases = dict(self.named_buffers())
        dev = next(iter(bases.values())).device
        if noisy.device != dev:
            raise ValueError(f"input on {noisy.device}, module on {dev}")
        if runs_kernels(dev, self.engine) and c not in self._routed:
            self._routed.add(c)
            for p, mode, ph, pw in self.passes:
                note_plain_routes([(p, mode)], ph, pw, c, self.window_dtype)
        return bases


class NLKalmanDenoiser(PipelineModule):
    """The nlkalman-seq pipeline as a module: ``forward(noisy) -> (flt1,
    flt2, smo1)``.

    ``smoother`` picks the smoothing: "rts" the backward pass
    (nlkalman-seq.sh), "fsmo" causal forward smoothing and "lsmo" lag-1
    smoothing (:func:`fsmo_sequence`, :func:`lsmo_sequence`), "none"
    filtering only, smo1 None. The smoother's own flow configuration
    ``smooth_flow_cfg`` serves rts and lsmo; fsmo smooths along the
    filter's flow, as the JAX package's does.

    Holds the three ``NLKParams``, the flow configurations and, as
    registered buffers, the numpy-built constants of its frame size: the
    DCT bases, the Gaussian window, and the presmoothing blur and pyramid
    zoom matrices. The buffers are built on ``device``, the card unless
    the caller asks for the CPU; a card that is not there raises.
    ``window_dtype`` ("float32" or "bfloat16") is the type every NLK pass
    holds its DCT bands in. Where the module runs the kernels, a pass K1
    does not take (``core.nlkalman.k1_supported``) runs the plain pass and
    is warned of at the first frame, before any launch. Inputs must lie on
    the module's device. No randomness, no autograd.
    """

    def __init__(self, sigma: float, height: int, width: int,
                 flow_cfg: FlowConfig = FlowConfig(),
                 p1: NLKParams | None = None, p2: NLKParams | None = None,
                 ps: NLKParams | None = None, engine: str = "auto",
                 device="cuda", smooth_flow_cfg: FlowConfig | None = None,
                 smoother: str = "rts", window_dtype: str = "float32"):
        super().__init__()
        if smoother not in SMOOTHERS:
            raise ValueError(f"smoother must be one of {SMOOTHERS}, got {smoother!r}")
        self.sigma = float(sigma)
        self.flow_cfg = flow_cfg
        self.smooth_flow_cfg = smooth_flow_cfg
        self.smoother = smoother
        self.p1 = p1 or default_params(sigma, FilterMode.FLT1)
        self.p2 = p2 or default_params(sigma, FilterMode.FLT2)
        self.ps = ps or default_params(sigma, FilterMode.SMO1)
        self._setup("NLKalmanDenoiser", height, width, engine, device,
                    [(self.p1, "filter", height, width),
                     (self.p2, "filter", height, width),
                     (self.ps, "smooth", height, width)],
                    pipeline_bases(height, width, (flow_cfg, smooth_flow_cfg or flow_cfg),
                                   (self.p1, self.p2, self.ps)), window_dtype)

    @torch.no_grad()
    def forward(self, noisy: torch.Tensor):
        bases = self.bases(noisy)
        with span("request", noisy.device, REQUEST_COUNTERS):
            noisy = noisy.to(torch.float32).contiguous()
            kw = dict(engine=self.engine, bases=bases, window_dtype=self.window_dtype)
            if self.smoother == "fsmo":
                return fsmo_sequence(noisy, self.sigma, self.p1, self.p2, self.ps,
                                     self.flow_cfg, **kw)
            if self.smoother == "lsmo":
                flt1, flt2 = filter_sequence(noisy, self.sigma, self.p1, self.p2,
                                             self.flow_cfg, **kw)
                return flt1, flt2, lsmo_sequence(flt2, self.sigma, self.ps,
                                                 self.smooth_flow_cfg or self.flow_cfg,
                                                 **kw)
            return denoise_sequence(noisy, self.sigma, self.p1, self.p2, self.ps,
                                    self.flow_cfg, smoothing=self.smoother == "rts",
                                    smooth_flow_cfg=self.smooth_flow_cfg, **kw)
