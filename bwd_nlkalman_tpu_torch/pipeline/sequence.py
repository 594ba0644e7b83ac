"""Sequence denoising: the port of ``bwd_nlkalman_tpu.pipeline.sequence``.

Forward filtering runs over the frames with the carry {flt1, flt2} (and,
with warm-started flow, the level-fscale flow): per frame a TV-L1
backward flow on luma, the divergence occlusion mask, one bicubic warp
of the previous flt1|flt2 pair and two NL-Kalman filter passes in OPP
color. Backward RTS smoothing then runs in reverse with a forward flow,
the occlusion mask, a warp and one smoother pass per frame. The JAX
package's ``lax.scan`` is a Python loop here; the warm-start gate is a
Python branch (one host sync per frame).

Frames are (T, H, W, C) float32 in [0, 255]. ``engine="auto"`` runs the
hand-written kernels on CUDA tensors and the plain versions on CPU
tensors; ``engine="plain"`` runs the plain versions on any device.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from .._dispatch import check_engine
from ..core import nlkalman_filter_frame, nlkalman_smooth_frame
from ..core.engine import nlk_bases
from ..flow.occlusion import occlusion_mask
from ..flow.tvl1 import flow_bases, luma, tvl1_flow, tvl1_flow_warm
from ..ops.bases import make_bases
from ..ops.color import opp2rgb, rgb2opp
from ..ops.warp import warp_bicubic_nan
from ..params import FilterMode, NLKParams, default_params


@dataclasses.dataclass(frozen=True)
class FlowConfig:
    """Optical-flow parameters as the pipeline scripts pass them
    (scripts/nlkalman-seq.sh:12,47-51); fields as in the JAX package."""

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

    def _kw(self):
        return dict(tau=self.tau, lambda_=self.lambda_, theta=self.theta,
                    nscales=self.nscales, fscale=self.fscale,
                    zfactor=self.zfactor, nwarps=self.nwarps,
                    epsilon=self.epsilon, max_iters=self.max_iters)

    def flow(self, i0, i1, engine="auto", bases=None):
        return tvl1_flow(i0, i1, engine=engine, bases=bases, **self._kw())

    def flow_cold_carry(self, i0, i1, engine="auto", bases=None):
        """Full-pyramid solve that also returns the warm-start carry."""
        return tvl1_flow(i0, i1, return_carry=True, engine=engine,
                         bases=bases, **self._kw())

    def flow_warm(self, i0, i1, u_carry, engine="auto", bases=None):
        """Level-fscale-only solve initialised from the carried flow."""
        return tvl1_flow_warm(i0, i1, u_carry, warm_nwarps=self.warm_nwarps,
                              warm_max_iters=self.warm_max_iters,
                              engine=engine, bases=bases, **self._kw())


def _filter_with_flow(noisy, flt1_prev, flt2_prev, flow, occ_th, sigma, p1, p2,
                      engine="auto", bases=None):
    """Two-pass filtering given an already-computed backward flow."""
    n_opp = rgb2opp(noisy)
    occ = occlusion_mask(flow, occ_th)
    # both previous outputs ride one warp: same flow, same validity
    c = noisy.shape[-1]
    both = torch.cat([rgb2opp(flt1_prev), rgb2opp(flt2_prev)], dim=-1)
    wb, v1 = warp_bicubic_nan(both, flow, occ, engine=engine)
    f11 = nlkalman_filter_frame(n_opp, wb[..., :c], v1, None, sigma, p1,
                                engine=engine, bases=bases)
    f21 = nlkalman_filter_frame(n_opp, wb[..., c:], v1, f11, sigma, p2,
                                engine=engine, bases=bases)
    return opp2rgb(f11), opp2rgb(f21)


def filter_frame_pair(noisy, flt1_prev, flt2_prev, sigma, p1, p2,
                      flow_cfg: FlowConfig = FlowConfig(), engine="auto",
                      bases=None):
    """Two-pass filtering of one frame given the previous outputs (RGB
    in/out); with no previous frame, the spatial-only first-frame path."""
    if flt2_prev is None:
        n_opp = rgb2opp(noisy)
        f11 = nlkalman_filter_frame(n_opp, None, None, None, sigma, p1,
                                    engine=engine, bases=bases)
        f21 = nlkalman_filter_frame(n_opp, None, None, f11, sigma, p2,
                                    engine=engine, bases=bases)
        return opp2rgb(f11), opp2rgb(f21)
    flow = flow_cfg.flow(luma(noisy), luma(flt2_prev), engine, bases)
    return _filter_with_flow(noisy, flt1_prev, flt2_prev, flow,
                             flow_cfg.occ_threshold, sigma, p1, p2, engine,
                             bases)


def filter_step_warm(frame, carry, sigma, p1, p2, flow_cfg: FlowConfig,
                     engine="auto", bases=None):
    """One warm-started forward step (the JAX scan body, sequence.py:174-181).

    carry = (flt1_prev, flt2_prev, u_fs). Returns (new carry, (flt1, flt2)).
    """
    flt1_prev, flt2_prev, u_c = carry
    flow, u_c = flow_cfg.flow_warm(luma(frame), luma(flt2_prev), u_c, engine,
                                   bases)
    f11, f21 = _filter_with_flow(frame, flt1_prev, flt2_prev, flow,
                                 flow_cfg.occ_threshold, sigma, p1, p2,
                                 engine, bases)
    return (f11, f21, u_c), (f11, f21)


def filter_sequence(noisy, sigma, p1: NLKParams | None = None,
                    p2: NLKParams | None = None,
                    flow_cfg: FlowConfig = FlowConfig(), engine="auto",
                    bases=None):
    """Forward-filter a (T, H, W, C) sequence -> (flt1, flt2) stacks."""
    p1 = p1 or default_params(sigma, FilterMode.FLT1)
    p2 = p2 or default_params(sigma, FilterMode.FLT2)
    f11, f21 = filter_frame_pair(noisy[0], None, None, sigma, p1, p2, flow_cfg,
                                 engine, bases)
    flt1, flt2 = [f11], [f21]
    if flow_cfg.warm_start and noisy.shape[0] > 1:
        # frame 1 is peeled: its flow runs the cold pyramid and seeds the
        # level-fscale carry; every further step warm-starts from it
        flow1, u_fs = flow_cfg.flow_cold_carry(luma(noisy[1]), luma(f21),
                                               engine, bases)
        f11, f21 = _filter_with_flow(noisy[1], f11, f21, flow1,
                                     flow_cfg.occ_threshold, sigma, p1, p2,
                                     engine, bases)
        flt1.append(f11)
        flt2.append(f21)
        carry = (f11, f21, u_fs)
        for t in range(2, noisy.shape[0]):
            carry, (f11, f21) = filter_step_warm(noisy[t], carry, sigma, p1,
                                                 p2, flow_cfg, engine, bases)
            flt1.append(f11)
            flt2.append(f21)
    else:
        for t in range(1, noisy.shape[0]):
            f11, f21 = filter_frame_pair(noisy[t], f11, f21, sigma, p1, p2,
                                         flow_cfg, engine, bases)
            flt1.append(f11)
            flt2.append(f21)
    return torch.stack(flt1), torch.stack(flt2)


def smooth_sequence(flt2, sigma, ps: NLKParams | None = None,
                    flow_cfg: FlowConfig = FlowConfig(), engine="auto",
                    bases=None):
    """Backward RTS smoothing of the filtered stack (T, H, W, C) -> smo1."""
    ps = ps or default_params(sigma, FilterMode.SMO1)

    def smooth_with_flow(frame_flt2, smo_next, flow):
        occ = occlusion_mask(flow, flow_cfg.occ_threshold)
        w0, v0 = warp_bicubic_nan(rgb2opp(smo_next), flow, occ, engine=engine)
        return opp2rgb(nlkalman_smooth_frame(rgb2opp(frame_flt2), w0, v0,
                                             sigma, ps, engine=engine,
                                             bases=bases))

    n = flt2.shape[0]
    smo = [None] * n
    smo[-1] = flt2[-1]
    if n == 1:
        return torch.stack(smo)
    if flow_cfg.warm_start:
        # frame T-2 is peeled: the cold pyramid seeds the carry
        flow1, u_c = flow_cfg.flow_cold_carry(luma(flt2[-2]), luma(smo[-1]),
                                              engine, bases)
        smo[-2] = smooth_with_flow(flt2[-2], smo[-1], flow1)
        for t in range(n - 3, -1, -1):
            flow, u_c = flow_cfg.flow_warm(luma(flt2[t]), luma(smo[t + 1]),
                                           u_c, engine, bases)
            smo[t] = smooth_with_flow(flt2[t], smo[t + 1], flow)
    else:
        for t in range(n - 2, -1, -1):
            flow = flow_cfg.flow(luma(flt2[t]), luma(smo[t + 1]), engine, bases)
            smo[t] = smooth_with_flow(flt2[t], smo[t + 1], flow)
    return torch.stack(smo)


def denoise_sequence(noisy, sigma, p1: NLKParams | None = None,
                     p2: NLKParams | None = None, ps: NLKParams | None = None,
                     flow_cfg: FlowConfig = FlowConfig(), smoothing: bool = True,
                     smooth_flow_cfg: FlowConfig | None = None, engine="auto",
                     bases=None):
    """Two-pass forward filtering + backward smoothing: (flt1, flt2, smo1),
    smo1 None when ``smoothing`` is False."""
    flt1, flt2 = filter_sequence(noisy, sigma, p1, p2, flow_cfg, engine, bases)
    if not smoothing:
        return flt1, flt2, None
    smo1 = smooth_sequence(flt2, sigma, ps, smooth_flow_cfg or flow_cfg,
                           engine, bases)
    return flt1, flt2, smo1


class NLKalmanDenoiser(nn.Module):
    """The nlkalman-seq slice as a module: ``forward(noisy) -> (flt1, flt2, smo1)``.

    Holds the three ``NLKParams``, the ``FlowConfig`` and, as registered
    buffers, the numpy-built constants of its frame size: the DCT bases,
    the Gaussian window, and the presmoothing blur and pyramid zoom
    matrices. Move it with ``.to(device)``; inputs must lie on the same
    device. No randomness, no autograd.
    """

    def __init__(self, sigma: float, height: int, width: int,
                 flow_cfg: FlowConfig = FlowConfig(),
                 p1: NLKParams | None = None, p2: NLKParams | None = None,
                 ps: NLKParams | None = None, engine: str = "auto"):
        super().__init__()
        self.sigma = float(sigma)
        self.height, self.width = height, width
        self.flow_cfg = flow_cfg
        self.p1 = p1 or default_params(sigma, FilterMode.FLT1)
        self.p2 = p2 or default_params(sigma, FilterMode.FLT2)
        self.ps = ps or default_params(sigma, FilterMode.SMO1)
        check_engine(engine)
        self.engine = engine
        consts = flow_bases(height, width, flow_cfg.nscales, flow_cfg.zfactor)
        for psz in {self.p1.patch_sz, self.p2.patch_sz, self.ps.patch_sz}:
            consts.update(nlk_bases(psz))
        for name, t in make_bases(consts).items():
            self.register_buffer(name, t)

    @torch.no_grad()
    def forward(self, noisy: torch.Tensor):
        t, h, w, c = noisy.shape
        if (h, w) != (self.height, self.width):
            raise ValueError(f"frames are {h}x{w}, the module was built for "
                             f"{self.height}x{self.width}")
        bases = dict(self.named_buffers())
        dev = next(iter(bases.values())).device
        if noisy.device != dev:
            raise ValueError(f"input on {noisy.device}, module on {dev}")
        return denoise_sequence(noisy.to(torch.float32).contiguous(),
                                self.sigma, self.p1, self.p2, self.ps,
                                self.flow_cfg, engine=self.engine, bases=bases)
