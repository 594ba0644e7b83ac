"""Multiscale denoising: msnlkalman-seq (DCT pyramid) and
msnlkalman-lz3-seq (Lanczos-3 pyramid).

Port of ``bwd_nlkalman_tpu.pipeline.multiscale``. Per frame
(scripts/msnlkalman-seq.sh:53-111):

- decompose the noisy frame and the previous frame's full-resolution
  outputs into pyramids;
- coarse to fine, per level: TV-L1 flow at half the level's resolution,
  the occlusion mask, one warp of the previous flt1|flt2 and the two
  filter passes at sigma_l = sigma / ratio^l with sigma_l's default
  parameters;
- recompose the levels' outputs (conservative factor, or the lz3 blur,
  ``rec`` = 0.7).

The DCT pyramid's flow runs with tau .25, lambda .2, theta .4 and
occlusion threshold 0.5 (:82,87); the lz3 script's with the single-scale
pipeline's lambda .25, theta .3, occlusion threshold 0.75. Smoothing runs
backward per level with the full sigma at every level (-s $SIG, :158,
reproduced as is); the lz3 smoother re-decomposes the recomposed
smo_{t+1} every step, the DCT smoother smooths each level's own stack.
Each driver takes ``flow_cfg``, its pyramid's flow (default the
script's own); ``models.get_model`` hands its ``flow_cfg.state_dtype``
(K2's dual planes) down that way.
"""

from __future__ import annotations

import torch

from ..ops.pyramid import (auto_pyramid_levels, dct_decompose, dct_pyramid_keys,
                           dct_recompose, lanczos3_decompose, lanczos3_pyramid_keys,
                           lanczos3_recompose, lanczos3_sizes, pyramid_sizes)
from ..params import FilterMode, default_params
from .sequence import (FlowConfig, PipelineModule, filter_frame_pair,
                       pipeline_bases, smooth_pair, smooth_sequence)

MS_FLOW = FlowConfig(lambda_=0.2, theta=0.4, occ_threshold=0.5)
LZ3_FLOW = FlowConfig()      # lambda .25, theta .3, occlusion 0.75
PYRAMIDS = ("dct", "lz3")


def pyramid_flow(pyramid: str) -> FlowConfig:
    """The flow configuration of ``pyramid``'s script."""
    return LZ3_FLOW if pyramid == "lz3" else MS_FLOW


def level_sigmas(sigma: float, levels: int, ratio: float = 2.0) -> list[float]:
    return [sigma / (ratio ** lv) for lv in range(levels)]


def _filter_sequence(noisy, sigma, levels, decompose, recompose, flow_cfg,
                     ratio, engine, bases, window_dtype="float32"):
    """Multiscale forward filtering with a pyramid's decompose/recompose:
    (flt1, flt2, flt2_levels), the last a tuple of per-level flt2 stacks."""
    sig = level_sigmas(sigma, levels, ratio)
    p1 = [default_params(s, FilterMode.FLT1) for s in sig]
    p2 = [default_params(s, FilterMode.FLT2) for s in sig]
    flt1, flt2, per_level = [], [], []
    for t in range(noisy.shape[0]):
        pyr_n = decompose(noisy[t])
        if t == 0:
            pyr_f1 = pyr_f2 = [None] * levels
        else:
            pyr_f1, pyr_f2 = decompose(flt1[-1]), decompose(flt2[-1])
        f11, f21 = [None] * levels, [None] * levels
        for lv in range(levels - 1, -1, -1):
            f11[lv], f21[lv] = filter_frame_pair(pyr_n[lv], pyr_f1[lv], pyr_f2[lv],
                                                 sig[lv], p1[lv], p2[lv], flow_cfg,
                                                 engine, bases, window_dtype)
        flt1.append(recompose(f11) if levels > 1 else f11[0])
        flt2.append(recompose(f21) if levels > 1 else f21[0])
        per_level.append(f21)
    return (torch.stack(flt1), torch.stack(flt2),
            tuple(torch.stack(x) for x in zip(*per_level)))


def ms_filter_sequence(noisy, sigma, levels=None, rec=0.7, ratio=2.0,
                       engine="auto", bases=None, window_dtype="float32", flow_cfg=None):
    """DCT-pyramid forward filtering of (T, H, W, C) frames -> (flt1, flt2,
    flt2_levels)."""
    levels = levels or auto_pyramid_levels(*noisy.shape[1:3])
    return _filter_sequence(
        noisy, sigma, levels, lambda x: dct_decompose(x, levels, ratio, bases),
        lambda lv: dct_recompose(lv, rec, bases), flow_cfg or MS_FLOW, ratio, engine, bases,
        window_dtype)


def ms_smooth_sequence(flt2_levels, sigma, rec=0.7, engine="auto", bases=None,
                       window_dtype="float32", flow_cfg=None):
    """DCT-pyramid backward smoothing: each level's stack smoothed with the
    full sigma, then each frame recomposed -> (T, H, W, C)."""
    ps = default_params(sigma, FilterMode.SMO1)
    smo = [smooth_sequence(stack, sigma, ps, flow_cfg or MS_FLOW, engine, bases,
                           window_dtype)
           for stack in flt2_levels]
    if len(smo) == 1:
        return smo[0]
    return torch.stack([dct_recompose([s[t] for s in smo], rec, bases)
                        for t in range(smo[0].shape[0])])


def lz3_filter_sequence(noisy, sigma, levels=None, rec=0.7, engine="auto",
                        bases=None, window_dtype="float32", flow_cfg=None):
    """Lanczos-3 forward filtering (scripts/msnlkalman-lz3-seq.sh:59-128);
    the previous outputs are re-decomposed every frame -> (flt1, flt2,
    flt2_levels)."""
    levels = levels or auto_pyramid_levels(*noisy.shape[1:3])
    return _filter_sequence(
        noisy, sigma, levels, lambda x: lanczos3_decompose(x, levels),
        lambda lv: lanczos3_recompose(lv, rec, bases, engine), flow_cfg or LZ3_FLOW, 2.0, engine,
        bases, window_dtype)


def lz3_smooth_sequence(flt2, flt2_levels, sigma, rec=0.7, engine="auto",
                        bases=None, window_dtype="float32", flow_cfg=None):
    """Lanczos-3 backward smoothing (scripts/msnlkalman-lz3-seq.sh:135-190):
    each step decomposes the recomposed smoothed frame t+1 and smooths
    every level of frame t against it, with the full sigma."""
    levels = len(flt2_levels)
    ps = default_params(sigma, FilterMode.SMO1)
    cfg = flow_cfg or LZ3_FLOW
    n = flt2.shape[0]
    smo = [None] * n
    smo[-1] = flt2[-1]
    for t in range(n - 2, -1, -1):
        pyr_s0 = lanczos3_decompose(smo[t + 1], levels)
        smo_l = [None] * levels
        for lv in range(levels - 1, -1, -1):
            smo_l[lv] = smooth_pair(flt2_levels[lv][t], pyr_s0[lv], sigma, ps,
                                    cfg, engine, bases, window_dtype)
        smo[t] = lanczos3_recompose(smo_l, rec, bases, engine) if levels > 1 else smo_l[0]
    return torch.stack(smo)


def ms_denoise_sequence(noisy, sigma, levels=None, rec=0.7, smoothing=True,
                        pyramid: str = "dct", engine="auto", bases=None,
                        window_dtype="float32", flow_cfg=None):
    """The whole multiscale pipeline: (flt1, flt2, smo1), smo1 None when
    ``smoothing`` is False. ``pyramid="lz3"`` is msnlkalman-lz3-seq."""
    if pyramid not in PYRAMIDS:
        raise ValueError(f"pyramid must be one of {PYRAMIDS}, got {pyramid!r}")
    kw = dict(engine=engine, bases=bases, window_dtype=window_dtype, flow_cfg=flow_cfg)
    if pyramid == "lz3":
        flt1, flt2, flt2_levels = lz3_filter_sequence(noisy, sigma, levels, rec, **kw)
        smo1 = lz3_smooth_sequence(flt2, flt2_levels, sigma, rec, **kw) \
            if smoothing else None
    else:
        flt1, flt2, flt2_levels = ms_filter_sequence(noisy, sigma, levels, rec, **kw)
        smo1 = ms_smooth_sequence(flt2_levels, sigma, rec, **kw) if smoothing else None
    return flt1, flt2, smo1


def multiscale_bases(h: int, w: int, levels: int, pyramid: str, params,
                     rec: float = 0.7, ratio: float = 2.0, flow_cfg=None) -> dict:
    """Every numpy-built constant of the multiscale pipeline on (h, w)
    frames: each level's flow constants (``flow_cfg``, default the
    pyramid's) and those of NLK passes of ``params``, and the pyramid's
    own."""
    cfg = flow_cfg or pyramid_flow(pyramid)
    if pyramid == "lz3":
        sizes = lanczos3_sizes(h, w, levels)
        consts = lanczos3_pyramid_keys(h, w, levels, rec)
    else:
        sizes = pyramid_sizes(h, w, levels, ratio)
        consts = dct_pyramid_keys(h, w, levels, ratio)
    for lh, lw in sizes:
        consts.update(pipeline_bases(lh, lw, (cfg,), params))
    return consts


class MultiscaleDenoiser(PipelineModule):
    """The multiscale pipeline as a module: ``forward(noisy) -> (flt1, flt2,
    smo1)`` (smo1 None when ``smoothing`` is False).

    ``pyramid`` "dct" (msnlkalman-seq) or "lz3" (msnlkalman-lz3-seq);
    ``levels`` None picks the script's count from the frame size (3 at
    1080p). Holds every level's constants as registered buffers: the
    whole-image DCT bases (the DCT pyramid) or the recompose blur (lz3),
    and each level's flow and NLK constants, built on ``device``, the card
    unless the caller asks for the CPU; a card that is not there raises.
    ``window_dtype`` is the NLK passes' band type; where the module runs
    the kernels, a level's pass K1 does not take runs the plain pass and
    is warned of at the first frame, before any launch. ``flow_cfg`` is
    every level's flow (default the pyramid's script's own).
    """

    def __init__(self, sigma: float, height: int, width: int,
                 levels: int | None = None, pyramid: str = "dct",
                 rec: float = 0.7, smoothing: bool = True, engine: str = "auto",
                 device="cuda", window_dtype: str = "float32",
                 flow_cfg: FlowConfig | None = None):
        super().__init__()
        if pyramid not in PYRAMIDS:
            raise ValueError(f"pyramid must be one of {PYRAMIDS}, got {pyramid!r}")
        self.flow_cfg = flow_cfg or pyramid_flow(pyramid)
        self.sigma = float(sigma)
        self.levels = levels or auto_pyramid_levels(height, width)
        self.pyramid, self.rec, self.smoothing = pyramid, rec, smoothing
        sizes = (lanczos3_sizes(height, width, self.levels) if pyramid == "lz3"
                 else pyramid_sizes(height, width, self.levels))
        ps = default_params(self.sigma, FilterMode.SMO1)
        passes = [(default_params(s, m), "filter", lh, lw)
                  for s, (lh, lw) in zip(level_sigmas(self.sigma, self.levels), sizes)
                  for m in (FilterMode.FLT1, FilterMode.FLT2)]
        passes += [(ps, "smooth", lh, lw) for lh, lw in sizes]
        self._setup("MultiscaleDenoiser", height, width, engine, device, passes,
                    multiscale_bases(height, width, self.levels, pyramid,
                                     [p[0] for p in passes], rec,
                                     flow_cfg=self.flow_cfg), window_dtype)

    @torch.no_grad()
    def forward(self, noisy: torch.Tensor):
        bases = self.bases(noisy)
        return ms_denoise_sequence(noisy.to(torch.float32).contiguous(), self.sigma,
                                   self.levels, self.rec, self.smoothing,
                                   self.pyramid, self.engine, bases, self.window_dtype,
                                   self.flow_cfg)
