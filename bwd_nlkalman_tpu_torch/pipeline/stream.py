"""Streaming sequence runner with checkpoint/resume.

Port of ``bwd_nlkalman_tpu.pipeline.stream``. Frames go through one at a
time, so memory stays constant in the sequence's length, as the
reference's scripts stream from disk. The recursion state is
{flt1, flt2, smo, the warm-start flow carry, the frame index}; it can be
written to an ``.npz`` checkpoint (every ``checkpoint_every`` frames,
from a background thread) and restored to resume mid-sequence. The
causal smoothers stream too: fsmo (forward smoothing interleaved with
filtering) and lsmo (lag-1 smoothing of frame t-1 once frame t is
filtered); the anti-causal RTS smoother cannot and stays in
``pipeline.sequence``.

A checkpoint holds the JAX package's keys (``index``, ``flt1``, ``flt2``,
``smo``, ``u_fs``, ``sigma``), as host float32 arrays, so either package
resumes from the other's, and the ``window_dtype`` the stream ran with; a
stream resumed from a checkpoint of another band type raises.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from .._dispatch import check_engine, check_window_dtype, entry_device, runs_kernels
from ..core.nlkalman import note_plain_routes
from ..flow.tvl1 import luma
from ..ops.bases import make_bases
from ..ops.color import opp2rgb
from ..params import FilterMode, NLKParams, default_params
from .sequence import (FlowConfig, _warp_passes, filter_frame_pair, fsmo_step,
                       pipeline_bases, smooth_pair)

STREAM_SMOOTHERS = ("none", "fsmo", "lsmo")


def _host(t) -> np.ndarray:
    return np.zeros(0) if t is None else t.cpu().numpy()


class StreamingDenoiser:
    """Frame-recursive forward filter (+ causal smoother) with
    checkpoint/resume.

    smoother: "none" (filter only), "fsmo" (``.smo`` is the smoothed
    current frame) or "lsmo" (``.lsm`` is the smoothed previous frame,
    from the second step on; :meth:`finalize` gives the last frame's
    passthrough). With ``flow_cfg.warm_start`` the first temporal step
    solves the cold pyramid and seeds the level-fscale flow carry, and
    every later step warm-starts from it; lsmo's flow is always cold.

    Runs on ``device``, the card unless the caller asks for the CPU; a
    card that is not there raises. ``window_dtype`` is the NLK passes'
    band type. The constants of the frame size (DCT bases, window, blur
    and zoom matrices) are built at the first frame, which also fixes the
    frame size; where the kernels run, a pass K1 does not take runs the
    plain pass and is warned of then, before any launch.
    """

    def __init__(self, sigma: float, p1: NLKParams | None = None,
                 p2: NLKParams | None = None, ps: NLKParams | None = None,
                 smoother: str = "none", flow_cfg: FlowConfig = FlowConfig(),
                 engine: str = "auto", device="cuda", window_dtype: str = "float32"):
        if smoother not in STREAM_SMOOTHERS:
            raise ValueError(
                f"streaming smoother must be none/fsmo/lsmo, got {smoother}"
                " (RTS is anti-causal; use pipeline.sequence.smooth_sequence)")
        check_engine(engine)
        check_window_dtype(window_dtype)
        self.window_dtype = window_dtype
        self.sigma = float(sigma)
        self.p1 = p1 or default_params(sigma, FilterMode.FLT1)
        self.p2 = p2 or default_params(sigma, FilterMode.FLT2)
        self.ps = ps or default_params(sigma, FilterMode.SMO1)
        self.smoother = smoother
        self.flow_cfg = flow_cfg
        self.engine = engine
        self.device = entry_device(device, "StreamingDenoiser")
        self.passes = [(self.p1, "filter"), (self.p2, "filter"), (self.ps, "smooth")]
        self._bases = None
        self._shape = None
        self.flt1 = None
        self.flt2 = None
        self.smo = None     # fsmo: smoothed current frame
        self.lsm = None     # lsmo: smoothed previous frame
        self.u_fs = None    # warm start: level-fscale flow carry
        self.index = -1

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device).contiguous()

    def _bases_for(self, frame: torch.Tensor) -> dict:
        """The constants of the stream's frame size, built at its first frame."""
        h, w, c = frame.shape
        if self._shape is None:
            if runs_kernels(self.device, self.engine):
                note_plain_routes(self.passes, h, w, c, self.window_dtype)
            self._bases = make_bases(pipeline_bases(
                h, w, (self.flow_cfg,), (self.p1, self.p2, self.ps)), self.device)
            self._shape = (h, w, c)
        elif (h, w, c) != self._shape:
            raise ValueError(f"frame is {h}x{w}x{c}, the stream's frames are "
                             f"{'x'.join(map(str, self._shape))}")
        return self._bases

    @torch.no_grad()
    def step(self, noisy_frame) -> tuple[torch.Tensor, torch.Tensor]:
        """Filter one (H, W, C) frame (a tensor or an array); advances the
        recursion state. Returns (flt1, flt2) as tensors on the device."""
        frame = self._tensor(noisy_frame)
        bases = self._bases_for(frame)
        kw = dict(engine=self.engine, bases=bases)
        nlk = dict(kw, window_dtype=self.window_dtype)
        cfg = self.flow_cfg
        self.lsm = None
        if self.flt2 is None:
            f1, f2 = filter_frame_pair(frame, None, None, self.sigma, self.p1,
                                       self.p2, cfg, **nlk)
            smo = f2                     # smo_first = flt2_first
        else:
            i0, i1 = luma(frame), luma(self.flt2)
            if not cfg.warm_start:
                flow = cfg.flow(i0, i1, **kw)
            elif self.u_fs is None:
                flow, self.u_fs = cfg.flow_cold_carry(i0, i1, **kw)
            else:
                flow, self.u_fs = cfg.flow_warm(i0, i1, self.u_fs, **kw)
            if self.smoother == "fsmo":
                smo_prev = self.smo if self.smo is not None else self.flt2
                f1, f2, smo = fsmo_step(frame, self.flt1, self.flt2, smo_prev,
                                        flow, cfg.occ_threshold, self.sigma,
                                        self.p1, self.p2, self.ps, **nlk)
            else:
                f11, f21, _, _ = _warp_passes(frame, (self.flt1, self.flt2), flow,
                                              cfg.occ_threshold, self.sigma,
                                              self.p1, self.p2, **nlk)
                f1, f2 = opp2rgb(f11), opp2rgb(f21)
                smo = None
            if self.smoother == "lsmo":
                self.lsm = smooth_pair(self.flt2, f2, self.sigma, self.ps, cfg, **nlk)
        self.flt1, self.flt2 = f1, f2
        self.smo = smo if self.smoother == "fsmo" else None
        self.index += 1
        return f1, f2

    def finalize(self):
        """lsmo: the last frame passes through (lsmo_sequence's tail)."""
        if self.smoother == "lsmo" and self.flt2 is not None:
            return self.flt2
        return None

    # ---- checkpointing ---------------------------------------------------

    def save_state(self, path: str, background: bool = False):
        """Snapshot the recursion state to ``path``. The host copies are
        taken now; with ``background=True`` the file is written by a
        thread, which is returned to join (else None). The write is atomic:
        a temporary file renamed over ``path``."""
        payload = dict(index=self.index, flt1=_host(self.flt1),
                       flt2=_host(self.flt2), smo=_host(self.smo),
                       u_fs=_host(self.u_fs), sigma=self.sigma,
                       window_dtype=self.window_dtype)

        def write():
            tmp = path + ".tmp.npz"
            np.savez(tmp, **payload)
            os.replace(tmp, path)

        if background:
            t = threading.Thread(target=write, daemon=True)
            t.start()
            return t
        write()
        return None

    def load_state(self, path: str) -> None:
        """Restore the recursion state from a checkpoint of either package;
        one written with another band type raises."""
        with np.load(path) as z:
            if "window_dtype" in z and str(z["window_dtype"]) != self.window_dtype:
                raise ValueError(f"{path} was written by a {z['window_dtype']} stream, "
                                 f"this one runs {self.window_dtype}")
            self.index = int(z["index"])
            if z["flt1"].size:
                self.flt1 = self._tensor(z["flt1"])
                self.flt2 = self._tensor(z["flt2"])
            if "smo" in z and z["smo"].size:
                self.smo = self._tensor(z["smo"])
            if "u_fs" in z and z["u_fs"].size:
                self.u_fs = self._tensor(z["u_fs"])

    def restore_from(self, flt1, flt2, index: int, smo=None) -> None:
        """Resume from in-memory or on-disk outputs (frame-granular resume)."""
        self.flt1 = self._tensor(flt1)
        self.flt2 = self._tensor(flt2)
        if smo is not None:
            self.smo = self._tensor(smo)
        self.index = index


def run_streaming(read_frame, first: int, last: int, sigma: float,
                  out_dir: str | None = None, checkpoint_path: str | None = None,
                  write_frame=None, checkpoint_every: int = 8,
                  async_checkpoint: bool = True, **kw):
    """Drive a :class:`StreamingDenoiser` over frames [first, last],
    resuming at ``first + index + 1`` from the checkpoint when it exists.

    read_frame(i) -> (H, W, C); write_frame(name, i, array) persists
    outputs as host arrays, named flt1 / flt2 (+ smo1 with a streaming
    smoother) like the scripts. Checkpoints are written every
    ``checkpoint_every`` frames and once at the end, from a background
    thread by default. ``out_dir`` is accepted for the JAX signature and
    unused, as there. Returns the computed frames' (flt1, flt2) host
    arrays.
    """
    sd = StreamingDenoiser(sigma, **kw)
    start = first
    if checkpoint_path and os.path.exists(checkpoint_path):
        sd.load_state(checkpoint_path)
        start = first + sd.index + 1
    out = []
    pending = None
    for i in range(start, last + 1):
        f1, f2 = (x.cpu().numpy() for x in sd.step(read_frame(i)))
        if write_frame is not None:
            write_frame("flt1", i, f1)
            write_frame("flt2", i, f2)
            if sd.smoother == "fsmo":
                write_frame("smo1", i, sd.smo.cpu().numpy())
            elif sd.smoother == "lsmo" and sd.lsm is not None:
                write_frame("smo1", i - 1, sd.lsm.cpu().numpy())
        if checkpoint_path and (i - start) % max(checkpoint_every, 1) == 0:
            if pending is not None:
                pending.join()
            pending = sd.save_state(checkpoint_path, background=async_checkpoint)
        out.append((f1, f2))
    tail = sd.finalize()
    if tail is not None and write_frame is not None:
        write_frame("smo1", last, tail.cpu().numpy())
    if checkpoint_path:
        if pending is not None:
            pending.join()
        sd.save_state(checkpoint_path)
    return out
