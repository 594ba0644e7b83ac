"""Carry JAX-side configuration and state into the port.

The system has no learned weights: its parameters are the ``NLKParams``
and the ``FlowConfig``, each package holding its own classes; its state
is the forward scan's carry (flt1, flt2 and, with warm-started flow, the
level-fscale flow), and a stream's recursion state. A stream's ``.npz``
checkpoint has the same keys in both packages, so either's
``load_state`` reads the other's file; :func:`streaming_from_jax` carries
a live JAX stream across.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .params import NLKParams
from .pipeline.sequence import FlowConfig
from .pipeline.stream import StreamingDenoiser


def params_from_jax(p) -> NLKParams:
    """The port's NLKParams with the same field values as a JAX NLKParams."""
    return NLKParams(**{f.name: getattr(p, f.name)
                        for f in dataclasses.fields(NLKParams)})


def flow_config_from_jax(cfg, state_dtype: str = "float32") -> FlowConfig:
    """The port's FlowConfig with the same field values as a JAX FlowConfig.

    The JAX FlowConfig has no ``state_dtype``: the JAX package reads it from
    ``BNLK_TVL1_STATE_DTYPE``. A caller that ran JAX with it set passes it
    here."""
    return FlowConfig(state_dtype=state_dtype,
                      **{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(FlowConfig) if f.name != "state_dtype"})


def carry_from_numpy(flt1_prev, flt2_prev, u_fs, device):
    """The JAX scan carry, given as numpy arrays, as the port's tensors.

    flt1_prev, flt2_prev: (H, W, C); u_fs: (h_fs, w_fs, 2) or None.
    Returns (flt1_prev, flt2_prev, u_fs) float32 tensors on ``device``.
    """
    def t(a):
        return None if a is None else torch.tensor(
            np.asarray(a, dtype=np.float32), device=device)

    return t(flt1_prev), t(flt2_prev), t(u_fs)


def streaming_from_jax(sd, device="cuda", engine: str = "auto") -> StreamingDenoiser:
    """The port's StreamingDenoiser with the parameters, smoother, flow
    configuration and recursion state (frame index, flt1, flt2, smo and
    the warm-start flow carry) of the JAX StreamingDenoiser ``sd``."""
    out = StreamingDenoiser(sd.sigma, params_from_jax(sd.p1), params_from_jax(sd.p2),
                            params_from_jax(sd.ps), sd.smoother,
                            flow_config_from_jax(sd.flow_cfg), engine, device)
    out.index = sd.index
    for name in ("flt1", "flt2", "smo", "u_fs"):
        val = getattr(sd, name)
        if val is not None:
            setattr(out, name, torch.tensor(np.asarray(val, dtype=np.float32),
                                            device=out.device))
    return out
