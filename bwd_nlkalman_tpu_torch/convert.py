"""Carry JAX-side configuration and state into the port.

The system has no learned weights: its parameters are the ``NLKParams``
(shared by both packages, see ``params.py``) and the ``FlowConfig``; its
state is the forward scan's carry (flt1, flt2 and, with warm-started
flow, the level-fscale flow).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .pipeline.sequence import FlowConfig


def flow_config_from_jax(cfg) -> FlowConfig:
    """The port's FlowConfig with the same field values as a JAX FlowConfig."""
    return FlowConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(FlowConfig)})


def carry_from_numpy(flt1_prev, flt2_prev, u_fs, device):
    """The JAX scan carry, given as numpy arrays, as the port's tensors.

    flt1_prev, flt2_prev: (H, W, C); u_fs: (h_fs, w_fs, 2) or None.
    Returns (flt1_prev, flt2_prev, u_fs) float32 tensors on ``device``.
    """
    def t(a):
        return None if a is None else torch.tensor(
            np.asarray(a, dtype=np.float32), device=device)

    return t(flt1_prev), t(flt2_prev), t(u_fs)
