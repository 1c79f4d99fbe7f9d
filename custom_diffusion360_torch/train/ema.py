"""Exponential moving average of the trainable parameters (port of
custom_diffusion360_tpu/train/ema.py; the reference's LitEma): a shadow
tree of the params' structure holding a copy of each trainable leaf (None
for the frozen ones), updated with the decay min(decay, (1 + u) / (10 + u))
after u + 1 updates.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .trainer import tree_map


class EmaState(NamedTuple):
    shadow: Any
    updates: int


def ema_init(params, mask=None) -> EmaState:
    """Shadow copies of the leaves where ``mask`` is true (all without a
    mask). Copies, not aliases: the optimizer updates the leaves in place,
    so an aliased shadow would simply follow the parameters."""
    if mask is None:
        shadow = tree_map(lambda p: p.detach().clone(), params)
    else:
        shadow = tree_map(lambda p, m: p.detach().clone() if m else None, params, mask)
    return EmaState(shadow, 0)


@torch.no_grad()
def ema_update(state: EmaState, params, decay: float = 0.9999) -> EmaState:
    """One update of the shadow (in place) toward ``params``."""
    updates = state.updates + 1
    d = min(decay, (1.0 + updates) / (10.0 + updates))

    def upd(s, p):
        if s is not None:
            s.sub_((1.0 - d) * (s - p.detach()))
        return s

    tree_map(upd, state.shadow, params)
    return EmaState(state.shadow, updates)


def ema_swap(params, state: EmaState):
    """params with the shadow's values where it tracks a leaf (the
    reference's ema_scope)."""
    return tree_map(lambda p, s: p if s is None else s, params, state.shadow)
