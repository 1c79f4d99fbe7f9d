"""Training-state checkpoints and resume discovery (port of
custom_diffusion360_tpu/train/checkpoint.py, with ``torch.save`` in place
of orbax).

A checkpoint is the directory ``<ckpt_dir>/step_%08d`` holding
``train_state.pt``: the trainable leaves (in the order of the params'
leaves), the optimizer's ``state_dict``, the step, the accumulation state
and, when given, the EMA shadow. The frozen leaves are not saved: on
``--resume`` they come back from where they came from the first time, the
base checkpoint (``--base_ckpt``) or the random init of ``--seed``, so the
run must be resumed with the same ones.
"""
from __future__ import annotations

import os
import re
from typing import Optional

import torch

from .ema import EmaState
from .trainer import tree_leaves

STATE_FILE = "train_state.pt"


def _trainable(state):
    return [leaf for leaf in tree_leaves(state.params)
            if isinstance(leaf, torch.Tensor) and leaf.requires_grad]


def save_train_state(ckpt_dir: str, state, step: Optional[int] = None, ema=None) -> str:
    step = int(state.step) if step is None else step
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step:08d}"))
    os.makedirs(path, exist_ok=True)
    payload = {
        "trainable": [leaf.detach() for leaf in _trainable(state)],
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "accum": state.accum,
        "ema": None if ema is None else {
            "shadow": [s for s in tree_leaves(ema.shadow) if s is not None],
            "updates": ema.updates},
    }
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The ``step_N`` directory with the highest N, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, STATE_FILE)):
            steps.append((int(m.group(1)), name))
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps)[1])


@torch.no_grad()
def restore_train_state(path: str, state, ema=None):
    """Load a checkpoint into a state made by ``Trainer.init_state`` (and
    an EMA state made by ``ema_init``) -> (state, ema). The leaves are
    copied in place, so the optimizer keeps its parameters."""
    payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                         weights_only=True)
    leaves = _trainable(state)
    if len(leaves) != len(payload["trainable"]):
        raise ValueError(f"{path}: {len(payload['trainable'])} trainable leaves saved, "
                         f"the state has {len(leaves)}")
    for leaf, saved in zip(leaves, payload["trainable"]):
        leaf.copy_(saved)
    state.optimizer.load_state_dict(payload["optimizer"])
    accum = payload["accum"]
    if accum is not None and accum.get("grads") is not None:
        accum["grads"] = [g.to(leaf.device) for g, leaf in zip(accum["grads"], leaves)]
    state = state._replace(step=payload["step"], accum=accum)
    if ema is not None and payload["ema"] is not None:
        shadow = [s for s in tree_leaves(ema.shadow) if s is not None]
        for s, saved in zip(shadow, payload["ema"]["shadow"]):
            s.copy_(saved)
        ema = EmaState(ema.shadow, payload["ema"]["updates"])
    return state, ema
