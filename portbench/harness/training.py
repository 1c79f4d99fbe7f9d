"""What the training kinds share: draws that are recorded as the program
takes them (the reference is handed the same numbers), and the numbers of
the first steps that the check compares: each step's losses, the first
gradient of every trainable leaf as the optimizer got it (Adam's first
moment after one step is (1 - b1) g), and every leaf's change over the
first steps."""
from __future__ import annotations

import torch

from . import compare

STEPS = 3  # the first steps, which the reference follows


def recording_draws(draws_cls, gen, record: dict, prefix: str = ""):
    """A ``draws_cls`` (the port's ``Draws``) that notes every draw it hands
    out in ``record`` {full name: tensor}."""

    class Recording(draws_cls):
        def child(self, name):
            return recording_draws(draws_cls, self.gen, record, f"{self.prefix}{name}/")

        def take(self, name, shape, device, make):
            out = super().take(name, shape, device, make)
            record[self.prefix + name] = out.detach().clone()
            return out

    return Recording(gen, prefix=prefix)


def first_moments(optimizers, leaves, b1: float) -> list:
    """The gradient of each leaf as the optimizer got it at its first step:
    its first moment over (1 - b1)."""
    out = []
    for leaf in leaves:
        state = next(opt.state[leaf] for opt in optimizers if leaf in opt.state)
        out.append((state["exp_avg"] / (1.0 - b1)).detach().clone())
    return out


def changes(before: list, after: list) -> list:
    return [float(torch.linalg.vector_norm((a.double() - b.double().to(a.device))))
            for b, a in zip(before, after)]


def quiet_leaves(grad_norms: list, rule: float = 1e-3) -> list:
    """Leaves whose reference gradient is at least ``rule`` of the median
    leaf's: the others move under Adam by round-off alone and are left out
    of the change."""
    import statistics

    med = statistics.median(grad_norms)
    return [g >= rule * med for g in grad_norms]


def worst_leaves(got: list, ref: list, names: list, keep=None, top: int = 3) -> list:
    """The ``top`` leaves of largest gap: [name, gap, program norm, reference norm]."""
    gaps = compare.leaf_gaps(got, ref, keep)
    worst = sorted(gaps, key=lambda i: -gaps[i])[:top]
    return [[names[i], gaps[i], got[i], ref[i]] for i in worst]
