"""The numbers that decide ``correct``, each beside its limit."""
from __future__ import annotations

import math
import statistics
from dataclasses import dataclass

import torch


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def rel(got, ref) -> float:
    """||got - ref|| / ||ref||, in float64."""
    g, r = got.double(), ref.double().to(got.device)
    return float(torch.linalg.vector_norm(g - r) / torch.linalg.vector_norm(r).clamp_min(1e-300))


def norms(tensors) -> list:
    return [float(torch.linalg.vector_norm(t.double())) for t in tensors]


def leaf_gaps(got: list, ref: list, keep=None) -> dict:
    """{leaf index: |got_i - ref_i| / max(ref_i, median of ref)}: the gap
    between the program's norm of a leaf and the reference's, against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger. ``keep``: the leaves that count."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median(ref[i] for i in idx)
    return {i: abs(got[i] - ref[i]) / max(ref[i], med, 1e-300) for i in idx}


def diff_gaps(got: list, ref: list, ref_norms: list, keep=None) -> dict:
    """{leaf index: ||got_i - ref_i|| / max(ref_norms_i, median of ref_norms)}:
    the norm of the difference of the leaves (where ``leaf_gaps`` takes the
    gap of their norms), so that it sees a changed direction, such as
    Adam's sign pattern, and not only a changed length."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    med = statistics.median(ref_norms[i] for i in idx)
    return {i: float(torch.linalg.vector_norm(got[i].double() - ref[i].double().to(got[i].device)))
            / max(ref_norms[i], med, 1e-300) for i in idx}


def worst_leaf_gap(got: list, ref: list, keep=None) -> float:
    """The worst leaf's gap (``leaf_gaps``)."""
    return max(leaf_gaps(got, ref, keep).values())


def median_leaf_gap(got: list, ref: list, keep=None) -> float:
    """The median leaf's gap (``leaf_gaps``)."""
    return statistics.median(leaf_gaps(got, ref, keep).values())


def limits_checks(values: dict, limits: dict) -> list:
    """A Check per limit of the cell (a number with no limit is not compared)."""
    return [Check(name, float(values[name]), float(limit)) for name, limit in limits.items()]
