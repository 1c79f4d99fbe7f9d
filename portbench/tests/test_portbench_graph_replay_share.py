"""``sample.graph_replay_share``: the program's counter of cached-phase UNet
evaluations read as a share, and nothing where there is nothing to read."""
from __future__ import annotations

import importlib
import sys
from collections import Counter

import pytest

from harness import spec

MODULE = "custom_diffusion360_torch.models.unet_graphs"


@pytest.mark.parametrize("counts,want", [
    ({}, None),  # nothing counted: the CPU
    ({"capture": 1}, None),
    ({"eager": 3}, 0.0),
    ({"capture": 1, "replay": 47, "eager": 1}, 100.0 * 47 / 48),
    ({"replay": 49}, 100.0),
])
def test_the_share_of_replays(monkeypatch, counts, want):
    monkeypatch.setattr(importlib.import_module(MODULE), "evaluations", Counter(counts))
    got = spec.metric_reader("sample.graph_replay_share")(None)
    assert got == (None if want is None else pytest.approx(want))


def test_nothing_without_the_counter_module(monkeypatch):
    monkeypatch.setitem(sys.modules, MODULE, None)  # as on a program without it
    assert spec.metric_reader("sample.graph_replay_share")(None) is None
