"""``train.graph_replay_share``: the program's counter of training steps on
the card read as a share, and nothing where there is nothing to read."""
from __future__ import annotations

import importlib
import sys
from collections import Counter

import pytest

from harness import spec

MODULE = "custom_diffusion360_torch.train.train_graphs"


@pytest.mark.parametrize("counts,want", [
    ({}, None),  # nothing counted: the CPU
    ({"capture": 1}, None),
    ({"eager": 2}, 0.0),
    ({"eager": 1, "capture": 1, "replay": 30}, 100.0 * 30 / 31),
    ({"replay": 12}, 100.0),
])
def test_the_share_of_replays(monkeypatch, counts, want):
    monkeypatch.setattr(importlib.import_module(MODULE), "steps", Counter(counts))
    got = spec.metric_reader("train.graph_replay_share")(None)
    assert got == (None if want is None else pytest.approx(want))


def test_nothing_without_the_counter_module(monkeypatch):
    monkeypatch.setitem(sys.modules, MODULE, None)  # as on a program without it
    assert spec.metric_reader("train.graph_replay_share")(None) is None
