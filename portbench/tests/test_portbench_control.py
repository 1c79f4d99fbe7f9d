"""The lower-precision control (the reference with every product's
operands in float8 e4m3, in the program's place) fails the cell's limits,
where the program at f32 passes them."""
from __future__ import annotations

import json

import pytest
import torch

from harness import cell, spec

SEED = 90210


@pytest.mark.parametrize("name", ["tiny.sample", "tiny.train", "tiny.ae"])
def test_the_control_fails_the_limits(tiny_bench, name):
    wl = spec.workload(name, tiny_bench)
    mix = spec.traffic(wl["traffic"], tiny_bench)
    c = cell.Cell(name, wl, spec.config(wl["config"], tiny_bench), mix, SEED,
                  torch.device("cpu"), tiny_bench)
    job = spec.kind(mix["kind"], tiny_bench).Job(c)
    program = job.readings()
    control = job.control()
    limits = wl["limits"]
    assert all(program[k] <= v for k, v in limits.items()), (program, limits)
    assert any(control[k] > v for k, v in limits.items()), json.dumps(
        {"control": control, "limits": limits})
