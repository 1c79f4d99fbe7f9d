"""On the card: each tiny cell through the port's kernels (bf16) against the
reference; decided at run time by the ``cuda_card`` fixture."""
from __future__ import annotations

import json

import pytest

from harness import cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tiny.sample", "tiny.train", "tiny.ae"])
def test_a_tiny_cell_on_the_card(tiny_bench, cuda_card, name):
    out = cell.run_cell(name, 4242, 0.5, True, str(cuda_card), tiny_bench)
    assert out["device"]["busy_s"] > 0.0
    assert out["device"]["memory_peak_bytes"] > 0
    assert json.dumps(out)
