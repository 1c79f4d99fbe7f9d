"""Each traffic kind end to end at a tiny size on the CPU through the plain
paths: set-up, the window, the traced stretch, the check."""
from __future__ import annotations

import pytest

from harness import cell

SEED = 2**31 + 12345  # a large seed, past 32 signed bits


@pytest.mark.parametrize("name", ["tiny.sample", "tiny.train", "tiny.ae"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_runs_and_is_correct(tiny_bench, name, trace):
    out = cell.run_cell(name, SEED, 0.2, trace, "cpu", tiny_bench)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    metric = {"tiny.sample": "image_s", "tiny.train": "train_step_ms", "tiny.ae": "ae_step_ms"}
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert any(k.startswith(("mfu.", "sample.")) for k in out["metrics"])
    else:
        assert set(out["metrics"]) == {metric[name], "setup_s"}
    assert list(out)[-1] == "checks"


def test_same_seed_same_inputs():
    import torch

    from harness import inputs

    mix = {"resolution": 64, "radius": 2.7, "prompt_tokens": [4, 20]}
    a = inputs.sample_request(SEED, 3, mix, 49408, "cpu")
    b = inputs.sample_request(SEED, 3, mix, 49408, "cpu")
    c = inputs.sample_request(SEED + 1, 3, mix, 49408, "cpu")
    assert torch.equal(a["ids"], b["ids"]) and torch.equal(a["noise"], b["noise"])
    assert not torch.equal(a["noise"], c["noise"])
    assert a["noise"].shape == c["noise"].shape and a["ids"].shape == c["ids"].shape
