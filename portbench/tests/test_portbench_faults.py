"""A whole run with the timed path broken underneath (the chip look
skipped, the cell at a tiny size on the CPU) must come out not correct:
once for each fault the cell can have (``harness/faults.py``). None of the
cells runs across chips, so the exchange between chips cannot be left
out; the sampling and fine-tuning cells run batch 1, so half of their
batch cannot be."""
from __future__ import annotations

import pytest

from harness import cell, faults

SEED = 31337
CELLS = {"sample": "tiny.sample", "train": "tiny.train", "ae_train": "tiny.ae"}


@pytest.mark.parametrize("kind, fault", [(k, f) for k, fs in faults.BY_KIND.items() for f in fs],
                         ids=lambda v: getattr(v, "__name__", v))
def test_a_fault_is_not_correct(tiny_bench, monkeypatch, kind, fault):
    fault(monkeypatch.setattr)
    out = cell.run_cell(CELLS[kind], SEED, 0.1, False, "cpu", tiny_bench)
    assert not out["correct"], out["checks"]
