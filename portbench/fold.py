#!/usr/bin/env python3
"""The program's spans folded with the device trace, for one cell: where a
unit's device time, launches and idle time go, by ``cd360.*`` span.

    python3 portbench/fold.py --workload <cell> --seed <n> [--units 1]

Builds the cell's set-up on the card (the seed's weights and inputs, the
warm-up of every shape), folds ``--units`` profiled units
(``harness/spans.py``) and prints one JSON line: the fold's totals a unit
(the device's busy ms, the device ms that no launching call matched, the
device ms launched inside no span, the top-level spans' device ms), its
wall seconds, each span's calls, host ms, self host ms, device ms,
launches and idle ms a unit, and the device's idle ms a unit by the span
open at the middle of each gap. Exits 2 without a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys

import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--units", type=int, default=1)
    args = p.parse_args(argv)
    run.environment()
    import torch

    from harness import cell, spans, spec

    if not torch.cuda.is_available():
        print("portbench: the fold reads a CUDA card's trace; found none", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = spec.workload(args.workload, run.BENCH_DIR)
    mix = spec.traffic(wl["traffic"], run.BENCH_DIR)
    c = cell.Cell(args.workload, wl, spec.config(wl["config"], run.BENCH_DIR), mix, args.seed,
                  torch.device("cuda"), run.BENCH_DIR)
    fold = spans.run(spec.kind(mix["kind"], run.BENCH_DIR).Job(c), args.units)
    n = fold.units
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "units": n, "seconds": fold.seconds,
        "busy_ms": fold.busy_ms / n, "unmatched_ms": fold.unmatched_ms / n,
        "outside_ms": fold.outside_ms / n, "top_ms": fold.top_ms / n,
        "spans": {name: {k: v / n for k, v in vars(s).items()}
                  for name, s in sorted(fold.spans.items())},
        "idle_by_span": {k: v / n for k, v in sorted(fold.idle_by_span.items(),
                                                      key=lambda kv: -kv[1])}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
