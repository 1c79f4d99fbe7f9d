#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from: the program's
numbers on many seeds, and the control's (the reference with every
product's operands in float8 e4m3 in the program's place) on some of
them, at the cell's own sizes, one process for all.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 --control 1,2

Each seed builds the cell's set-up anew (weights and inputs of that
seed), runs the requests or steps the check compares, and prints one JSON
line {"seed", "program": {number: reading}, "control": {...}}; a line
{"lower": ..., "upper": ...} closes: for each number the largest program
reading and the smallest control reading. With ``--fault`` the program
runs with that fault of harness/faults.py planted under its timed path.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", default="", help="comma-separated seeds that run the control")
    p.add_argument("--fault", default=None,
                   help="a fault of harness/faults.py planted under the program's timed path")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    run.environment()
    import torch

    from harness import cell, faults, spec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = spec.workload(args.workload, run.BENCH_DIR)
    mix = spec.traffic(wl["traffic"], run.BENCH_DIR)
    kind = spec.kind(mix["kind"], run.BENCH_DIR)
    control = {int(s) for s in args.control.split(",") if s}
    lower, upper = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        c = cell.Cell(args.workload, wl, spec.config(wl["config"], run.BENCH_DIR), mix, seed,
                      torch.device(args.device), run.BENCH_DIR)
        patches = faults.Patches()
        if args.fault:
            getattr(faults, args.fault)(patches.setattr)
        try:
            job = kind.Job(c)
            line = {"seed": seed, "fault": args.fault, "program": job.readings()}
        finally:
            patches.undo()
        line["program_leaves"] = getattr(job, "diagnostics", None)
        if seed in control:
            gc.collect()
            line["control"] = job.control()
            line["control_leaves"] = getattr(job, "diagnostics", None)
        del job
        for k, v in line["program"].items():
            lower[k] = max(lower.get(k, 0.0), v)
        for k, v in line.get("control", {}).items():
            upper[k] = min(upper.get(k, float("inf")), v)
        print(json.dumps(line), flush=True)
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"lower": lower, "upper": upper}), flush=True)
    bad = run.forbidden_modules()
    if bad:
        print(f"calibrate: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
