"""One run of one cell: set-up, the timed window, the traced stretch, the
check against the reference, and the result line.

A kind (``kinds/<kind>.py``) defines ``Job(cell)``, whose construction is
the set-up (weights, inputs, the program's objects, the warm-up of every
shape the traffic uses), and whose methods are:

    unit(i)         one request or step of the closed loop, ending in the
                    host-visible result a user reads (image bytes, a loss);
                    i >= 0 in the window, negative for the warm-up, the
                    spans and the traced units
    spans()         one more unit, synchronised at its phases: {span: ms}
    check()         after the window: frees the program's state, runs the
                    reference, returns the Checks
    model_flops()   model operations of one unit, counted on the reference

and the attributes ``metric`` (the end-to-end metric of the unit's time),
``scale`` (its factor on seconds) and ``trace_units``.
"""
from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import spec
from . import trace as tracing

COUNTERS = {  # launch counters of the port's op wrappers: name -> (module, function)
    "attention": ("ops.block_attention", "attention_fwd"),
    "attention_bnhd": ("ops.block_attention", "attention_bnhd_fwd"),
    "bilinear": ("ops.onehot_sample", "bilinear_sample"),
    "bilinear_bwd": ("ops.onehot_sample", "bilinear_sample_bwd"),
    "layer_norm": ("ops.norms", "layer_norm_fused"),
    "group_norm": ("ops.norms", "group_norm_fused"),
    "conv3x3": ("ops.conv3x3", "conv3x3_fwd"),
}


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    seed: int
    device: torch.device
    bench_dir: Path


@dataclass
class Context:
    """What a per-layer metric's reader reads."""

    unit_s: float  # the untraced window's seconds a unit
    spans: dict  # name -> ms, from one synchronised unit
    trace: tracing.Trace
    launches: dict  # counter -> {shape key: launches} in the traced window
    job: object = field(repr=False)

    def flops(self) -> float:
        return self.job.model_flops()


def _counters():
    import importlib

    out = {}
    for name, (mod, fn) in COUNTERS.items():
        out[name] = getattr(importlib.import_module(f"custom_diffusion360_torch.{mod}"), fn)
    return out


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             bench_dir: Path = spec.BENCH_DIR, t_start: float = None) -> dict:
    t_start = time.perf_counter() if t_start is None else t_start
    wl = spec.workload(name, bench_dir)
    mix = spec.traffic(wl["traffic"], bench_dir)
    cell = Cell(name, wl, spec.config(wl["config"], bench_dir), mix, int(seed),
                torch.device(device), bench_dir)
    bench = spec.benchmark(bench_dir)
    wanted = spec.cell_metrics(bench, name, trace)
    kind = spec.kind(mix["kind"], bench_dir)
    dev = cell.device

    job = kind.Job(cell)
    sync(dev)
    setup_s = time.perf_counter() - t_start

    n, start = 0, time.perf_counter()
    while True:
        job.unit(n)
        n += 1
        if time.perf_counter() - start >= seconds:
            break
    elapsed = time.perf_counter() - start
    unit_s = elapsed / n
    measured = {job.metric: unit_s * job.scale, "setup_s": setup_s}
    metrics = {}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1}
    result = {}
    if not trace:
        for m in wanted:
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    else:
        spans = job.spans()
        counters = _counters()
        for c in counters.values():
            c.launches_by_shape.clear()
        prof = tracing.profiler()
        sync(dev)
        with prof:
            t0 = time.perf_counter()
            for k in range(job.trace_units):
                job.unit(-3 - k)
            sync(dev)
            window_s = time.perf_counter() - t0
        launches = {k: dict(c.launches_by_shape) for k, c in counters.items()}
        tr = tracing.read(prof, job.trace_units, window_s)
        del prof
        ctx = Context(unit_s, spans, tr, launches, job)
        for m in wanted:
            value = spec.metric_reader(m["name"], bench_dir)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    if dev.type == "cuda":
        device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    checks = job.check()
    correct = all(c.ok for c in checks)
    out = {"correct": correct, "attempted": n, "failed": 0, "metrics": metrics,
           "device": device_info}
    out.update(result)
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return out


def print_result(out: dict) -> None:
    """Each compared number beside its limit as the last lines on standard
    error, then the result as the last line on standard output."""
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
