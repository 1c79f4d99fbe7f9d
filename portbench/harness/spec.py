"""Discovery by name. Everything that belongs to one configuration, one
traffic mix, one cell or one per-layer metric sits in a file of its own:

    configs/<config>.json      the model's sizes, as run
    traffic/<traffic>.json     the mix's parameters and its ``kind``
    kinds/<kind>.py            the generator of that kind of traffic
    workloads/<cell>.json      the cell: config, traffic, chips, why, limits
    metrics/<metric>.py        the reader of one per-layer metric

A later change adds a cell or a metric by adding files and entries, never
by editing one that is there."""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(name: str, what: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{what} name {name!r} is not a benchmark name")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    cell = load_json(bench_dir / "workloads" / f"{_name(name, 'workload')}.json")
    for key in ("config", "traffic", "chips", "why"):
        if key not in cell:
            raise ValueError(f"workload {name}: no {key!r}")
    return dict(cell, name=name)


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return dict(load_json(bench_dir / "configs" / f"{_name(name, 'config')}.json"), name=name)


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    mix = load_json(bench_dir / "traffic" / f"{_name(name, 'traffic')}.json")
    if "kind" not in mix:
        raise ValueError(f"traffic {name}: no 'kind'")
    return dict(mix, name=name)


def _load_file(path: Path, module_name: str):
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(module_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str, bench_dir: Path = BENCH_DIR):
    """The generator module of a traffic kind (kinds/<kind>.py)."""
    return _load_file(bench_dir / "kinds" / f"{_name(name, 'kind')}.py", f"portbench_kind_{name}")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``read(ctx)`` of metrics/<name>.py: the metric's value, or None where
    the run gives it nothing to read."""
    mod = _load_file(bench_dir / "metrics" / f"{_name(name, 'metric')}.py",
                     "portbench_metric_" + name.replace(".", "_").replace("-", "_"))
    return mod.read


def benchmark(bench_dir: Path = BENCH_DIR) -> dict:
    """BENCHMARK.json at the root of the checkout that holds ``bench_dir``."""
    return load_json(bench_dir.parent / "BENCHMARK.json")


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a cell reports: with ``trace`` its per-layer metrics,
    else its end-to-end ones. A metric with a ``workloads`` key is reported
    in those cells; one without it in every cell (an end-to-end metric) or
    in every cell that reports the metric it moves (a per-layer one)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
