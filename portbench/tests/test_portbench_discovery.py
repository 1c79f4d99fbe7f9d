"""Discovery by file name, and BENCHMARK.json against the contract's form."""
from __future__ import annotations

import json
import re

import pytest
from conftest import BENCH_DIR, CHECKOUT

from harness import spec

BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_name_has_its_files():
    for c in BENCH["configs"]:
        assert (CHECKOUT / c["file"]).is_file()
        assert spec.config(c["name"])
    for w in BENCH["workloads"]:
        cell = spec.workload(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert spec.kind(spec.traffic(w["traffic"])["kind"]).Job
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_contract_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in BENCH["end_to_end"] + BENCH["per_layer"]}) == (
        len(BENCH["end_to_end"]) + len(BENCH["per_layer"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m) <= {"name", "unit", "better", "source", "layer",
                                                  "moves", "workloads"}
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        reported = spec.cell_metrics(BENCH, w["name"], False)
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert spec.cell_metrics(BENCH, w["name"], True)
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_a_dropped_in_workload_is_found(tiny_bench):
    for name in ("tiny.sample", "tiny.train", "tiny.ae"):
        cell = spec.workload(name, tiny_bench)
        assert spec.config(cell["config"], tiny_bench)
        assert spec.traffic(cell["traffic"], tiny_bench)["kind"]
    bench = spec.benchmark(tiny_bench)
    got = {m["name"] for m in spec.cell_metrics(bench, "tiny.train", True)}
    assert got == {m["name"] for m in BENCH["per_layer"]
                   if "sdxl_cd360.train512_v4" in m["workloads"]}


def test_unknown_and_malformed_names_raise():
    with pytest.raises(FileNotFoundError):
        spec.workload("no_such_cell")
    with pytest.raises(ValueError):
        spec.workload("../configs/sdxl_cd360")


def test_benchmark_files_only_under_paths():
    assert BENCH["paths"] == [BENCH_DIR.name]
    assert BENCH["command"] == ["python3", f"{BENCH_DIR.name}/run.py"]
