"""The video sampling kind end to end at a tiny size on the CPU: set-up, the
window, the traced stretch with each of its metric readers, the check, and
both controls failing the cell's limits. The tiny cell is dropped in beside
the others of ``conftest.make_tiny_bench``."""
from __future__ import annotations

import json

import pytest
import torch
from conftest import BENCH_DIR, make_tiny_bench

from harness import cell, spec

SEED = 2**31 + 54321  # a large seed, past 32 signed bits
REAL = "svd_img2vid.video14_576x1024"
TINY = "tiny.video"
TINY_SVD = {
    "dtype": "float32",
    "unet": {"in_channels": 8, "out_channels": 4, "model_channels": 32, "channel_mult": [1, 2],
             "num_res_blocks": 1, "attention_resolutions": [1, 2], "transformer_depth": 1,
             "num_head_channels": 16, "context_dim": 32, "adm_in_channels": 24,
             "merge_factor": 0.5, "video_kernel_size": [3, 1, 1]},
    "vae": {"ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1, "in_channels": 3, "out_ch": 3,
            "z_channels": 4, "double_z": True, "scale_factor": 0.18215},
    "conditioner": {"vision": {"image_size": 28, "patch_size": 14, "width": 64, "layers": 2,
                               "heads": 4, "mlp_ratio": 4, "embed_dim": 32},
                    "outdim": 8, "n_cond_frames": 1, "n_copies": 1},
    "denoiser": {"scaling": "VScalingWithEDMNoise"},
}
TINY_MIX = {"width": 24, "height": 16, "frames": 3, "steps": 3, "check_steps": 2}
NEW_METRICS = ("mfu.video", "idle_share.video", "span.video.step_device_ms",
               "span.video.temporal_device_ms", "roofline_span.attention.video")


@pytest.fixture
def video_bench(tmp_path):
    bench_dir = make_tiny_bench(tmp_path)
    cell_file = json.loads((BENCH_DIR / "workloads" / f"{REAL}.json").read_text())
    mix = json.loads((BENCH_DIR / "traffic" / f"{cell_file['traffic']}.json").read_text())
    (bench_dir / "configs" / "tiny_svd.json").write_text(json.dumps(TINY_SVD))
    (bench_dir / "traffic" / "tiny_video.json").write_text(json.dumps(dict(mix, **TINY_MIX)))
    (bench_dir / "workloads" / f"{TINY}.json").write_text(
        json.dumps(dict(cell_file, config="tiny_svd", traffic="tiny_video")))
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": TINY, "config": "tiny_svd", "traffic": "tiny_video",
                               "chips": 1, "why": "a test's tiny cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if REAL in m.get("workloads", []):
            m["workloads"].append(TINY)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench_dir


def _job(bench_dir):
    wl = spec.workload(TINY, bench_dir)
    mix = spec.traffic(wl["traffic"], bench_dir)
    c = cell.Cell(TINY, wl, spec.config(wl["config"], bench_dir), mix, SEED,
                  torch.device("cpu"), bench_dir)
    return spec.kind(mix["kind"], bench_dir).Job(c), wl["limits"]


@pytest.mark.parametrize("trace", [False, True])
def test_the_tiny_video_cell_runs_and_is_correct(video_bench, trace):
    out = cell.run_cell(TINY, SEED, 0.2, trace, "cpu", video_bench)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"cond", "step", "latent", "image"}
    assert out["attempted"] >= 1 and out["failed"] == 0
    if trace:
        # the span readers find no device trace on the CPU; the counted
        # operations over the host clock still give a number
        assert set(out["metrics"]) == {"mfu.video", "idle_share.video"}
        assert out["metrics"]["mfu.video"]["value"] > 0
    else:
        assert set(out["metrics"]) == {"image_s", "setup_s"}


def test_the_new_metrics_are_the_cells():
    bench = spec.benchmark(BENCH_DIR)
    got = {m["name"] for m in spec.cell_metrics(bench, REAL, True)}
    assert got == set(NEW_METRICS)
    assert {m["name"] for m in spec.cell_metrics(bench, REAL, False)} == {"image_s", "setup_s"}


@pytest.mark.parametrize("control", ["control", "alpha_one"])
def test_each_control_fails_the_limits(video_bench, control):
    """The fp8-operand reference and the program without its temporal
    layers (every alpha 1) each fail a limit that the program passes."""
    job, limits = _job(video_bench)
    program = job.readings()
    assert all(program[k] <= v for k, v in limits.items()), (program, limits)
    job, _ = _job(video_bench)
    got = getattr(job, control)()
    assert any(got[k] > v for k, v in limits.items()), (control, got, limits)
