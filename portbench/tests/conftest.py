"""Fixtures of the benchmark's own tests: a copy of the benchmark's files
with tiny configurations and cells dropped in beside the real ones, run on
the CPU through the plain paths."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

BENCH_DIR = Path(__file__).resolve().parents[1]
CHECKOUT = BENCH_DIR.parent
for p in (str(CHECKOUT), str(BENCH_DIR)):  # the benchmark's own modules first
    while p in sys.path:
        sys.path.remove(p)
    sys.path.insert(0, p)

TINY_SDXL = {
    "dtype": "float32",
    "unet": {"model_channels": 64, "channel_mult": [1, 2], "transformer_depth": [1, 1],
             "attention_resolutions": [2], "context_dim": 96, "adm_in_channels": 72,
             "num_head_channels": 64, "image_cross_blocks": [0], "num_samples": 4, "num_freqs": 4},
    "vae": {"ch": 16, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 1},
    "conditioner": {
        "clip_l": {"vocab_size": 64, "width": 48, "layers": 1, "heads": 4, "context_length": 16},
        "open_clip": {"vocab_size": 64, "width": 48, "layers": 2, "heads": 4,
                      "context_length": 16, "act": "gelu", "text_projection": True},
        "size_outdim": 4},
}
TINY_AE = {"dtype": "float32",
           "vae": {"ch": 32, "ch_mult": [1], "num_res_blocks": 1, "z_channels": 4},
           "trainer": {"lr": 4.5e-6, "disc_ndf": 8, "disc_n_layers": 2, "use_lpips": True}}
# tiny cell -> (the real cell whose traffic, limits and metrics it takes, config, traffic changes)
TINY_CELLS = {
    "tiny.sample": ("sdxl_cd360.sample512_x3", "tiny_sdxl",
                    {"resolution": 64, "steps": 4, "check_requests": 2, "check_steps": 2}),
    "tiny.train": ("sdxl_cd360.train512_v4", "tiny_sdxl",
                   {"resolution": 64, "views": 2, "items": 3}),
    "tiny.ae": ("sdxl_vae_ae.ae256_b16", "tiny_ae", {"resolution": 32, "batch": 4, "batches": 2}),
}


def _dump(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_tiny_bench(tmp_path: Path) -> Path:
    """A checkout in ``tmp_path`` holding BENCHMARK.json and a copy of the
    benchmark's files, with the tiny cells of TINY_CELLS added as files (a
    config, a traffic mix and a workload each) and as entries. Returns the
    copy's bench dir."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    _dump(bench_dir / "configs" / "tiny_sdxl.json", TINY_SDXL)
    _dump(bench_dir / "configs" / "tiny_ae.json", TINY_AE)
    for tiny, (real, config, changes) in TINY_CELLS.items():
        cell = json.loads((BENCH_DIR / "workloads" / f"{real}.json").read_text())
        mix = json.loads((BENCH_DIR / "traffic" / f"{cell['traffic']}.json").read_text())
        _dump(bench_dir / "traffic" / f"tiny_{tiny[5:]}.json", dict(mix, **changes))
        _dump(bench_dir / "workloads" / f"{tiny}.json",
              dict(cell, config=config, traffic=f"tiny_{tiny[5:]}"))
        bench["workloads"].append({"name": tiny, "config": config, "traffic": f"tiny_{tiny[5:]}",
                                   "chips": 1, "why": "a test's tiny cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(tiny)
    _dump(tmp_path / "BENCHMARK.json", bench)
    return bench_dir


@pytest.fixture
def tiny_bench(tmp_path) -> Path:
    return make_tiny_bench(tmp_path)


@pytest.fixture
def cuda_card():
    """Skips the test unless a CUDA card is there (decided here, at run
    time, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
