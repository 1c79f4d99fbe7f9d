"""Training metrics and image grids (port of custom_diffusion360_tpu/train/
logging.py): a step-time and images/min meter writing ``metrics.csv``,
the device's memory counters, a PNG grid writer and the prompts rendered
as images (Pillow)."""
from __future__ import annotations

import csv
import os
import time
from typing import Optional

import numpy as np
import torch


class MetricsLogger:
    """Rolling step-time + throughput meter; writes metrics.csv. A row with
    keys the file lacks (the val_* rows, or a resumed run's file) rewrites
    the file under the union of the headers."""

    def __init__(self, out_dir: str, images_per_step: int, window: int = 50,
                 wandb_project: Optional[str] = None, run_name: str = ""):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.csv")
        self.images_per_step = images_per_step
        self.window = window
        self.times: list = []
        self._file = None
        self._writer = None
        self._last = None
        self._wandb = None
        if wandb_project:
            try:
                import wandb
            except ImportError as e:
                raise RuntimeError("--wandb requires the wandb package") from e
            self._wandb = wandb
            wandb.init(project=wandb_project, name=run_name or None, dir=out_dir)

    def tic(self):
        self._last = time.perf_counter()

    def toc(self):
        if self._last is None:
            return 0.0
        dt = time.perf_counter() - self._last
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def images_per_min(self):
        if not self.times:
            return 0.0
        return 60.0 * self.images_per_step / (sum(self.times) / len(self.times))

    @staticmethod
    def device_memory_stats():
        """{device: {bytes_in_use, peak_bytes_in_use}} of every CUDA device
        (``torch.cuda.memory_stats``); empty without one."""
        out = {}
        if not torch.cuda.is_available():
            return out
        for i in range(torch.cuda.device_count()):
            s = torch.cuda.memory_stats(i)
            out[f"cuda:{i}"] = {"bytes_in_use": s.get("allocated_bytes.all.current"),
                                "peak_bytes_in_use": s.get("allocated_bytes.all.peak")}
        return out

    def log(self, step: int, metrics: dict):
        row = {"step": step, "images_per_min": round(self.images_per_min, 2)}
        row.update({k: float(v) for k, v in metrics.items()})
        if self._writer is None or any(k not in self._writer.fieldnames for k in row):
            fields = list(row) if self._writer is None else list(
                dict.fromkeys(list(self._writer.fieldnames) + list(row)))
            existing = []
            if self._file is not None:
                self._file.close()
            if os.path.exists(self.path) and os.path.getsize(self.path):
                with open(self.path, newline="") as f:
                    reader = csv.DictReader(f)
                    if reader.fieldnames:
                        fields = list(dict.fromkeys(list(reader.fieldnames) + fields))
                        existing = [r for r in reader if r.get("step") != "step"]
            self._file = open(self.path, "w", newline="")
            self._writer = csv.DictWriter(self._file, fieldnames=fields, restval="",
                                          extrasaction="ignore")
            self._writer.writeheader()
            for r in existing:
                self._writer.writerow({k: v for k, v in r.items() if k in fields and v})
        self._writer.writerow(row)
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(row, step=step)
        return row

    def log_images(self, step: int, name: str, path: str):
        """Mirror an already-written image grid to wandb."""
        if self._wandb is not None:
            self._wandb.log({name: self._wandb.Image(path)}, step=step)

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = self._writer = None


def render_text_image(texts, size: int = 256):
    """The prompts ``texts`` drawn in black on white with Pillow's default
    font, wrapped every size / 8 characters -> (N, size, size, 3) f32 in
    [-1, 1]."""
    from PIL import Image, ImageDraw

    out = []
    for txt in texts:
        img = Image.new("RGB", (size, size), "white")
        nc = max(int(size / 8), 1)
        lines = "\n".join(txt[i: i + nc] for i in range(0, len(txt), nc))
        ImageDraw.Draw(img).text((4, 4), lines, fill="black")
        out.append(np.asarray(img, np.float32) / 127.5 - 1.0)
    return np.stack(out)


def save_image_grid(path: str, images, nrow: int = 4):
    """images (N, H, W, 3) in [-1, 1] -> one PNG grid of ``nrow`` columns."""
    from ..cli.sample import write_png

    arr = np.asarray(images, np.float32)
    arr = np.clip((arr + 1.0) * 127.5, 0, 255).astype(np.uint8)
    n, h, w, c = arr.shape
    ncol = min(nrow, n)
    nrows = -(-n // ncol)
    grid = np.zeros((nrows * h, ncol * w, c), np.uint8)
    for i in range(n):
        r, cl = divmod(i, ncol)
        grid[r * h: (r + 1) * h, cl * w: (cl + 1) * w] = arr[i]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, grid)
    return path
