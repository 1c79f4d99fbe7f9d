#!/usr/bin/env python
"""Device time of the bilinear-sampling backward kernel
(custom_diffusion360_torch/csrc/bilinear_sample_bwd.cu) for each point-split
count, at the FeatureNeRF training shapes, on uniform and on clustered
points. Needs one CUDA card:

    python3 tools/time_bilinear_bwd.py

Prints the card's name and power limit, a line per (shape, points, splits)
with the CUDA-graph replay time of one call (kernel plus, for splits > 1,
the merge launch) and its share of the byte bound, the split count that
``ops/onehot_sample.bwd_plan`` picks, and one JSON line of all rows. Every
split count must give the same result as one split within 1e-5 of max|ref|.
"""
from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(4, 16, 16, 1288, 6144), (4, 32, 32, 648, 12288)]  # (M, H, W, C, P), f32
NEEDED = {1288: 1281, 648: 641}  # channels the FeatureNeRF reads of the padded maps


def main():
    import torch

    if not torch.cuda.is_available():
        print("time_bilinear_bwd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from custom_diffusion360_torch.ops import _build
    from custom_diffusion360_torch.ops.onehot_sample import bwd_launch, bwd_plan

    print(cs.gpu_line(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for m, h, w, c, p in SHAPES:
        g = torch.randn((m, p, c), generator=gen, device="cuda")
        band_pix, picked = bwd_plan(m, h, w, c, p, 4, _build.num_sms(0))
        need = NEEDED.get(c, c)
        bms, _ = cs.bound(4 * (m * p * need + m * p * 2 + m * h * w * need), 8.0 * m * p * need,
                          cs.H100_F32_FLOPS)
        for layout in ("uniform", "clustered"):
            grid = cs.bwd_grid(torch, gen, m, p, h, layout)
            one = bwd_launch(g, grid, (m, h, w, c), torch.float32, band_pix, 1)
            tol = 1e-5 * float(one.abs().max())
            for splits in (1, 2, 3, 4):
                run = lambda: bwd_launch(g, grid, (m, h, w, c), torch.float32,  # noqa: E731
                                         band_pix, splits)
                err = float((run() - one).abs().max())
                if not err <= tol:
                    print(f"time_bilinear_bwd: {splits} splits differ from 1 by {err}",
                          file=sys.stderr)
                    return 1
                ms = cs.graph_ms(run)
                rows.append(dict(shape=[m, h, w, c, p], points=layout, splits=splits,
                                 picked=splits == picked, device_ms=ms, bound_ms=bms))
                print(f"[bwd] M{m} {h}x{w} C{c} P{p} f32 {layout}: {splits} split(s) "
                      f"{ms:.4f} ms ({bms / ms:.1%} of the {bms:.4f} ms byte bound)"
                      + (" <- bwd_plan" if splits == picked else ""), flush=True)
    print(json.dumps({"bilinear_bwd_splits": rows}), flush=True)
    print(cs.gpu_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
