"""Gather-based bilinear sampling, channels-last (port of
custom_diffusion360_tpu/ops/grid_sample.py), which ops/onehot_sample.py
uses."""
from __future__ import annotations

import torch


def grid_sample_2d(feats, grid, align_corners: bool = True):
    """Bilinear sampling with zero padding, torch ``grid_sample`` semantics.

    feats: (..., H, W, C) channels-last maps; grid: (..., P, 2) positions in
    [-1, 1], grid[..., 0] = x indexes W, grid[..., 1] = y indexes H; values
    outside read zeros. Returns (..., P, C). Weights are computed in f32 and
    cast to the map dtype, like the JAX version.
    """
    h, w, c = feats.shape[-3:]
    batch = feats.shape[:-3]
    feats2 = feats.reshape(-1, h * w, c)
    grid2 = grid.reshape(feats2.shape[0], -1, 2).float()

    x, y = grid2[..., 0], grid2[..., 1]
    if align_corners:
        ix = (x + 1.0) * 0.5 * (w - 1)
        iy = (y + 1.0) * 0.5 * (h - 1)
    else:
        ix = ((x + 1.0) * w - 1.0) * 0.5
        iy = ((y + 1.0) * h - 1.0) * 0.5
    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    tx = ix - x0
    ty = iy - y0

    rows = torch.arange(feats2.shape[0], device=feats.device)[:, None]

    def corner(xi, yi):
        valid = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        xc = xi.clamp(0, w - 1).long()
        yc = yi.clamp(0, h - 1).long()
        vals = feats2[rows, yc * w + xc]  # (B, P, C)
        return vals * valid[..., None].to(feats2.dtype)

    w00 = ((1 - tx) * (1 - ty))[..., None].to(feats2.dtype)
    w01 = (tx * (1 - ty))[..., None].to(feats2.dtype)
    w10 = ((1 - tx) * ty)[..., None].to(feats2.dtype)
    w11 = (tx * ty)[..., None].to(feats2.dtype)
    out = (
        corner(x0, y0) * w00
        + corner(x0 + 1, y0) * w01
        + corner(x0, y0 + 1) * w10
        + corner(x0 + 1, y0 + 1) * w11
    )
    return out.reshape(batch + grid.shape[len(batch):-1] + (c,))
