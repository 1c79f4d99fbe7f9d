"""Bilinear sampling of reference feature maps, the FeatureNeRF inner loop
(port of custom_diffusion360_tpu/ops/onehot_sample.py).

The TPU package wrote this as a one-hot matmul (``bilinear_sample_matmul``)
and as a Pallas kernel (``bilinear_sample_pallas``, whose VJP is W^T g). On
Hopper the natural form is a 4-corner gather, ``csrc/bilinear_sample.cu``,
and its transpose, a 4-corner scatter-add, ``csrc/bilinear_sample_bwd.cu``.
``bilinear_sample`` is an autograd Function over the two: the gradient
with respect to the maps is W^T g, the grid's is zero (the FeatureNeRF
caller stops it, as the reference detaches the projected points). Plain
versions: ops/grid_sample.grid_sample_2d and its autograd.
"""
from __future__ import annotations

from collections import Counter

import torch

from . import _build
from .grid_sample import grid_sample_2d

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}


def _check(feats_shape, grid, device):
    m = feats_shape[0]
    if grid.dim() != 3 or grid.shape[0] != m or grid.shape[-1] != 2:
        raise ValueError(f"grid {tuple(grid.shape)} does not match maps {tuple(feats_shape)}")
    if grid.device != device:
        raise ValueError("bilinear kernel needs grid and maps on one device")


def _vec(c, t):
    return int((c * t.element_size()) % 16 == 0 and t.data_ptr() % 16 == 0)


def _sample_forward(feats, grid):
    """The forward launch: CUDA tensors launch the kernel, CPU tensors run
    ``grid_sample_2d``."""
    if feats.device.type == "cpu":
        return grid_sample_2d(feats, grid)
    m, h, w, c = feats.shape
    _check(feats.shape, grid, feats.device)
    if feats.dtype not in _DTYPES:
        raise TypeError(f"bilinear kernel takes bf16 or f32 maps, got {feats.dtype}")
    if not feats.is_contiguous():
        raise ValueError("bilinear kernel needs contiguous maps")
    grid = grid.to(torch.float32).contiguous()
    p = grid.shape[1]
    out = torch.empty((m, p, c), dtype=feats.dtype, device=feats.device)
    fn = _build.load("bilinear_sample")
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        rc = fn(feats.data_ptr(), grid.data_ptr(), out.data_ptr(), m, h, w, c,
                p, _DTYPES[feats.dtype], _vec(c, feats), stream)
    _build.check(rc, "bilinear_sample")
    bilinear_sample.launches += 1
    bilinear_sample.launches_by_shape[(m, h, w, c, p, _DTYPE_NAMES[feats.dtype])] += 1
    return out


def bilinear_sample_bwd_plain(g, grid, feats_shape, dtype):
    """W^T g through the autograd of ``grid_sample_2d`` (linear in the maps,
    so zero maps serve as the point of linearisation)."""
    with torch.enable_grad():
        f = torch.zeros(feats_shape, dtype=dtype, device=g.device, requires_grad=True)
        (d,) = torch.autograd.grad(grid_sample_2d(f, grid.detach()), f, g)
    return d


def bilinear_sample_bwd(g, grid, feats_shape, dtype):
    """dFeats = W^T g for the cotangent g (M, P, C) of ``bilinear_sample`` at
    ``grid`` (M, P, 2) -> (M, H, W, C) in ``dtype``. CUDA tensors launch
    ``csrc/bilinear_sample_bwd.cu`` (f32 atomics into a zeroed f32
    accumulator, cast to ``dtype``); CPU tensors run
    ``bilinear_sample_bwd_plain``. Launches are counted in
    ``bilinear_sample_bwd.launches`` and by shape (M, H, W, C, P, dtype)."""
    if g.device.type == "cpu":
        return bilinear_sample_bwd_plain(g, grid, feats_shape, dtype)
    m, h, w, c = feats_shape
    _check(feats_shape, grid, g.device)
    if g.dtype not in _DTYPES or dtype not in _DTYPES:
        raise TypeError(f"bilinear backward kernel takes bf16 or f32, got {g.dtype} -> {dtype}")
    if tuple(g.shape) != (m, grid.shape[1], c):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match maps {tuple(feats_shape)}")
    g = g.contiguous()
    grid = grid.to(torch.float32).contiguous()
    p = grid.shape[1]
    acc = torch.zeros((m, h, w, c), dtype=torch.float32, device=g.device)
    fn = _build.load("bilinear_sample_bwd")
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(g.data_ptr(), grid.data_ptr(), acc.data_ptr(), m, h, w, c, p,
                _DTYPES[g.dtype], _vec(c, g), stream)
    _build.check(rc, "bilinear_sample_bwd")
    bilinear_sample_bwd.launches += 1
    bilinear_sample_bwd.launches_by_shape[(m, h, w, c, p, _DTYPE_NAMES[g.dtype])] += 1
    return acc if dtype == torch.float32 else acc.to(dtype)


class _BilinearSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, grid):
        ctx.save_for_backward(grid)
        ctx.feats = (tuple(feats.shape), feats.dtype)
        return _sample_forward(feats, grid)

    @staticmethod
    def backward(ctx, g):
        (grid,) = ctx.saved_tensors
        d_feats = None
        if ctx.needs_input_grad[0]:
            d_feats = bilinear_sample_bwd(g, grid, *ctx.feats)
        d_grid = torch.zeros_like(grid) if ctx.needs_input_grad[1] else None
        return d_feats, d_grid


def bilinear_sample(feats, grid):
    """feats: (M, H, W, C) contiguous bf16 or f32; grid: (M, P, 2) in
    [-1, 1] (cast to contiguous f32 on the card). Returns (M, P, C) in
    feats.dtype with f32 accumulation, align_corners=True, zero padding.
    Differentiable in feats (W^T g); the grid gets a zero gradient.

    CUDA tensors launch the kernel; CPU tensors run ``grid_sample_2d``.
    Channel rows take 16-byte vector loads when C * itemsize is a multiple
    of 16, and scalar loads otherwise: the FeatureNeRF caller pads its odd
    C + 1 channel maps to a multiple of 8 (models/nerf.project_ref_maps), so
    the main path takes the vector path. Launches are counted in
    ``bilinear_sample.launches``, and by shape (M, H, W, C, P, dtype) in
    ``bilinear_sample.launches_by_shape``.
    """
    return _BilinearSample.apply(feats, grid)


bilinear_sample.launches = 0
bilinear_sample.launches_by_shape = Counter()
bilinear_sample_bwd.launches = 0
bilinear_sample_bwd.launches_by_shape = Counter()
