"""Bilinear sampling of reference feature maps, the FeatureNeRF inner loop
(port of custom_diffusion360_tpu/ops/onehot_sample.py).

The TPU package wrote this as a one-hot matmul (``bilinear_sample_matmul``)
and as a Pallas kernel (``bilinear_sample_pallas``). On Hopper the natural
form is a 4-corner gather: ``csrc/bilinear_sample.cu``, launched by
``bilinear_sample``. Its plain version is ops/grid_sample.grid_sample_2d.
"""
from __future__ import annotations

from collections import Counter

import torch

from . import _build
from .grid_sample import grid_sample_2d

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def bilinear_sample(feats, grid):
    """feats: (M, H, W, C) contiguous bf16 or f32; grid: (M, P, 2) in
    [-1, 1] (cast to contiguous f32 here). Returns (M, P, C) in feats.dtype
    with f32 accumulation, align_corners=True, zero padding.

    CUDA tensors launch the kernel; CPU tensors run ``grid_sample_2d``.
    Channel rows take 16-byte vector loads when
    C * itemsize is a multiple of 16, and scalar loads otherwise: the
    FeatureNeRF caller pads its odd C + 1 channel maps to a multiple of 8
    (models/nerf.project_ref_maps), so the main path takes the vector path.
    Launches are counted in ``bilinear_sample.launches``, and by shape
    (M, H, W, C, P) in ``bilinear_sample.launches_by_shape``.
    """
    if feats.device.type == "cpu":
        return grid_sample_2d(feats, grid)
    m, h, w, c = feats.shape
    if grid.shape[0] != m or grid.shape[-1] != 2 or grid.dim() != 3:
        raise ValueError(f"grid {tuple(grid.shape)} does not match feats {tuple(feats.shape)}")
    if feats.dtype not in _DTYPES:
        raise TypeError(f"bilinear kernel takes bf16 or f32 maps, got {feats.dtype}")
    if not feats.is_contiguous():
        raise ValueError("bilinear kernel needs contiguous maps")
    if grid.device != feats.device:
        raise ValueError("bilinear kernel needs grid and maps on one device")
    grid = grid.to(torch.float32).contiguous()
    p = grid.shape[1]
    out = torch.empty((m, p, c), dtype=feats.dtype, device=feats.device)
    vec = int((c * feats.element_size()) % 16 == 0 and feats.data_ptr() % 16 == 0)
    fn = _build.load("bilinear_sample")
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        rc = fn(feats.data_ptr(), grid.data_ptr(), out.data_ptr(), m, h, w, c,
                p, _DTYPES[feats.dtype], vec, stream)
    _build.check(rc, "bilinear_sample")
    bilinear_sample.launches += 1
    bilinear_sample.launches_by_shape[(m, h, w, c, p)] += 1
    return out


bilinear_sample.launches = 0
bilinear_sample.launches_by_shape = Counter()
