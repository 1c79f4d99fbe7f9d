"""Bilinear sampling of reference feature maps: the plain gather of
``grid_sample_2d``, differentiable in the maps through autograd. The grid's
gradient is cut, as the FeatureNeRF caller detaches the projected points."""
from __future__ import annotations

from .grid_sample import grid_sample_2d


def bilinear_sample(feats, grid):
    """feats: (M, H, W, C); grid: (M, P, 2) in [-1, 1] -> (M, P, C)."""
    return grid_sample_2d(feats, grid.detach())
