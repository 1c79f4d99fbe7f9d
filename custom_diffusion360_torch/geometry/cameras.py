"""Perspective-camera math in pytorch3d's row-vector conventions (port of
the part of custom_diffusion360_tpu/geometry/cameras.py that sampling uses).

* world-to-view: ``X_view = X_world @ R + T``; camera center ``C = -T @ R^T``
* NDC: +X left, +Y up; ``x_ndc = fx * x / z + px``, ``y_ndc = fy * y / z + py``
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Cameras(NamedTuple):
    """A batch of perspective cameras; fields share leading batch dims.

    R (..., 3, 3) world-to-view rotation (row vectors); T (..., 3);
    focal_length (..., 2) and principal_point (..., 2) in NDC units;
    image_size (..., 2) as (H, W) in pixels.
    """

    R: torch.Tensor
    T: torch.Tensor
    focal_length: torch.Tensor
    principal_point: torch.Tensor
    image_size: torch.Tensor

    @property
    def batch_shape(self):
        return self.R.shape[:-2]

    def reshape(self, *shape):
        return Cameras(
            self.R.reshape(*shape, 3, 3),
            self.T.reshape(*shape, 3),
            self.focal_length.reshape(*shape, 2),
            self.principal_point.reshape(*shape, 2),
            self.image_size.reshape(*shape, 2),
        )

    def to(self, *args, **kwargs):
        return Cameras(*(f.to(*args, **kwargs) for f in self))

    @staticmethod
    def create(R, T, focal_length, principal_point, image_size=None,
               device="cpu"):
        """Build from array-likes (numpy or tensors) as float32 tensors."""
        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        R, T = f32(R), f32(T)
        batch = tuple(R.shape[:-2])
        focal_length = f32(focal_length).expand(batch + (2,)).contiguous()
        principal_point = f32(principal_point).expand(batch + (2,)).contiguous()
        image_size = f32(512.0 if image_size is None else image_size)
        image_size = image_size.expand(batch + (2,)).contiguous()
        return Cameras(R, T, focal_length, principal_point, image_size)


def camera_center(cam: Cameras):
    """(..., 3) world-space optical center: C = -T @ R^T."""
    return -torch.einsum("...j,...kj->...k", cam.T, cam.R)


def world_to_view(cam: Cameras, points):
    """points (..., N, 3) world -> view; camera batch dims broadcast."""
    return torch.einsum("...nj,...jk->...nk", points, cam.R) + cam.T[..., None, :]


def view_to_world(cam: Cameras, points):
    rinv = cam.R.transpose(-1, -2)
    return torch.einsum("...nj,...jk->...nk", points - cam.T[..., None, :], rinv)


def transform_points_ndc(cam: Cameras, points, eps: float = 1e-8):
    """World points (..., N, 3) -> NDC (..., N, 3), pytorch3d
    ``transform_points_ndc``: z is the inverse view depth, x/y divide by a
    sign-preserving eps-clamped depth."""
    pv = world_to_view(cam, points)
    z = pv[..., 2:3]
    zdiv = torch.where(z >= 0, z.clamp_min(eps), z.clamp_max(-eps))
    xy = pv[..., :2] / zdiv
    xy = xy * cam.focal_length[..., None, :] + cam.principal_point[..., None, :]
    return torch.cat([xy, 1.0 / zdiv], dim=-1)


def unproject_ndc_points(cam: Cameras, xy_depth):
    """Inverse of transform_points_ndc for (x_ndc, y_ndc, depth) triples
    (..., N, 3), depth the view-space z; returns world points."""
    depth = xy_depth[..., 2:3]
    xy_view = (
        (xy_depth[..., :2] - cam.principal_point[..., None, :])
        * depth
        / cam.focal_length[..., None, :]
    )
    pv = torch.cat([xy_view, depth], dim=-1)
    return view_to_world(cam, pv)
