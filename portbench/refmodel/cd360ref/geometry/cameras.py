"""Perspective-camera math in pytorch3d's row-vector conventions (port of
custom_diffusion360_tpu/geometry/cameras.py).

* world-to-view: ``X_view = X_world @ R + T``; camera center ``C = -T @ R^T``
* NDC: +X left, +Y up; ``x_ndc = fx * x / z + px``, ``y_ndc = fy * y / z + py``

A ``Cameras`` holds tensors, or numpy arrays on the host
(``Cameras.create(..., xp=np)``): the data loader normalizes and crops its
cameras in numpy, once per sequence and per item, as the JAX loader does
(``xp=np`` there), and ``data.co3d.collate`` turns the batch into tensors.
The normalization and crop helpers (``normalize_cameras``,
``adjust_camera_to_bbox_crop``, ``adjust_camera_to_image_scale``) take and
return numpy cameras; ``stack_cameras`` and ``concat_cameras`` take either.
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

    def __getitem__(self, idx):
        """Index the batch dims of every field (an int, a slice or an index
        array), as the JAX ``Cameras``; the fields stay ``.R``, ``.T``..."""
        if isinstance(idx, np.ndarray):
            idx = torch.as_tensor(idx, device=self.R.device)
        return Cameras(*(f[idx] for f in self))

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
               device="cpu", xp=torch):
        """Build from array-likes (numpy or tensors) as float32 tensors, or
        with ``xp=np`` as float32 numpy arrays (host cameras)."""
        if xp is np:
            def f32(x):
                return np.asarray(x, np.float32)

            def expand(x, shape):
                return np.broadcast_to(x, shape)
        else:
            def f32(x):
                return torch.as_tensor(np.asarray(x, np.float32), device=device)

            def expand(x, shape):
                return x.expand(shape).contiguous()

        R, T = f32(R), f32(T)
        batch = tuple(R.shape[:-2])
        focal_length = expand(f32(focal_length), batch + (2,))
        principal_point = expand(f32(principal_point), batch + (2,))
        image_size = expand(f32(512.0 if image_size is None else image_size), batch + (2,))
        return Cameras(R, T, focal_length, principal_point, image_size)

    def tensors(self, device="cpu"):
        """The same cameras as float32 tensors on ``device``."""
        return Cameras(*(torch.from_numpy(np.array(f, np.float32)).to(device)
                         if isinstance(f, np.ndarray) else f.to(device) for f in self))


def stack_cameras(cams, dim=0):
    """Stack a list of Cameras along a new batch dim."""
    if isinstance(cams[0].R, np.ndarray):
        return Cameras(*(np.stack(x, axis=dim) for x in zip(*cams)))
    return Cameras(*(torch.stack(x, dim=dim) for x in zip(*cams)))


def concat_cameras(cams, dim=0):
    """Concatenate Cameras along an existing batch dim (pytorch3d's
    join_cameras_as_batch)."""
    if isinstance(cams[0].R, np.ndarray):
        return Cameras(*(np.concatenate(x, axis=dim) for x in zip(*cams)))
    return Cameras(*(torch.cat(x, dim=dim) for x in zip(*cams)))


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


def interpolate_camera_translation(cam: Cameras, offsets) -> Cameras:
    """Move one camera (batch shape ()) by view-space ``offsets`` (K, 3),
    keeping its orientation -> Cameras of batch (K,)."""
    offsets = torch.as_tensor(np.asarray(offsets, np.float32), device=cam.R.device)
    k = offsets.shape[0]
    new_center = view_to_world(cam, offsets[None])[0]  # (K, 3) world points
    new_t = -torch.einsum("kj,jl->kl", new_center, cam.R)  # T = -C @ R

    def tile(x):
        return x[None].expand((k,) + tuple(x.shape)).contiguous()

    return Cameras(tile(cam.R), new_t, tile(cam.focal_length), tile(cam.principal_point),
                   tile(cam.image_size))


def interpolate_camera_focal(cam: Cameras, scales) -> Cameras:
    """One camera (batch shape ()) with its focal length times each of
    ``scales`` (K,) -> Cameras of batch (K,)."""
    scales = torch.as_tensor(np.asarray(scales, np.float32), device=cam.R.device)[:, None]
    k = scales.shape[0]

    def tile(x):
        return x[None].expand((k,) + tuple(x.shape)).contiguous()

    return Cameras(tile(cam.R), tile(cam.T), cam.focal_length[None] * scales,
                   tile(cam.principal_point), tile(cam.image_size))


# ---------------------------------------------------------------------------
# host cameras: normalization and the crop / rescale intrinsics
# (numpy, float32 as the fields are, as the JAX package's numpy path)
# ---------------------------------------------------------------------------


def _np_fields(cam: Cameras) -> Cameras:
    return Cameras(*(np.asarray(f) for f in cam))


def _intersect_skew_lines(p, r):
    """Least-squares point closest to lines with origins p and directions r
    (N, 3) -> (3,)."""
    r = r / (np.linalg.norm(r, axis=-1, keepdims=True) + 1e-12)
    eye = np.eye(3, dtype=p.dtype)
    i_min_cov = eye[None] - r[..., :, None] * r[..., None, :]  # (N, 3, 3)
    a = i_min_cov.sum(axis=0)
    b = np.einsum("nij,nj->i", i_min_cov, p)
    return np.linalg.solve(a + 1e-10 * eye, b)


def optical_axis_intersection(cams: Cameras):
    """Point closest to all optical axes of a (N,) batch and each camera's
    distance to it -> (p_intersect (3,), dist (N,))."""
    cams = _np_fields(cams)
    centers = -np.einsum("...j,...kj->...k", cams.T, cams.R)  # (N, 3)
    pp = cams.principal_point
    # the principal point at depth 1, unprojected to the world
    xy_view = (pp - pp) * 1.0 / cams.focal_length
    pv = np.concatenate([xy_view, np.ones_like(pp[..., :1])], -1)[:, None, :]
    pp_world = np.einsum("...nj,...jk->...nk", pv - cams.T[..., None, :],
                         np.swapaxes(cams.R, -1, -2))[:, 0]
    p_intersect = _intersect_skew_lines(centers, pp_world - centers)
    dist = np.linalg.norm(p_intersect[None] - centers, axis=-1)
    return p_intersect, dist


def normalize_cameras(cams: Cameras, scale=None):
    """Move the optical-axis intersection to the origin and divide the
    translations by the largest camera distance (or ``scale``) ->
    (cameras, p_intersect, scale)."""
    cams = _np_fields(cams)
    p_intersect, dist = optical_axis_intersection(cams)
    s = np.max(dist) if scale is None else np.asarray(scale, cams.T.dtype)
    new_t = (np.einsum("j,njk->nk", p_intersect, cams.R) + cams.T) / s
    return cams._replace(T=new_t), p_intersect, s


def _ndc_to_px(cam: Cameras):
    """NDC intrinsics -> pixel (fx, fy, cx, cy) for the stored image_size."""
    h, w = cam.image_size[..., 0], cam.image_size[..., 1]
    s = np.minimum(h, w) / 2.0
    fx_px = cam.focal_length[..., 0] * s
    fy_px = cam.focal_length[..., 1] * s
    cx_px = w / 2.0 - cam.principal_point[..., 0] * s
    cy_px = h / 2.0 - cam.principal_point[..., 1] * s
    return fx_px, fy_px, cx_px, cy_px


def _px_to_ndc(fx_px, fy_px, cx_px, cy_px, image_size):
    h, w = image_size[..., 0], image_size[..., 1]
    s = np.minimum(h, w) / 2.0
    focal = np.stack([fx_px / s, fy_px / s], -1)
    pp = np.stack([(w / 2.0 - cx_px) / s, (h / 2.0 - cy_px) / s], -1)
    return focal, pp


def adjust_camera_to_bbox_crop(cam: Cameras, bbox_xywh) -> Cameras:
    """Intrinsics re-expressed for a crop box (x0, y0, w, h) in pixels."""
    cam = _np_fields(cam)
    bbox_xywh = np.asarray(bbox_xywh, np.float32)
    fx_px, fy_px, cx_px, cy_px = _ndc_to_px(cam)
    cx_px = cx_px - bbox_xywh[..., 0]
    cy_px = cy_px - bbox_xywh[..., 1]
    new_size = np.stack([bbox_xywh[..., 3], bbox_xywh[..., 2]], -1)  # (H, W)
    focal, pp = _px_to_ndc(fx_px, fy_px, cx_px, cy_px, new_size)
    return cam._replace(focal_length=focal, principal_point=pp, image_size=new_size)


def adjust_camera_to_image_scale(cam: Cameras, new_size_hw) -> Cameras:
    """Intrinsics re-expressed after resizing the image to ``new_size_hw``."""
    cam = _np_fields(cam)
    new_size = np.broadcast_to(np.asarray(new_size_hw, np.float32), cam.image_size.shape)
    fx_px, fy_px, cx_px, cy_px = _ndc_to_px(cam)
    sx = new_size[..., 1] / cam.image_size[..., 1]
    sy = new_size[..., 0] / cam.image_size[..., 0]
    focal, pp = _px_to_ndc(fx_px * sx, fy_px * sy, cx_px * sx, cy_px * sy, new_size)
    return cam._replace(focal_length=focal, principal_point=pp, image_size=new_size)
