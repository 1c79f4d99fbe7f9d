"""Patch rays, Plücker coordinates, NeRF positional encoding and frame
transforms (port of custom_diffusion360_tpu/geometry/rays.py). The
stratified jitter of training takes its uniforms from a ``draws.Draws``
(names ``ray_x``, ``ray_y``: one (res + 1,) draw per axis)."""
from __future__ import annotations

import math

import torch

from .cameras import Cameras, camera_center, unproject_ndc_points


def _edge_jitter(u, edges):
    """Positions jittered uniformly inside each cell by the uniforms u
    (shaped like edges): one shared 1-D jitter per axis."""
    center = (edges[1:] + edges[:-1]) / 2.0
    upper = torch.cat([center, edges[-1:]])
    lower = torch.cat([edges[:1], center])
    return (lower + (upper - lower) * u)[:-1]


def get_patch_ray_grid(resolution: int, device="cpu", draws=None):
    """(hw, 2) NDC positions (x, y), running +1 -> -1 on both axes,
    flattened row-major (token order = image row order): pixel centers, or
    with ``draws`` positions jittered inside each pixel."""
    edges = torch.linspace(1.0, -1.0, resolution + 1, device=device)
    if draws is not None:
        xs = _edge_jitter(draws.uniform("ray_x", edges.shape, device), edges)
        ys = _edge_jitter(draws.uniform("ray_y", edges.shape, device), edges)
    else:
        xs = ys = (edges[:-1] + edges[1:]) / 2.0
    gx = xs[None, :].expand(resolution, resolution)
    gy = ys[:, None].expand(resolution, resolution)
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)


def get_patch_rays(cams: Cameras, resolution: int, draws=None):
    """World-space rays through every pixel of every camera (stratified
    inside each pixel when ``draws`` is given). cams batch (...); returns
    (rays (..., hw, 6) = (origin, unit dir), xys)."""
    xys = get_patch_ray_grid(resolution, device=cams.R.device, draws=draws)
    hw = xys.shape[0]
    xy_depth = torch.cat([xys, torch.ones((hw, 1), device=xys.device)], -1)
    xy_depth = xy_depth.expand(tuple(cams.batch_shape) + (hw, 3))
    unprojected = unproject_ndc_points(cams, xy_depth)
    origins = camera_center(cams)[..., None, :].expand(unprojected.shape)
    directions = unprojected - origins
    directions = directions / (directions.norm(dim=-1, keepdim=True) + 1e-12)
    return torch.cat([origins, directions], dim=-1), xys


def ray_points_from_rays(rays, lengths):
    """rays (..., hw, 6), lengths (..., hw, S) -> points (..., hw, S, 3)."""
    o, d = rays[..., :3], rays[..., 3:]
    return o[..., None, :] + d[..., None, :] * lengths[..., :, None]


def plucker_parameterization(rays):
    """(origin, dir) -> (unit dir, origin x unit dir); (..., 6) -> (..., 6)."""
    o, d = rays[..., :3], rays[..., 3:]
    d = d / (d.norm(dim=-1, keepdim=True) + 1e-12)
    return torch.cat([d, torch.cross(o, d, dim=-1)], dim=-1)


def pe_freqs(n_freqs: int, dtype=torch.float32, device="cpu"):
    """2^[-n/2, n/2) * pi, the NeRF frequency band."""
    start = -(n_freqs / 2.0)
    k = torch.arange(n_freqs, dtype=dtype, device=device)
    return (2.0 ** (start + k)) * math.pi


def positional_encoding(x, n_freqs: int = 10):
    """(..., d) -> (..., 2 * n_freqs * d): all sines freq-major, then all
    cosines (the reference's channel order)."""
    freqs = pe_freqs(n_freqs, x.dtype, x.device)
    xf = x[..., None, :] * freqs[:, None]
    shape = tuple(x.shape[:-1]) + (n_freqs * x.shape[-1],)
    return torch.cat([torch.sin(xf).reshape(shape), torch.cos(xf).reshape(shape)], dim=-1)


def transform_rays(rays, R, T):
    """Apply world-to-view (R, T) to (origin, direction) rays (..., 6)."""
    o = torch.einsum("...j,...jk->...k", rays[..., :3], R) + T
    d = torch.einsum("...j,...jk->...k", rays[..., 3:], R)
    return torch.cat([o, d], dim=-1)


def rays_to_view_space(cams: Cameras, rays):
    """cams batch (B, N); target rays (B, hw, 6) -> (B, N, hw, 6)."""
    return transform_rays(rays[:, None], cams.R[:, :, None], cams.T[:, :, None])


def rays_to_target_space(cams: Cameras, rays):
    """cams batch (B, N); rays (B, M, hw, 6) -> (B, M, hw, 6) in camera 0's
    frame."""
    return transform_rays(rays, cams.R[:, :1, None], cams.T[:, :1, None])


def points_to_view_space(cams: Cameras, points):
    """cams batch (B, N); target ray points (B, hw, S, 3) -> every camera's
    view frame, (B, N, hw, S, 3)."""
    return (torch.einsum("bwsj,bnjk->bnwsk", points, cams.R)
            + cams.T[:, :, None, None, :])
