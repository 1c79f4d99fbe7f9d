"""Image resize with ``jax.image.resize``'s kernels and antialiasing (the
port's own copy of the ``method="linear"`` and ``"cubic"`` paths, with
``antialias=True``, of jax/_src/image/scale.py).

Each resized axis gets one (in, out) weight matrix (``resize_weights``):
output o samples the input at (o + 0.5) / scale - 0.5; the kernel (the
triangle, or Keys' cubic with a = -0.5) is widened by 1 / scale when
downsampling, so it low-pass filters as it interpolates; each output's
weights are normalized to sum to 1 and zeroed where the sample falls
outside [-0.5, in - 0.5]. The image is then contracted with each matrix in
float32. An axis whose size does not change is left as it is.

``F.interpolate`` is not this: its bicubic kernel has a = -0.75 and it does
not antialias unless asked, so the FID and CLIP inputs it gave would differ
from the JAX package's.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x):
    """Keys' cubic convolution kernel, a = -0.5, of |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def resize_weights(src: int, dst: int, method: str, device=None):
    """(src, dst) float32 weights resizing one axis from ``src`` to ``dst``
    samples (``jax.image.resize``'s ``compute_weight_mat`` with
    antialiasing)."""
    kernel = KERNELS[method]
    inv_scale = 1.0 / (dst / src)
    kernel_scale = max(inv_scale, 1.0)
    f32 = dict(dtype=torch.float32, device=device)
    sample_f = (torch.arange(dst, **f32) + 0.5) * torch.tensor(inv_scale, **f32) - 0.5
    x = (sample_f[None, :] - torch.arange(src, **f32)[:, None]).abs() / torch.tensor(
        kernel_scale, **f32)
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= src - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


# the weights a resize reads, made once a (src, dst, method, device): building
# them copies two scalars from the host, which a piecewise CUDA-graph capture
# (utils/graphs.py) cannot hold
_weights = functools.lru_cache(maxsize=64)(resize_weights)


def resize_images(x, size, method: str):
    """(B, H, W, C) -> (B, *size, C) float32; ``size`` (h, w) or an int."""
    h, w = (size, size) if isinstance(size, int) else size
    x = x.float()
    if x.shape[1] != h:
        x = torch.einsum("bhwc,hH->bHwc", x, _weights(x.shape[1], h, method, x.device))
    if x.shape[2] != w:
        x = torch.einsum("bhwc,wW->bhWc", x, _weights(x.shape[2], w, method, x.device))
    return x
