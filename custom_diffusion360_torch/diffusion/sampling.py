"""Euler-EDM sampling (port of ``to_d`` and ``euler_edm_sample`` from
custom_diffusion360_tpu/diffusion/sampling.py). ``denoise_fn(x, sigma_vec)
-> denoised`` carries the guider; the loop is a plain Python loop. Churn
noise and the other samplers are not ported yet."""
from __future__ import annotations

from typing import Callable

import torch


def _append_dims(x, ndim):
    return x.reshape(tuple(x.shape) + (1,) * (ndim - x.dim()))


def to_d(x, sigma, denoised):
    """(x - denoised) / sigma."""
    return (x - denoised) / _append_dims(sigma, x.dim())


def euler_edm_sample(denoise_fn: Callable, x, sigmas, *, scale_init: bool = True,
                     callback=None):
    """EulerEDMSampler without churn. sigmas: (n+1,) descending f32 tensor.
    ``callback(i)`` runs after step i (timing hooks)."""
    if scale_init:
        x = x * torch.sqrt(1.0 + sigmas[0] ** 2)
    b = x.shape[0]
    for i in range(sigmas.shape[0] - 1):
        sigma_vec = torch.full((b,), float(sigmas[i]), dtype=torch.float32, device=x.device)
        denoised = denoise_fn(x, sigma_vec)
        d = to_d(x, sigma_vec, denoised)
        x = x + (sigmas[i + 1] - sigmas[i]) * d
        if callback is not None:
            callback(i)
    return x
