"""EDM-preconditioned discrete denoiser, inference path (port of
custom_diffusion360_tpu/diffusion/denoiser.py with SDXL's settings: eps
scaling, 1000-step LegacyDDPM grid, quantized c_noise):

    D(x, sigma) = network(x * c_in, c_noise, cond) * c_out + x * c_skip

with sigma quantized to the nearest entry of the grid and c_noise the grid
index (first index on ties, as jnp.argmin). The reference-latent noising of
training is not ported yet.
"""
from __future__ import annotations

from typing import Callable

import torch

from .discretization import legacy_ddpm_sigmas
from .scaling import eps_scaling

NUM_IDX = 1000


def _append_dims(x, ndim):
    return x.reshape(tuple(x.shape) + (1,) * (ndim - x.dim()))


class Denoiser:
    def __init__(self, device="cpu"):
        # ascending grid without zero
        self.sigmas = legacy_ddpm_sigmas(NUM_IDX, device=device, append_zero=False, flip=True)

    def sigma_to_idx(self, sigma):
        # torch.argmin returns the first minimal index, like jnp.argmin
        return torch.argmin((sigma[..., None] - self.sigmas.to(sigma.device)).abs(), dim=-1)

    def quantize_sigma(self, sigma):
        return self.sigmas.to(sigma.device)[self.sigma_to_idx(sigma)]

    def __call__(self, network: Callable, x, sigma, cond, **kwargs):
        """network(x_scaled, c_noise, cond, **kw) -> (pred, aux); returns
        (denoised, aux). x: (B, H, W, C); sigma: (B,)."""
        sigma = self.quantize_sigma(sigma)
        c_skip, c_out, c_in, _ = eps_scaling(_append_dims(sigma, x.dim()))
        c_noise = self.sigma_to_idx(sigma).float()
        pred, aux = network(x * c_in, c_noise, cond, **kwargs)
        return pred * c_out + x * c_skip, aux
