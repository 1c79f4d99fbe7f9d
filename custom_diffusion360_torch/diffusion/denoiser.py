"""EDM-preconditioned discrete denoiser, inference path (port of
custom_diffusion360_tpu/diffusion/denoiser.py with SDXL's settings: eps
scaling, 1000-step LegacyDDPM grid, quantized c_noise):

    D(x, sigma) = network(x * c_in, c_noise, cond) * c_out + x * c_skip

with sigma quantized to the nearest entry of the grid and c_noise the grid
index (first index on ties, as jnp.argmin). In training the reference
latents are noised here a second time with ``sigmas_ref`` (on top of the
loss's noising: the reference implementation's double noising, kept for
parity), c_in-scaled, and their sigmas quantized to grid indices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .discretization import legacy_ddpm_sigmas
from .scaling import eps_scaling, eps_weighting

NUM_IDX = 1000


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    """The JAX package's denoiser settings, so its config files load; the
    port implements these values only (``Engine`` refuses others)."""

    scaling: str = "eps"
    weighting: str = "eps"
    discrete: bool = True
    num_idx: int = NUM_IDX
    quantize_c_noise: bool = True


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

    def w(self, sigma):
        """Loss weight of the eps parameterization, sigma^-2."""
        return eps_weighting(sigma)

    def __call__(self, network: Callable, x, sigma, cond, *, input_ref=None,
                 sigmas_ref=None, noise_ref=None, **kwargs):
        """network(x_scaled, c_noise, cond, **kw) -> (pred, aux); returns
        (denoised, aux). x: (B, H, W, C); sigma: (B,). Training: input_ref
        (B, N, H, W, C) with sigmas_ref (B,), plus ``noise_ref`` (standard
        normal draws of input_ref's shape) for the second noising; the
        network then gets input_ref and sigmas_ref (as grid indices)."""
        if input_ref is not None:
            if sigmas_ref is not None:
                sr = _append_dims(sigmas_ref, input_ref.dim())
                if noise_ref is not None:
                    input_ref = input_ref + noise_ref * sr
                input_ref = input_ref * eps_scaling(sr)[2]
                sigmas_ref = self.sigma_to_idx(sigmas_ref).float()
            kwargs.update(input_ref=input_ref, sigmas_ref=sigmas_ref)
        sigma = self.quantize_sigma(sigma)
        c_skip, c_out, c_in, _ = eps_scaling(_append_dims(sigma, x.dim()))
        c_noise = self.sigma_to_idx(sigma).float()
        pred, aux = network(x * c_in, c_noise, cond, **kwargs)
        return pred * c_out + x * c_skip, aux
