"""EDM-preconditioned denoiser (port of custom_diffusion360_tpu/diffusion/
denoiser.py):

    D(x, sigma) = network(x * c_in, c_noise, cond) * c_out + x * c_skip

with (c_skip, c_out, c_in) from the configured scaling ("eps", "edm" or
"v"). The discrete denoiser (``discrete=True``, SDXL's) quantizes sigma to
the nearest entry of a ``num_idx``-step LegacyDDPM grid and, with
``quantize_c_noise``, hands the network the grid index (first index on
ties, as jnp.argmin); otherwise the network gets sigma itself, as in the
JAX package, or, for the scalings in ``NETWORK_GETS_C_NOISE``, the
scaling's c_noise, as sgm's Denoiser hands it (Stable Video Diffusion's
``VScalingWithEDMNoise``: 0.25 ln sigma). The reference
latents, when given with ``sigmas_ref``, are c_in-scaled here by the same
scaling, with their sigmas quantized the same way; in training they are
first noised a second time with ``noise_ref`` (on top of the loss's
noising: the reference implementation's double noising, kept for parity).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .discretization import legacy_ddpm_sigmas
from .scaling import NETWORK_GETS_C_NOISE, get_scaling, get_weighting

NUM_IDX = 1000


@dataclasses.dataclass(frozen=True)
class DenoiserConfig:
    scaling: str = "eps"
    weighting: str = "eps"
    discrete: bool = True
    num_idx: int = NUM_IDX
    quantize_c_noise: bool = True


def _append_dims(x, ndim):
    return x.reshape(tuple(x.shape) + (1,) * (ndim - x.dim()))


class Denoiser:
    def __init__(self, cfg: DenoiserConfig = DenoiserConfig(), device="cpu"):
        self.cfg = cfg
        self.scaling = get_scaling(cfg.scaling)
        self.weighting = get_weighting(cfg.weighting)
        self.network_gets_c_noise = cfg.scaling in NETWORK_GETS_C_NOISE
        # ascending grid without zero
        self.sigmas = (legacy_ddpm_sigmas(cfg.num_idx, device=device, append_zero=False,
                                          flip=True) if cfg.discrete else None)

    def sigma_to_idx(self, sigma):
        # torch.argmin returns the first minimal index, like jnp.argmin
        return torch.argmin((sigma[..., None] - self.sigmas.to(sigma.device)).abs(), dim=-1)

    def quantize_sigma(self, sigma):
        if self.sigmas is None:
            return sigma
        return self.sigmas.to(sigma.device)[self.sigma_to_idx(sigma)]

    def quantize_c_noise(self, c_noise):
        if self.sigmas is None or not self.cfg.quantize_c_noise:
            return c_noise
        return self.sigma_to_idx(c_noise).float()

    def w(self, sigma):
        """The training loss weight of the configured weighting."""
        return self.weighting(sigma)

    def __call__(self, network: Callable, x, sigma, cond, *, input_ref=None,
                 sigmas_ref=None, noise_ref=None, **kwargs):
        """network(x_scaled, c_noise, cond, **kw) -> (pred, aux); returns
        (denoised, aux). x: (B, H, W, C); sigma: (B,). input_ref (B, N, H,
        W, C) reference latents with sigmas_ref (B,), plus in training
        ``noise_ref`` (standard normal draws of input_ref's shape) for the
        second noising; the network then gets input_ref and sigmas_ref (as
        grid indices when quantized)."""
        if input_ref is not None:
            if sigmas_ref is not None:
                sr = _append_dims(sigmas_ref, input_ref.dim())
                if noise_ref is not None:
                    input_ref = input_ref + noise_ref * sr
                input_ref = input_ref * self.scaling(sr)[2]
                sigmas_ref = self.quantize_c_noise(sigmas_ref)
            kwargs.update(input_ref=input_ref, sigmas_ref=sigmas_ref)
        sigma = self.quantize_sigma(sigma)
        c_skip, c_out, c_in, c_noise = self.scaling(_append_dims(sigma, x.dim()))
        c_noise = c_noise.reshape(sigma.shape) if self.network_gets_c_noise else sigma
        pred, aux = network(x * c_in, self.quantize_c_noise(c_noise), cond, **kwargs)
        return pred * c_out + x * c_skip, aux
