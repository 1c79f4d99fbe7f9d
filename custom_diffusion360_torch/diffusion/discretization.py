"""Sigma schedules (port of custom_diffusion360_tpu/diffusion/
discretization.py). Computed host-side in float64 numpy and cast to float32
at the end, highest sigma first for sampling."""
from __future__ import annotations

import numpy as np
import torch


def _equally_spaced_steps(num_substeps: int, max_step: int) -> np.ndarray:
    return np.linspace(max_step - 1, 0, num_substeps, endpoint=False).astype(int)[::-1]


def legacy_ddpm_sigmas_np(n: int, *, num_timesteps: int = 1000,
                          linear_start: float = 0.00085, linear_end: float = 0.0120,
                          append_zero: bool = True, flip: bool = False) -> np.ndarray:
    """LegacyDDPM linear-beta schedule -> float32 sigma grid, descending
    (with a trailing 0 when ``append_zero``); ``flip`` reverses it."""
    betas = np.linspace(linear_start**0.5, linear_end**0.5, num_timesteps,
                        dtype=np.float64) ** 2
    alphas_cumprod = np.cumprod(1.0 - betas)
    if n < num_timesteps:
        alphas_cumprod = alphas_cumprod[_equally_spaced_steps(n, num_timesteps)]
    elif n != num_timesteps:
        raise ValueError(f"n={n} > num_timesteps={num_timesteps}")
    sigmas = ((1 - alphas_cumprod) / alphas_cumprod) ** 0.5
    sigmas = sigmas[::-1].astype(np.float32)
    if append_zero:
        sigmas = np.concatenate([sigmas, np.zeros((1,), np.float32)])
    if flip:
        sigmas = sigmas[::-1]
    return sigmas.copy()


def legacy_ddpm_sigmas(n: int, device="cpu", **kwargs) -> torch.Tensor:
    return torch.from_numpy(legacy_ddpm_sigmas_np(n, **kwargs)).to(device)

