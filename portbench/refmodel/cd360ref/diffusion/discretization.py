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


def edm_sigmas_np(n: int, *, sigma_min: float = 0.002, sigma_max: float = 80.0,
                  rho: float = 7.0, append_zero: bool = True, flip: bool = False) -> np.ndarray:
    """Karras rho-schedule -> float32 sigma grid, descending (with a
    trailing 0 when ``append_zero``); ``flip`` reverses it."""
    ramp = np.linspace(0, 1, n, dtype=np.float64)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    sigmas = ((max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho).astype(np.float32)
    if append_zero:
        sigmas = np.concatenate([sigmas, np.zeros((1,), np.float32)])
    if flip:
        sigmas = sigmas[::-1]
    return sigmas.copy()


def edm_sigmas(n: int, device="cpu", **kwargs) -> torch.Tensor:
    return torch.from_numpy(edm_sigmas_np(n, **kwargs)).to(device)


def make_sigmas(kind: str, n: int, device="cpu", **kwargs) -> torch.Tensor:
    """The schedule by name: "legacy_ddpm" (or "LegacyDDPMDiscretization")
    or "edm" (or "EDMDiscretization")."""
    if kind in ("legacy_ddpm", "LegacyDDPMDiscretization"):
        return legacy_ddpm_sigmas(n, device, **kwargs)
    if kind in ("edm", "EDMDiscretization"):
        return edm_sigmas(n, device, **kwargs)
    raise ValueError(f"unknown discretization {kind!r}")

