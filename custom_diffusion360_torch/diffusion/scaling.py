"""EDM preconditioning scalings sigma -> (c_skip, c_out, c_in, c_noise) and
the training loss weightings (port of custom_diffusion360_tpu/diffusion/
scaling.py), looked up by name with ``get_scaling`` / ``get_weighting``."""
from __future__ import annotations

import torch


def eps_scaling(sigma):
    c_skip = torch.ones_like(sigma)
    c_out = -sigma
    c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
    c_noise = sigma
    return c_skip, c_out, c_in, c_noise


def edm_scaling(sigma, sigma_data: float = 0.5):
    c_skip = sigma_data**2 / (sigma**2 + sigma_data**2)
    c_out = sigma * sigma_data / torch.sqrt(sigma**2 + sigma_data**2)
    c_in = 1.0 / torch.sqrt(sigma**2 + sigma_data**2)
    c_noise = 0.25 * torch.log(sigma)
    return c_skip, c_out, c_in, c_noise


def v_scaling(sigma):
    c_skip = 1.0 / (sigma**2 + 1.0)
    c_out = -sigma / torch.sqrt(sigma**2 + 1.0)
    c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
    c_noise = sigma
    return c_skip, c_out, c_in, c_noise


def v_edm_noise_scaling(sigma):
    """v's c_skip, c_out and c_in with EDM's c_noise = ln(sigma) / 4 (sgm
    VScalingWithEDMNoise, Stable Video Diffusion's denoiser)."""
    c_skip, c_out, c_in, _ = v_scaling(sigma)
    return c_skip, c_out, c_in, 0.25 * torch.log(sigma)


def unit_weighting(sigma):
    return torch.ones_like(sigma)


def edm_weighting(sigma, sigma_data: float = 0.5):
    return (sigma**2 + sigma_data**2) / (sigma * sigma_data) ** 2


def v_weighting(sigma):
    return edm_weighting(sigma, sigma_data=1.0)


def eps_weighting(sigma):
    # sigma^-2 correctly rounded (as XLA's power gives it; 1 / (s * s) in
    # float32 rounds twice)
    return (sigma.double() ** -2.0).to(sigma.dtype)


_SCALINGS = {
    "eps": eps_scaling, "EpsScaling": eps_scaling,
    "edm": edm_scaling, "EDMScaling": edm_scaling,
    "v": v_scaling, "VScaling": v_scaling,
    "v_edm_noise": v_edm_noise_scaling, "VScalingWithEDMNoise": v_edm_noise_scaling,
}

_WEIGHTINGS = {
    "unit": unit_weighting, "UnitWeighting": unit_weighting,
    "edm": edm_weighting, "EDMWeighting": edm_weighting,
    "v": v_weighting, "VWeighting": v_weighting,
    "eps": eps_weighting, "EpsWeighting": eps_weighting,
}


# scalings whose c_noise the network receives (sgm's Denoiser hands c_noise
# on); the others hand it sigma, as the JAX package does
NETWORK_GETS_C_NOISE = frozenset({"v_edm_noise", "VScalingWithEDMNoise"})


def get_scaling(kind: str):
    return _SCALINGS[kind]


def get_weighting(kind: str):
    return _WEIGHTINGS[kind]
