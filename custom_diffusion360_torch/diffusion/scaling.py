"""EDM preconditioning scaling sigma -> (c_skip, c_out, c_in, c_noise)
and the training loss weighting (port of ``eps_scaling`` and
``eps_weighting`` from custom_diffusion360_tpu/diffusion/scaling.py, the
ones SDXL uses; the EDM and v variants are not ported yet)."""
from __future__ import annotations

import torch


def eps_scaling(sigma):
    c_skip = torch.ones_like(sigma)
    c_out = -sigma
    c_in = 1.0 / torch.sqrt(sigma**2 + 1.0)
    c_noise = sigma
    return c_skip, c_out, c_in, c_noise


def eps_weighting(sigma):
    return sigma**-2.0
