"""Training-time noise-level samplers (port of custom_diffusion360_tpu/
diffusion/sigma_sampling.py). ``sigmas`` is the ascending training grid
(legacy_ddpm_sigmas(..., append_zero=False, flip=True)); the grid index
(for EDM, the normal draw) is a named draw (draws.Draws), so a test can
hand both packages the same numbers."""
from __future__ import annotations

import torch


def sample_sigmas_discrete(draws, name, sigmas, n: int):
    """Uniform grid index (DiscreteSampling)."""
    idx = draws.take(name, (n,), sigmas.device,
                     lambda s, g, d: torch.randint(0, sigmas.shape[0], s, generator=g, device=d))
    return sigmas[idx.long()]


def sample_sigmas_cubic(draws, name, sigmas, n: int):
    """Index (1 - u^3) * (num_idx - 1), biased to high sigma (CubicSampling;
    the grid is ascending)."""
    num_idx = sigmas.shape[0]

    def make(shape, gen, device):
        u = torch.rand(shape, generator=gen, device=device)
        return ((1.0 - u * u * u) * (num_idx - 1)).long()

    return sigmas[draws.take(name, (n,), sigmas.device, make).long()]


def sample_sigmas_edm(draws, name, n: int, device, p_mean: float = -1.2,
                      p_std: float = 1.2):
    """Log-normal sigma (EDMSampling): exp(p_mean + p_std * z), z the
    standard normal draw ``name`` (n,)."""
    return torch.exp(p_mean + p_std * draws.normal(name, (n,), device))
