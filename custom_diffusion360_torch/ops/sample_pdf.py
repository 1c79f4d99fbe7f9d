"""Inverse-CDF importance sampling of ray depths (port of
custom_diffusion360_tpu/ops/sample_pdf.py)."""
from __future__ import annotations

import torch


def sample_pdf(bins, weights, u, eps: float = 1e-5):
    """Draw samples from the piecewise-constant pdf defined by ``weights``.

    bins: (..., S+1) increasing edges; weights: (..., S) non-negative masses;
    u: (..., K) uniforms in [0, 1). Returns (..., K): the CDF is inverted
    with linear interpolation inside the selected bin, 'left' searchsorted
    semantics (index = count of cdf < u), denominators below eps replaced
    by 1 (pytorch3d sample_pdf semantics).
    """
    weights = weights + eps
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # (..., S+1)

    s = weights.shape[-1]
    inds = (cdf[..., None, :] < u[..., :, None]).sum(-1)
    below = (inds - 1).clamp(0, s - 1)
    above = inds.clamp(0, s)

    cdf_b = torch.gather(cdf, -1, below)
    cdf_a = torch.gather(cdf, -1, above)
    bins_b = torch.gather(bins, -1, below)
    bins_a = torch.gather(bins, -1, above)

    denom = cdf_a - cdf_b
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    t = ((u - cdf_b) / denom).clamp(0.0, 1.0)
    return bins_b + t * (bins_a - bins_b)
