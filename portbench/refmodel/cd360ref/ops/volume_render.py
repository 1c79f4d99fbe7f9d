"""Volume rendering: alpha compositing with exclusive-cumsum transmittance
(port of custom_diffusion360_tpu/ops/volume_render.py)."""
from __future__ import annotations

import torch


def render_weights(densities, deltas):
    """densities, deltas: (..., S, 1) -> (weights, alphas, transmittance),
    each (..., S, 1); transmittance uses an exclusive cumsum of
    delta * density, weights go through nan_to_num."""
    delta_density = deltas * densities
    alphas = 1.0 - torch.exp(-delta_density)
    accum = torch.cumsum(delta_density, dim=-2)
    exclusive = accum - delta_density
    transmittance = torch.exp(-exclusive)
    weights = torch.nan_to_num(alphas * transmittance)
    return weights, alphas, transmittance


def volume_render(features, densities, dists, rgb=None,
                  densities_uniform=None, dists_uniform=None):
    """Composite per-sample features (and optional rgb) along the ray.

    features: (..., S, C); densities/dists: (..., S, 1). Returns dict(feats,
    fg_mask, alphas, weights, weights_uniform, rgb).
    """
    weights, alphas, _ = render_weights(densities, dists)
    fg_mask = weights.sum(-2)
    feats = (weights * features).sum(-2)
    rgb_out = (weights * rgb).sum(-2) if rgb is not None else None
    weights_uniform = None
    if densities_uniform is not None:
        weights_uniform, _, _ = render_weights(densities_uniform, dists_uniform)
    return dict(feats=feats, fg_mask=fg_mask, alphas=alphas, weights=weights,
                weights_uniform=weights_uniform, rgb=rgb_out)
