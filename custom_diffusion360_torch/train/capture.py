"""Reference-feature capture, the bridge from training to sampling (port
of custom_diffusion360_tpu/train/capture.py).

One dual-stream UNet forward whose reference views are all the capture
images plus an appended zero image (the uncond row); each pose block's
reference-stream tokens are the buffers the delta checkpoint ships. As in
training, the reference latents are noised with one DiscreteSampling sigma
and noised and c_in-scaled again by the denoiser (the reference's double
noising). The renders run in eval mode (no draws).

Draws (``draws.Draws``; the JAX package's four key splits):
  vae_eps (N+1, h, w, 4)       the VAE posterior's draws
  sigma_ref_idx (1,)           the reference sigma's grid index (of 50)
  noise_ref (1, N+1, h, w, 4)  the first noising
  noise_ref2 (1, N+1, h, w, 4) the denoiser's second noising
"""
from __future__ import annotations

import torch

from ..diffusion.sigma_sampling import sample_sigmas_discrete


@torch.no_grad()
def capture_references(engine, params, images_ref, cams, cond, draws, *, mask_ref=None,
                       timestep: float = 500.0):
    """images_ref (N, H, W, 3) capture images in [-1, 1]; cams: Cameras (1,
    N+2), the target camera first, then one per capture image and one for
    the zero image; cond: the conditioner's output over 1 + N + 1 rows.
    Returns {attn_id: {d: (N+1, hw, C)}} in the compute dtype."""
    dev = engine.device
    images_ref = images_ref.to(dev)
    imgs = torch.cat([images_ref, torch.zeros_like(images_ref[:1])], dim=0)
    zr = engine.encode_first_stage(
        params, imgs, draws.normal("vae_eps", engine.latent_shape(imgs.shape), dev))
    zr = zr[None]  # (1, N+1, h, w, 4)
    sigmas_ref = sample_sigmas_discrete(draws, "sigma_ref_idx", engine.sigmas_discrete, 1)
    zr = zr + draws.normal("noise_ref", zr.shape, dev) * sigmas_ref.reshape(1, 1, 1, 1, 1)
    network = engine.network_fn(params, cams.to(dev),
                                None if mask_ref is None else mask_ref.to(dev))
    x = torch.zeros((1,) + tuple(zr.shape[2:4]) + (engine.cfg.unet.in_channels,), device=dev)
    sigma = torch.full((1,), float(timestep), device=dev)
    _, aux = engine.denoiser(network, x, sigma, cond, input_ref=zr, sigmas_ref=sigmas_ref,
                             noise_ref=draws.normal("noise_ref2", zr.shape, dev))
    return {attn_id: {d: t[0] for d, t in per_d.items()}
            for attn_id, per_d in aux["ref_tokens"].items()}
