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

View-sharded capture (``view_group``, a process group whose size divides
N + 1): each rank encodes and runs only its own run of the N + 1 views
(the zero image is the last view) and the buffers are all-gathered back
in view order. Every rank draws the full-size draws and keeps its views',
so the result is the single-process capture. The reference stream
handles each view on its own (per-sample norms, attention within a view,
the view's own text row), and the returned tokens are that stream's; the
target stream's pose blocks read every view, but their output is not
returned, so nothing is gathered before the end.
"""
from __future__ import annotations

import torch

from ..diffusion.sigma_sampling import sample_sigmas_discrete


@torch.no_grad()
def capture_references(engine, params, images_ref, cams, cond, draws, *, mask_ref=None,
                       timestep: float = 500.0, view_group=None):
    """images_ref (N, H, W, 3) capture images in [-1, 1]; cams: Cameras (1,
    N+2), the target camera first, then one per capture image and one for
    the zero image; cond: the conditioner's output over 1 + N + 1 rows;
    mask_ref (1, N+1, Hm, Wm) or None; view_group: shard the N + 1 views
    over this process group (its size must divide N + 1).
    Returns {attn_id: {d: (N+1, hw, C)}} in the compute dtype."""
    dev = engine.device
    images_ref = images_ref.to(dev)
    imgs = torch.cat([images_ref, torch.zeros_like(images_ref[:1])], dim=0)
    views = imgs.shape[0]
    lo, hi = 0, views
    if view_group is not None:
        from ..parallel.mesh import rank, world_size

        n = world_size(view_group)
        if views % n:
            raise ValueError(f"{views} capture views do not split over {n} ranks")
        lo = rank(view_group) * (views // n)
        hi = lo + views // n
    # the full-size draws, of which this rank keeps its views' rows
    eps = draws.normal("vae_eps", engine.latent_shape(imgs.shape), dev)[lo:hi]
    sigmas_ref = sample_sigmas_discrete(draws, "sigma_ref_idx", engine.sigmas_discrete, 1)
    zshape = (1, views) + tuple(eps.shape[1:])
    noise_ref = draws.normal("noise_ref", zshape, dev)[:, lo:hi]
    noise_ref2 = draws.normal("noise_ref2", zshape, dev)[:, lo:hi]
    zr = engine.encode_first_stage(params, imgs[lo:hi], eps)[None]  # (1, views, h, w, 4)
    zr = zr + noise_ref * sigmas_ref.reshape(1, 1, 1, 1, 1)
    cams = cams.to(dev)
    if view_group is not None:  # the target camera, then this rank's views'
        cams = type(cams)(*(torch.cat([f[:, :1], f[:, 1 + lo:1 + hi]], dim=1) for f in cams))
        cond = {k: torch.cat([v[:1], v[1 + lo:1 + hi]]) for k, v in cond.items()}
        if mask_ref is not None:
            mask_ref = mask_ref[:, lo:hi]
    network = engine.network_fn(params, cams, None if mask_ref is None else mask_ref.to(dev))
    x = torch.zeros((1,) + tuple(zr.shape[2:4]) + (engine.cfg.unet.in_channels,), device=dev)
    sigma = torch.full((1,), float(timestep), device=dev)
    _, aux = engine.denoiser(network, x, sigma, cond, input_ref=zr, sigmas_ref=sigmas_ref,
                             noise_ref=noise_ref2)
    out = {attn_id: {d: t[0] for d, t in per_d.items()}
           for attn_id, per_d in aux["ref_tokens"].items()}
    if view_group is not None:
        from ..parallel.mesh import all_gather_rows

        out = {attn_id: {d: all_gather_rows(t, view_group) for d, t in per_d.items()}
               for attn_id, per_d in out.items()}
    return out
