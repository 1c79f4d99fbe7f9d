"""Sampling engine (port of the inference half of custom_diffusion360_tpu/
engine.py): UNet + denoiser + guider + Euler-EDM + VAE decode.

``Engine.sample`` renders the FeatureNeRF pose blocks once, at step 0, and
feeds the rendered features to the remaining steps as ``nerf_caches`` (exact
at eval: the rays are deterministic), with the text cross-attention K/V
hoisted out of the loop. Randomness enters only as the ``noise`` tensor.
Training, the conditioner (text encoders) and the other samplers and
guiders are not ported yet: ``cond``/``uc`` come in as tensors of the
conditioner's output shapes, crossattn (B, 77, 2048) and vector (B, 2816).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from . import resolve_device
from .diffusion.denoiser import Denoiser
from .diffusion.discretization import legacy_ddpm_sigmas
from .diffusion.sampling import euler_edm_sample, to_d
from .geometry.cameras import Cameras
from .models.nerf import CompactRefTokens
from .models.nn import torch_dtype
from .models.transformer import fuse_attention_params
from .models.unet import UNetConfig, init_unet_params, precompute_context_kv, unet_apply
from .models.vae import VAEConfig, decode_first_stage, init_vae_params


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    num_sample_steps: int = 50
    compute_dtype: str = "float32"

    @property
    def dtype(self):
        return torch_dtype(self.compute_dtype)


class Engine:
    def __init__(self, cfg: EngineConfig = EngineConfig(), device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.denoiser = Denoiser(device=self.device)

    def init_params(self, seed: int = 0, dtype=None):
        """Seeded random {"unet", "vae"} parameters on the engine's device
        (in the compute dtype unless ``dtype`` is given)."""
        dtype = self.cfg.dtype if dtype is None else dtype
        return {
            "unet": init_unet_params(self.cfg.unet, seed, self.device, dtype),
            "vae": init_vae_params(self.cfg.vae, seed + 1, self.device, dtype),
        }

    @torch.inference_mode()
    def decode_first_stage(self, params, z):
        return decode_first_stage(params["vae"], z, self.cfg.vae)

    def network_fn(self, params, cams: Optional[Cameras], *, nerf_caches=None,
                   ref_features=None, ctx_kv=None):
        """network(x, t, cond) -> (eps, aux), the callable the Denoiser wraps."""

        def network(x, t, cond):
            return unet_apply(
                params["unet"], self.cfg.unet, x, t, cond["crossattn"], cond["vector"],
                cams=cams, nerf_caches=nerf_caches, ref_features=ref_features,
                ctx_kv=ctx_kv, compute_dtype=self.cfg.dtype,
            )

        return network

    def build_ref_features(self, references, choices, batch_size, num_copies):
        """Per-block reference tokens from delta-checkpoint buffers
        references {attn_id: {d: (Nref+1, hw, C)}} (last row = zero-image
        feature) and the chosen rows ``choices`` (n,), as CompactRefTokens
        whose num_copies CFG copies are laid out 2 -> [zero | chosen]."""
        idx = torch.as_tensor(choices, dtype=torch.long)
        return {
            attn_id: {
                d: CompactRefTokens(buf[-1], buf[:-1][idx.to(buf.device)], batch_size,
                                    num_copies)
                for d, buf in per_d.items()
            }
            for attn_id, per_d in references.items()
        }

    @torch.inference_mode()
    def sample(self, params, cond, uc, guider, *, noise, cams: Optional[Cameras] = None,
               references=None, choices=None, num_steps: Optional[int] = None,
               callback: Optional[Callable[[int], None]] = None):
        """Pose-conditioned sampling -> latents (B, h, w, 4) f32.

        noise: (B, h, w, 4) standard normal draws (the initial latent before
        the sqrt(1 + sigma_0^2) scaling). cams: Cameras of batch
        (num_copies * B, 1 + Nref), camera 0 the target. references/choices:
        delta-buffer reference features and the chosen rows.
        ``callback(i)`` runs after sampler step i (step 0 renders).
        """
        cfg = self.cfg
        n_steps = num_steps or cfg.num_sample_steps
        sigmas = legacy_ddpm_sigmas(n_steps)  # host f32
        x = noise.to(self.device, torch.float32) * torch.sqrt(1.0 + sigmas[0] ** 2)
        b = x.shape[0]
        if cams is not None:
            cams = cams.to(self.device)

        # inference-only q/k/v projection fusion, once per call
        params = dict(params, unet=fuse_attention_params(params["unet"]))
        ref_features = None
        if references is not None:
            ref_features = self.build_ref_features(references, choices, b, guider.num_copies)

        def make_denoise(nerf_caches, collect_rendered):
            ctx_kv = None
            if nerf_caches is not None:
                # cached phase: hoist the text K/V projections out of the loop
                sig0 = torch.zeros((b,), device=self.device)
                _, _, cb = guider.prepare(x, sig0, cond, uc)
                ctx = cb["crossattn"][: b * guider.num_copies]
                ctx_kv = precompute_context_kv(params["unet"], cfg.unet, ctx.to(cfg.dtype))
            network = self.network_fn(
                params, cams, nerf_caches=nerf_caches,
                ref_features=None if nerf_caches is not None else ref_features,
                ctx_kv=ctx_kv,
            )

            def denoise(xi, sigma_vec):
                xb, sb, cb = guider.prepare(xi, sigma_vec, cond, uc)
                denoised, aux = self.denoiser(network, xb, sb, cb)
                if collect_rendered:
                    return guider.combine(denoised, sigma_vec), aux["rendered"]
                return guider.combine(denoised, sigma_vec)

            return denoise

        if ref_features:
            s0 = torch.full((b,), float(sigmas[0]), dtype=torch.float32, device=self.device)
            denoised, rendered = make_denoise(None, True)(x, s0)
            x = x + (sigmas[1] - sigmas[0]) * to_d(x, s0, denoised)
            del denoised
            if callback is not None:
                callback(0)
            denoise_rest = make_denoise(rendered or None, False)
            step_cb = None if callback is None else (lambda i: callback(i + 1))
            return euler_edm_sample(denoise_rest, x, sigmas[1:], scale_init=False,
                                    callback=step_cb)
        return euler_edm_sample(make_denoise(None, False), x, sigmas, scale_init=False,
                                callback=callback)
