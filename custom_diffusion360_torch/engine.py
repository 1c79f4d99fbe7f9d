"""Diffusion engine (port of custom_diffusion360_tpu/engine.py): UNet +
denoiser + conditioner + VAE, composed into the training loss and the
sampler.

``Engine.training_loss`` is one training forward: VAE-encode the target
and reference images (frozen, no gradient), run the text conditioner with
the reference rows after the target rows, noise, denoise through the
dual-stream UNet and return the lambda-weighted loss with its terms. Its
random draws come from a ``draws.Draws``.

``Engine.sample`` runs any of the six samplers (``diffusion/sampling.py``
SAMPLERS) on the configured sigma schedule. It renders the FeatureNeRF pose
blocks once, at step 0, and feeds the rendered features to the remaining
steps as ``nerf_caches`` (exact at eval: the rays are deterministic), with
the text cross-attention K/V hoisted out of the loop; on the card those
cached evaluations replay CUDA graphs (``models/unet_graphs.py``), which
the Engine owns with their memory. The reference
features come from delta-checkpoint buffers or from live reference latents
(the path of ``log_images``). Randomness enters as the ``noise`` tensor and,
for the samplers that draw every step, a ``draws.Draws``; ``cond``/``uc``
are the conditioner's outputs (crossattn (B, 77, 2048), vector (B, 2816);
``get_unconditional_conditioning``). Under the x3 guider two dedupes apply
(see ``sample``). A video network (``VideoUNetConfig``, Stable Video
Diffusion) samples clips through the same ``sample``: no pose blocks, the
conditioning's "concat" latents joined to the network's input channels,
``num_frames`` frames a clip, under the general conditioner's video stack
(``models/general_conditioner.py``). ``samplemulti`` is MultiDiffusion
over several poses; ``log_images`` makes the training CLI's preview grids.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Optional

import torch

from . import resolve_device
from .diffusion.denoiser import Denoiser, DenoiserConfig
from .diffusion.discretization import legacy_ddpm_sigmas, make_sigmas
from .diffusion.guiders import _COND_KEYS, vanilla_cfg_img_ref
from .diffusion.loss import DiffusionLossConfig, combine_losses, diffusion_loss_img_ref
from .diffusion.sampling import (
    SAMPLERS,
    SamplerConfig,
    euler_edm_sample,
    multidiffusion_sample,
    step_noise,
    to_d,
)
from .geometry.cameras import Cameras
from .models.conditioner import ConditionerConfig, apply_conditioner, init_conditioner_params
from .models.general_conditioner import VideoConditionerConfig, init_video_conditioner_params
from .models.nerf import CompactRefTokens, view_sharded
from .models.nn import torch_dtype
from .models.transformer import fuse_attention_params
from .models.unet import UNetConfig, init_unet_params, precompute_context_kv, unet_apply
from .models.unet_graphs import CachedUNetGraphs
from .models.vae import VAEConfig, decode_first_stage, encode_first_stage, init_vae_params
from .utils.trace import span, spanned


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    unet: UNetConfig = UNetConfig()
    vae: VAEConfig = VAEConfig()
    conditioner: ConditionerConfig = ConditionerConfig()
    denoiser: DenoiserConfig = DenoiserConfig()
    loss: DiffusionLossConfig = DiffusionLossConfig()
    sampler: SamplerConfig = SamplerConfig()
    sampler_name: str = "euler_edm"  # a key of diffusion.sampling.SAMPLERS
    discretization_name: str = "legacy_ddpm"  # or "edm" (make_sigmas)
    sigma_max: Optional[float] = None  # the EDM schedule's, where not its default 80
    num_sample_steps: int = 50
    compute_dtype: str = "float32"

    @property
    def dtype(self):
        return torch_dtype(self.compute_dtype)


class Engine:
    def __init__(self, cfg: EngineConfig = EngineConfig(), device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.denoiser = Denoiser(cfg.denoiser, device=self.device)
        # the cached sampler steps' graphs and the fused q/k/v leaves they read
        self.graphs = CachedUNetGraphs()
        # ascending training sigma grids of the target and the references
        self.sigmas_cubic = legacy_ddpm_sigmas(cfg.loss.num_idx, self.device,
                                               append_zero=False, flip=True)
        self.sigmas_discrete = legacy_ddpm_sigmas(cfg.loss.num_idx_ref, self.device,
                                                  append_zero=False, flip=True)
        # the LPIPS weights of loss_type="lpips", read once
        self.lpips_params = None
        if cfg.loss.loss_type == "lpips" and cfg.loss.lpips_ckpt:
            from .models.lpips import load_lpips_torch

            self.lpips_params = load_lpips_torch(cfg.loss.lpips_ckpt, cfg.loss.vgg_ckpt,
                                                 device=self.device)

    def init_params(self, seed: int = 0, dtype=None):
        """Seeded random {"unet", "vae", "conditioner"} parameters on the
        engine's device (in the compute dtype unless ``dtype`` is given)."""
        dtype = self.cfg.dtype if dtype is None else dtype
        init_cond = (init_video_conditioner_params
                     if isinstance(self.cfg.conditioner, VideoConditionerConfig)
                     else init_conditioner_params)
        return {
            "unet": init_unet_params(self.cfg.unet, seed, self.device, dtype),
            "vae": init_vae_params(self.cfg.vae, seed + 1, self.device, dtype),
            "conditioner": init_cond(self.cfg.conditioner, seed + 2, self.device, dtype),
        }

    def sigmas(self, n: int):
        """The configured sampling schedule of ``n`` steps (host f32)."""
        kw = {} if self.cfg.sigma_max is None else {"sigma_max": self.cfg.sigma_max}
        return make_sigmas(self.cfg.discretization_name, n, **kw)

    @torch.inference_mode()
    @spanned("cd360.decode")
    def decode_first_stage(self, params, z):
        return decode_first_stage(params["vae"], z, self.cfg.vae)

    def encode_first_stage(self, params, x, eps=None):
        """Images (B, H, W, 3) in [-1, 1] -> scaled f32 latents, the VAE in
        the compute dtype, without gradient; eps: the posterior's draws."""
        z = encode_first_stage(params["vae"], x.to(self.device, self.cfg.dtype), self.cfg.vae,
                               eps=eps)
        return z.float()

    def latent_shape(self, images_shape):
        f = 2 ** (len(self.cfg.vae.ch_mult) - 1)
        n, h, w = images_shape[:3]
        return (n, h // f, w // f, self.cfg.vae.z_channels)

    def network_fn(self, params, cams: Optional[Cameras], mask_ref=None, *, nerf_caches=None,
                   ref_features=None, ctx_kv=None, draws=None, prefix_dedupe=None,
                   num_frames: Optional[int] = None):
        """network(x, t, cond, input_ref=, sigmas_ref=) -> (eps, aux), the
        callable the Denoiser wraps; ``draws`` makes the renders stochastic
        (training). A "concat" entry of ``cond`` joins x's channels (sgm's
        OpenAIWrapper); ``num_frames``: a video network's frames a clip."""

        def network(x, t, cond, input_ref=None, sigmas_ref=None):
            if "concat" in cond:
                x = torch.cat([x, cond["concat"].to(x.dtype)], dim=-1)
            return unet_apply(
                params["unet"], self.cfg.unet, x, t, cond["crossattn"], cond["vector"],
                cams=cams, nerf_caches=nerf_caches, ref_features=ref_features,
                ctx_kv=ctx_kv, compute_dtype=self.cfg.dtype, input_ref=input_ref,
                sigmas_ref=sigmas_ref, mask_ref=mask_ref, draws=draws,
                prefix_dedupe=prefix_dedupe, num_video_frames=num_frames,
            )

        return network

    def training_loss(self, params, batch, global_step: int, draws, data_group=None):
        """One training forward -> (scalar loss, metrics).

        batch: image (B, H, W, 3) in [-1, 1]; image_ref (B, N, H, W, 3); mask
        (B, h, w, 1) latent-res; mask_ref (B, N, Hi, Wi, 1) or None; opacity
        (B, Hi, Wi, 1); drop_im (B,); cams: Cameras (B, 1 + N); token ids
        tokens_clip / tokens_open (B, T) and their ``_ref`` rows (B * N, T);
        size tuples original_size, crop_coords, target_size (B, 2) and
        their ``_ref`` rows. draws: a ``draws.Draws`` for vae_eps,
        vae_eps_ref, the loss's draws and the renders' (``nerf/...``).
        data_group: this batch is one rank's rows of a global batch split
        over the group; the fg / bg / rgb terms are then divided by the mean
        of the ranks' counts of items that kept their references, so the
        mean of the ranks' losses is the global batch's loss.
        """
        x_rgb = batch["image"].to(self.device)
        x = self.encode_first_stage(
            params, x_rgb, draws.normal("vae_eps", self.latent_shape(x_rgb.shape), self.device))
        input_ref = None
        if batch.get("image_ref") is not None:
            ir = batch["image_ref"].to(self.device)
            b, n = ir.shape[:2]
            ir = ir.reshape((b * n,) + tuple(ir.shape[2:]))
            zr = self.encode_first_stage(
                params, ir, draws.normal("vae_eps_ref", self.latent_shape(ir.shape), self.device))
            zr = zr.reshape((b, n) + tuple(zr.shape[1:]))
            # reg-image dropout zeroes the reference latents
            input_ref = batch["drop_im"].to(self.device).float().reshape(b, 1, 1, 1, 1) * zr

        cond = apply_conditioner(params["conditioner"], batch, self.cfg.conditioner, ref=True)
        cams = batch.get("cams")
        mask_ref = batch.get("mask_ref")
        network = self.network_fn(
            params, None if cams is None else cams.to(self.device),
            None if mask_ref is None else mask_ref.to(self.device), draws=draws)
        mask = batch.get("mask")
        terms = diffusion_loss_img_ref(
            self.denoiser, network, cond, x, x_rgb, input_ref,
            None if mask is None else mask.to(self.device), batch["opacity"].to(self.device),
            draws=draws, sigmas_cubic=self.sigmas_cubic, sigmas_discrete=self.sigmas_discrete,
            cfg=self.cfg.loss, lpips_params=self.lpips_params,
        )
        drop = batch["drop_im"].to(self.device)
        kept = None
        if data_group is not None:
            from .parallel.mesh import all_reduce_mean

            kept = all_reduce_mean([drop.float().sum().reshape(1)], data_group)[0][0]
        return combine_losses(terms, drop, global_step, cfg=self.cfg.loss,
                              rgb_predict=self.cfg.unet.rgb_predict, kept=kept)

    def build_ref_features(self, references, choices, batch_size, num_copies,
                           shared_cams=False, compact=True, rows=None, views=None):
        """Per-block reference tokens from delta-checkpoint buffers
        references {attn_id: {d: (Nref+1, hw, C)}} (last row = zero-image
        feature) and the chosen rows ``choices`` (n,), their num_copies CFG
        copies laid out 2 -> [zero | chosen], 3 -> [zero | chosen | chosen].
        ``compact``: CompactRefTokens, whose expansion is deferred into the
        per-block projection (``shared_cams`` licenses the x3 render dedupe);
        else the dense (num_copies * B, n, hw, C) tensors that a per-row
        ``mask_ref`` needs. ``rows`` (lo, hi): only those expanded rows
        (``Engine.sample(cfg_group=)``); ``views`` (lo, hi): only those of
        the chosen views (``Engine.sample(view_group=)``)."""
        idx = torch.as_tensor(choices, dtype=torch.long)
        out = {}
        for attn_id, per_d in references.items():
            out[attn_id] = {}
            for d, buf in per_d.items():
                tok = CompactRefTokens(buf[-1], buf[:-1][idx.to(buf.device)], batch_size,
                                       num_copies, shared_cams=shared_cams, rows=rows,
                                       views=views)
                if not compact:
                    tok = tok.expand_rows(tok.zero[None].expand(tok.chosen.shape),
                                          tok.chosen).contiguous()
                out[attn_id][d] = tok
        return out

    @torch.inference_mode()
    @spanned("cd360.sample")
    def sample(self, params, cond, uc, guider, *, noise, cams: Optional[Cameras] = None,
               references=None, choices=None, input_ref=None, sigmas_ref=None, mask_ref=None,
               num_steps: Optional[int] = None, cache_nerf: bool = True,
               sampler: Optional[str] = None, draws=None,
               callback: Optional[Callable[[int], None]] = None,
               shared_target_cams: bool = False, cfg_group=None, view_group=None,
               num_frames: Optional[int] = None):
        """Pose-conditioned sampling -> latents (B, h, w, 4) f32.

        noise: (B, h, w, 4) standard normal draws (the initial latent before
        the sqrt(1 + sigma_0^2) scaling). cams: Cameras of batch
        (num_copies * B, 1 + Nref), camera 0 the target. The reference
        features come from delta buffers (``references`` and the chosen rows
        ``choices``) or from live reference latents: ``input_ref``
        (num_copies * B, Nref, h, w, 4) at the reference sigmas
        ``sigmas_ref`` (num_copies * B,), with the conditioner's reference
        rows after the target rows in ``cond``/``uc``. ``mask_ref``
        (num_copies * B, Nref, Hm, Wm) masks the reference tokens per row
        (delta buffers then expand densely).

        sampler: a SAMPLERS key overriding ``cfg.sampler_name``; the sigmas
        are ``make_sigmas(cfg.discretization_name, num_steps)``. ``draws``
        gives the per-step noise "step_noise" (loop steps, B, h, w, 4) of
        the samplers that draw it (the ancestral ones; Euler and Heun with
        churn). ``callback(i)`` runs after sampler step i.

        cache_nerf: render once, then reuse the rendered features. Euler
        takes its step 0 from the render pass, so its loop runs the other
        n - 1 steps (and draws n - 1 noise rows); every other sampler runs
        all n steps on the cached network after the render pass, one extra
        evaluation that keeps its own step structure exact.

        shared_target_cams: declares that every guider copy carries the same
        target camera rows (``cams`` tiles one B-row block over the copies,
        as cli/sample.py builds it). Under the x3 guider that licenses the
        render dedupe (models/transformer.py, ``CD360_CFG3_DEDUPE``). The
        cached steps also run the UNet's pre-pose-block prefix on the
        guider's unique copies (``prefix_copy_groups``; off with
        ``CD360_PREFIX_DEDUPE=0``).

        cfg_group: a process group whose size divides the num_copies * B
        guider rows (latency sharding, the JAX package's ``cfg_sharding``).
        Each rank runs the UNet on its own run of those rows (its cameras,
        reference rows and conditioning rows), and one all-gather before
        the guider combine gives every rank all of them, so every rank
        steps the same latent. Both dedupes are off under it, as in JAX
        (they move rows between copies). Every rank passes the same inputs.

        view_group: a process group whose size divides the chosen views
        (the view-sharded render, the JAX package's ``ref_sharding``; delta
        buffers only). Each rank renders from its own run of the views (its
        reference tokens, cameras and ``mask_ref`` views), and the pose
        blocks' reductions over the views all-reduce over the group
        (``models.nerf.view_sharded``), so every rank ends the render with
        the same rendered rows. Only the render does: the cached steps make
        no view collective. It composes with ``cfg_group`` on a (cfg, view)
        grid (``parallel.new_groups_2d``): a view group then holds ranks of
        the same CFG rows. The x3 render dedupe is off under it.

        num_frames: a video network's frames a clip; the batch B then holds
        B / num_frames clips, clip-major, and ``cond`` / ``uc`` one row a
        frame (crossattn, vector and the "concat" latents).
        """
        cfg = self.cfg
        n_steps = num_steps or cfg.num_sample_steps
        sigmas = self.sigmas(n_steps)  # host f32
        x = noise.to(self.device, torch.float32) * torch.sqrt(1.0 + sigmas[0] ** 2)
        b = x.shape[0]
        name = sampler or cfg.sampler_name
        if name not in SAMPLERS:
            raise ValueError(f"unknown sampler {name!r}; choose from {sorted(SAMPLERS)}")
        sampler_fn = SAMPLERS[name]
        if cams is not None:
            cams = cams.to(self.device)
        if input_ref is not None:
            input_ref = input_ref.to(self.device, torch.float32)
            if sigmas_ref is not None:
                sigmas_ref = sigmas_ref.to(self.device, torch.float32)
        if mask_ref is not None:
            mask_ref = mask_ref.to(self.device)
        rows = b * guider.num_copies
        lo, hi = 0, rows
        if cfg_group is not None:
            from .parallel.mesh import rank, world_size

            n = world_size(cfg_group)
            if rows % n:
                raise ValueError(f"{rows} guider rows do not split over {n} ranks")
            lo = rank(cfg_group) * (rows // n)
            hi = lo + rows // n
            cams = None if cams is None else cams[lo:hi]
            input_ref = None if input_ref is None else input_ref[lo:hi]
            sigmas_ref = None if sigmas_ref is None else sigmas_ref[lo:hi]
            mask_ref = None if mask_ref is None else mask_ref[lo:hi]
        views = None
        if view_group is not None:
            from .parallel.mesh import rank, world_size

            if references is None:
                raise ValueError("view_group shards the render of delta-buffer references; "
                                 "live reference latents (input_ref) are not split")
            n, k = len(choices), world_size(view_group)
            if n % k:
                raise ValueError(f"{n} chosen views do not split over a view group of {k} ranks")
            views = (rank(view_group) * (n // k), (rank(view_group) + 1) * (n // k))
            if cams is not None:  # the target camera, then this rank's views'
                cams = Cameras(*(torch.cat([f[:, :1], f[:, 1 + views[0]:1 + views[1]]], dim=1)
                                 for f in cams))
            mask_ref = None if mask_ref is None else mask_ref[:, views[0]:views[1]]

        with span("cd360.sample.prepare"):
            # inference-only q/k/v projection fusion, once per call, into
            # the leaves of the last call (their addresses stay)
            params = dict(params, unet=self.graphs.fuse(params["unet"]))
            ref_features = None
            if references is not None:
                ref_features = self.build_ref_features(
                    references, choices, b, guider.num_copies,
                    shared_cams=shared_target_cams and cfg_group is None and view_group is None,
                    compact=mask_ref is None, rows=None if cfg_group is None else (lo, hi),
                    views=views)

        def local_rows(xb, sb, cb):
            """This rank's guider rows: the target rows lo..hi-1 and, with
            live references, their reference rows after all target rows."""
            if cfg_group is None:
                return xb, sb, cb
            out = {}
            for k, v in cb.items():
                if k in _COND_KEYS:
                    per = (v.shape[0] - rows) // rows  # reference rows per guider row
                    v = torch.cat([v[lo:hi], v[rows + lo * per: rows + hi * per]])
                out[k] = v
            return xb[lo:hi], sb[lo:hi], out

        def gathered(denoised):
            if cfg_group is None:
                return denoised
            from .parallel.mesh import all_gather_rows

            return all_gather_rows(denoised, cfg_group)

        def make_denoise(nerf_caches, collect_rendered):
            ctx_kv = None
            if nerf_caches is not None:
                # cached phase: hoist the text K/V projections out of the
                # loop; with live references the conditioner's reference
                # rows follow the target rows, so keep the target rows only
                sig0 = torch.zeros((b,), device=self.device)
                _, _, cb = guider.prepare(x, sig0, cond, uc)
                ctx = cb["crossattn"][lo:hi]
                ctx_kv = precompute_context_kv(params["unet"], cfg.unet, ctx.to(cfg.dtype))
            prefix_dedupe = None
            if (nerf_caches is not None and cfg_group is None
                    and os.environ.get("CD360_PREFIX_DEDUPE", "1") != "0"):
                prefix_dedupe = getattr(guider, "prefix_copy_groups", None)

            def build(caches, kv):
                return self.network_fn(
                    params, cams, mask_ref, nerf_caches=caches,
                    ref_features=None if caches is not None else ref_features,
                    ctx_kv=kv, prefix_dedupe=prefix_dedupe, num_frames=num_frames,
                )

            if nerf_caches is None:
                network = build(None, ctx_kv)
            else:  # replayed as CUDA graphs where models.unet_graphs.engages
                network = self.graphs.network(
                    build, params["unet"], nerf_caches, ctx_kv,
                    group=cfg_group if cfg_group is not None else view_group,
                    settings=(prefix_dedupe,))
            live = {}
            if nerf_caches is None and input_ref is not None:
                live = dict(input_ref=input_ref, sigmas_ref=sigmas_ref)

            def denoise(xi, sigma_vec):
                xb, sb, cb = local_rows(*guider.prepare(xi, sigma_vec, cond, uc))
                denoised, aux = self.denoiser(network, xb, sb, cb, **live)
                denoised = gathered(denoised)
                if collect_rendered:
                    return guider.combine(denoised, sigma_vec), aux["rendered"]
                return guider.combine(denoised, sigma_vec)

            return denoise

        def noise_rows(n):
            return step_noise(draws, name, cfg.sampler, n, x.shape, self.device)

        if cache_nerf and (ref_features or input_ref is not None):
            s0 = torch.full((b,), float(sigmas[0]), dtype=torch.float32, device=self.device)
            euler = name == "euler_edm"
            with span("cd360.sample.render"):
                with view_sharded(view_group):
                    denoised, rendered = make_denoise(None, True)(x, s0)
                if euler:  # Euler's step 0 is the render pass's own evaluation
                    x = x + (sigmas[1] - sigmas[0]) * to_d(x, s0, denoised)
            del denoised
            denoise_rest = make_denoise(rendered or None, False)
            if euler:
                if callback is not None:
                    callback(0)
                step_cb = None if callback is None else (lambda i: callback(i + 1))
                return euler_edm_sample(denoise_rest, x, sigmas[1:], cfg.sampler,
                                        noise=noise_rows(n_steps - 1), scale_init=False,
                                        callback=step_cb)
            return sampler_fn(denoise_rest, x, sigmas, cfg.sampler, noise=noise_rows(n_steps),
                              scale_init=False, callback=callback)
        with view_sharded(view_group):  # every step renders
            return sampler_fn(make_denoise(None, False), x, sigmas, cfg.sampler,
                              noise=noise_rows(n_steps), scale_init=False, callback=callback)

    @torch.inference_mode()
    def samplemulti(self, params, conds, uc, guider, *, noise, cams_list, references=None,
                    choices=None, num_steps: Optional[int] = None, window: int = 64,
                    stride: int = 48, callback: Optional[Callable[[int], None]] = None):
        """MultiDiffusion panorama sampling -> latents (B, H, W, 4) f32:
        overlapping windows of the wide latent, window j denoised under view
        j's conditioning ``conds[j]`` and CFG-tiled cameras ``cams_list[j]``
        each step and averaged (diffusion.sampling.multidiffusion_sample).
        noise: the wide latent's draws (B, H, stride * (views + 1), 4).
        Every step renders (no cache), as in the JAX package."""
        n_steps = num_steps or self.cfg.num_sample_steps
        sigmas = self.sigmas(n_steps)
        b = noise.shape[0]
        params = dict(params, unet=fuse_attention_params(params["unet"]))
        ref_features = None
        if references is not None:
            ref_features = self.build_ref_features(references, choices, b, guider.num_copies)

        def make_view_fn(cond_j, cams_j):
            network = self.network_fn(params, None if cams_j is None else cams_j.to(self.device),
                                      ref_features=ref_features)

            def denoise(xi, sigma_vec):
                xb, sb, cb = guider.prepare(xi, sigma_vec, cond_j, uc)
                denoised, _ = self.denoiser(network, xb, sb, cb)
                return guider.combine(denoised, sigma_vec)

            return denoise

        fns = [make_view_fn(c, cams) for c, cams in zip(conds, cams_list)]
        return multidiffusion_sample(fns, noise.to(self.device, torch.float32), sigmas,
                                     self.cfg.sampler, window=window, stride=stride,
                                     callback=callback)

    @torch.inference_mode()
    def log_images(self, params, batch, draws, *, guider=None, num_steps: int = 8,
                   sample: bool = True):
        """Training-preview images, each (B, H, W, 3) f32 in [-1, 1]:
        "inputs"; "reconstructions" (VAE encode + decode); "samples", a
        ``num_steps`` live-reference sample under ``guider`` (default
        vanilla_cfg_img_ref(5.0)) whose reference latents are the batch's
        own reference images ([zeros | refs] over the CFG copies) with the
        cameras tiled over the copies; and the FeatureNeRF diagnostics, one
        live forward at sigma 3: "predicted_rgb_<i>" and "fg_mask_<i>" per
        pose block, at its token grid. batch: the training batch contract
        (``training_loss``). draws: "vae_eps", "vae_eps_ref" (the posterior
        draws of the target and reference images), "noise" (the sample's
        initial latent), "step_noise" (when the sampler draws it) and
        "diag_noise" (the diagnostic forward's noise)."""
        dev = self.device
        image = batch["image"].to(dev)
        out = {"inputs": image.float()}
        z = self.encode_first_stage(params, image,
                                    draws.normal("vae_eps", self.latent_shape(image.shape), dev))
        out["reconstructions"] = self.decode_first_stage(params, z.to(self.cfg.dtype)).float()
        if not sample:
            return out

        guider = guider or vanilla_cfg_img_ref(scale=5.0)
        batch = {k: v.to(dev) if hasattr(v, "to") else v for k, v in batch.items()}
        ccfg = self.cfg.conditioner
        cond = apply_conditioner(params["conditioner"], batch, ccfg, ref=True)
        uc = apply_conditioner(params["conditioner"], batch, ccfg, force_zero_txt=True, ref=True)
        ir = batch["image_ref"]
        b, n = ir.shape[:2]
        ir = ir.reshape((b * n,) + tuple(ir.shape[2:]))
        zr = self.encode_first_stage(
            params, ir, draws.normal("vae_eps_ref", self.latent_shape(ir.shape), dev))
        zr = zr.reshape((b, n) + tuple(z.shape[1:]))
        copies = guider.num_copies
        cams = batch.get("cams")
        cams_cfg = None if cams is None else Cameras(*(torch.cat([f] * copies) for f in cams))
        z_s = self.sample(
            params, cond, uc, guider, noise=draws.normal("noise", tuple(z.shape), dev),
            cams=cams_cfg, input_ref=torch.cat([torch.zeros_like(zr)] + [zr] * (copies - 1)),
            sigmas_ref=torch.zeros((copies * b,), device=dev), num_steps=num_steps,
            draws=draws)
        out["samples"] = self.decode_first_stage(params, z_s.to(self.cfg.dtype)).float()

        sig = torch.full((b,), 3.0, device=dev)
        noised = z + 3.0 * draws.normal("diag_noise", tuple(z.shape), dev)
        _, aux = self.denoiser(self.network_fn(params, cams), noised, sig, cond,
                               input_ref=zr, sigmas_ref=torch.zeros((b,), device=dev))
        for i, rgb in enumerate(aux["rgb_list"]):
            size = math.isqrt(rgb.shape[1])
            out[f"predicted_rgb_{i}"] = rgb.reshape(b, size, size, 3).float() * 2.0 - 1.0
        for i, fg in enumerate(aux["fg_mask_list"]):
            size = math.isqrt(fg.shape[1])
            heat = fg.reshape(b, size, size, 1).float().clamp(0.0, 1.0)
            out[f"fg_mask_{i}"] = heat.expand(b, size, size, 3) * 2.0 - 1.0
        return out
