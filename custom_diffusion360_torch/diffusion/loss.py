"""Training loss (port of custom_diffusion360_tpu/diffusion/loss.py), all
terms in float32:

  l2   eps-weighted MSE of the denoised target, masked by the object mask
       (``loss_type="l2"``); ``"l1"``: the weighted absolute error, a plain
       mean with no mask; ``"lpips"``: LPIPS of the output against the
       target (3-channel, pixel-space outputs), in the "l2" slot;
  fg   MSE(rendered fg_mask, antialiased-downsampled opacity), per pose block;
  bg   |alphas - opacity| * (1 - opacity) where opacity < 0.1;
  rgb  masked MSE(volume-rendered RGB, downsampled target image).

The target sigma comes from the cubic sampler on the 1000-step grid, the
reference sigma from the discrete sampler on the 50-step grid; the
reference latents are noised here once and again inside the denoiser (the
reference implementation's double noising). Every draw is named in a
``draws.Draws``: sigma_idx, sigma_ref_idx, noise, noise_ref, noise_ref2.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..ops.image_resize import resize_images
from .sigma_sampling import sample_sigmas_cubic, sample_sigmas_discrete


def _append_dims(x, ndim):
    return x.reshape(tuple(x.shape) + (1,) * (ndim - x.dim()))


@dataclasses.dataclass(frozen=True)
class DiffusionLossConfig:
    loss_type: str = "l2"
    num_idx: int = 1000  # cubic sigma grid of the target
    num_idx_ref: int = 50  # discrete sigma grid of the references
    loss_rgb_lambda: float = 5.0
    loss_fg_lambda: float = 10.0
    loss_bg_lambda: float = 10.0
    # loss_type="lpips": torch checkpoints read once by the Engine (the
    # taming "vgg.pth" heads and a torchvision vgg16 state dict)
    lpips_ckpt: Optional[str] = None
    vgg_ckpt: Optional[str] = None


def diffusion_loss_img_ref(denoiser, network: Callable, cond: dict, x, x_rgb,
                           input_ref, mask, opacity, *, draws, sigmas_cubic,
                           sigmas_discrete, cfg: DiffusionLossConfig = DiffusionLossConfig(),
                           lpips_params=None, **model_kwargs):
    """One training forward -> per-sample loss terms (compute_loss_terms).
    x: (B, H, W, C) clean target latent; x_rgb: (B, Hi, Wi, 3) image in
    [-1, 1]; input_ref: (B, N, H, W, C) clean reference latents or None;
    mask: (B, Hl, Wl, 1) latent-res object mask; opacity: (B, Hi', Wi', 1);
    sigmas_cubic / sigmas_discrete: the ascending training grids;
    lpips_params: the LPIPS weights of ``loss_type="lpips"``."""
    b = x.shape[0]
    sigmas = sample_sigmas_cubic(draws, "sigma_idx", sigmas_cubic, b)
    noise = draws.normal("noise", x.shape, x.device).to(x.dtype)
    noised_input = x + noise * _append_dims(sigmas, x.dim())

    sigmas_ref = sample_sigmas_discrete(draws, "sigma_ref_idx", sigmas_discrete, b)
    noise_ref2 = None
    if input_ref is not None:
        noise_ref = draws.normal("noise_ref", input_ref.shape, x.device).to(input_ref.dtype)
        input_ref = input_ref + noise_ref * _append_dims(sigmas_ref, input_ref.dim())
        noise_ref2 = draws.normal("noise_ref2", input_ref.shape, x.device).to(input_ref.dtype)

    model_output, aux = denoiser(network, noised_input, sigmas, cond, input_ref=input_ref,
                                 sigmas_ref=sigmas_ref, noise_ref=noise_ref2, **model_kwargs)
    w = _append_dims(denoiser.w(sigmas), x.dim())
    return compute_loss_terms(model_output, aux["fg_mask_list"], aux["alphas_list"],
                              aux["rgb_list"], x, x_rgb, w, mask, opacity, cfg=cfg,
                              lpips_params=lpips_params)


def compute_loss_terms(model_output, fg_mask_list, alphas_list, rgb_list, target,
                       target_rgb, w, mask, opacity, *,
                       cfg: DiffusionLossConfig = DiffusionLossConfig(), lpips_params=None):
    """Per-sample terms in f32: 'l2' (B,), 'fg' / 'bg' / 'rgb' (B, n_blocks)
    or None (always None under "l1" and "lpips")."""
    model_output, target = model_output.float(), target.float()
    b = target.shape[0]
    if cfg.loss_type == "l1":
        loss_l1 = (w.float() * (model_output - target).abs()).reshape(b, -1).mean(1)
        return {"l2": loss_l1, "fg": None, "bg": None, "rgb": None}
    if cfg.loss_type == "lpips":
        if lpips_params is None:
            raise ValueError("loss_type='lpips' needs lpips params: set DiffusionLossConfig."
                             "lpips_ckpt / vgg_ckpt (read at Engine init) or pass "
                             "lpips_params")
        if model_output.shape[-1] != 3:
            raise ValueError(f"LPIPS expects 3-channel inputs, got {tuple(model_output.shape)}")
        from ..models.lpips import lpips_apply

        return {"l2": lpips_apply(lpips_params, model_output, target), "fg": None, "bg": None,
                "rgb": None}
    if cfg.loss_type != "l2":
        raise NotImplementedError(f"loss_type={cfg.loss_type!r}")
    loss = w.float() * (model_output - target) ** 2
    if mask is not None:
        m = mask.float()
        loss_l2 = (loss * m).sum((1, 2, 3)) / (m.sum((1, 2, 3)) + 1e-6)
    else:
        loss_l2 = loss.reshape(b, -1).mean(1)
    out = {"l2": loss_l2, "fg": None, "bg": None, "rgb": None}

    if fg_mask_list and alphas_list:
        fg_terms, bg_terms = [], []
        for fg_mask, alphas in zip(fg_mask_list, alphas_list):
            size = math.isqrt(fg_mask.shape[1])  # fg_mask (B, hw); alphas (B, hw, S, 1)
            op = resize_images(opacity, size, "linear").reshape(-1, size * size).detach()
            fg = fg_mask.float().reshape(-1, size * size).clamp(0.0, 1.0)
            fg_terms.append(((fg - op) ** 2).mean(1))
            op_b = op.reshape(-1, size * size, 1, 1)
            bg = (alphas.float() - op_b).abs() * (1.0 - op_b) * (op_b < 0.1).float()
            bg_terms.append(bg.mean((1, 2, 3)))
        out["fg"] = torch.stack(fg_terms, dim=1)
        out["bg"] = torch.stack(bg_terms, dim=1)

    if rgb_list:
        m = mask.float()
        rgb_terms = []
        for rgb in rgb_list:  # (B, hw, 3), compared in [0, 1]
            size = math.isqrt(rgb.shape[1])
            mask_s = resize_images(m, size, "linear").detach()
            tgt = resize_images(target_rgb.float() * 0.5 + 0.5, size, "linear").detach()
            err = (tgt - rgb.float().reshape(-1, size, size, 3)) ** 2
            rgb_terms.append((err * mask_s).sum((1, 2, 3)) / (m.sum((1, 2, 3)) + 1e-6))
        out["rgb"] = torch.stack(rgb_terms, dim=1)
    return out


def combine_losses(terms: dict, drop_im, global_step: int, *,
                   cfg: DiffusionLossConfig = DiffusionLossConfig(), rgb_predict: bool = True,
                   kept=None):
    """Lambda-weighted total -> (loss, metrics). ``drop_im`` (B,) is 1 where
    the item kept its reference images (fg/bg/rgb apply only there); the
    fg/bg terms count only from global_step 1 on. ``kept``: the count of
    such items that the fg/bg/rgb sums are divided by, by default this
    batch's. Under data parallelism it is the mean of the ranks' counts, so
    that the mean of the ranks' terms is the global batch's term."""
    loss_mean = terms["l2"].mean()
    metrics = {"loss": loss_mean}
    drop = drop_im.reshape(-1).float()
    denom = (drop.sum() if kept is None else kept) + 1e-12
    if terms["fg"] is not None:
        loss_fg = (terms["fg"].mean(1) * drop).sum() / denom
        loss_bg = (terms["bg"].mean(1) * drop).sum() / denom
        if global_step > 0:
            loss_mean = loss_mean + cfg.loss_fg_lambda * loss_fg + cfg.loss_bg_lambda * loss_bg
        metrics.update(loss_fg=loss_fg, loss_bg=loss_bg)
    if rgb_predict and terms["rgb"] is not None:
        loss_rgb = (terms["rgb"].mean(1) * drop).sum() / denom
        loss_mean = loss_mean + cfg.loss_rgb_lambda * loss_rgb
        metrics["loss_rgb"] = loss_rgb
    metrics["loss_total"] = loss_mean
    return loss_mean, metrics
