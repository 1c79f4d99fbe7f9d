"""Auxiliary conditioner embedders of the sgm framework (port of
custom_diffusion360_tpu/models/embedders.py): IdentityEncoder,
ClassEmbedder(ForMultiCond), FrozenOpenCLIPEmbedder2,
FrozenOpenCLIPImageEmbedder with its CLIP preprocess, FrozenCLIPT5Encoder,
SpatialRescaler, LowScaleEncoder and GaussianEncoder, each a function over
dicts of tensors (NHWC images); and Stable Video Diffusion's
FrozenOpenCLIPImagePredictionEmbedder and VideoPredictionEmbedderWithEncoder,
which have no JAX counterpart.

Randomness enters as named draws (``draws.Draws``), so a test can hand
both packages the same numbers: "ucg" (uniforms (B,), a row is kept where
u < 1 - ucg_rate: ``jax.random.bernoulli``'s own rule), "vae_eps" (the
posterior's standard normal), "noise_level" (ints in [0,
max_noise_level), (B,)) and "noise" (the standard normal of the low-scale
q_sample).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.image_resize import resize_images
from .clip import ClipTextConfig, ClipVisionConfig, clip_text_apply, clip_vision_apply
from .nn import Init, conv2d, conv2d_init, layer_norm, nearest_indices
from .regularizers import diagonal_gaussian_regularizer
from .t5 import T5Config, t5_encode
from .vae import VAEConfig, diagonal_gaussian_sample, vae_decode, vae_encode

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)

# ---------------------------------------------------------------------------
# trivial embedders (modules.py:253-292)
# ---------------------------------------------------------------------------


def identity_encoder(x):
    """IdentityEncoder."""
    return x


def class_embedder_init(init: Init, embed_dim: int, n_classes: int = 1000):
    return {"embedding": init.normal((n_classes, embed_dim), 1.0)}


def class_embedder_apply(params, c, add_sequence_dim: bool = False):
    """c: (B,) int class ids -> (B, D), or (B, 1, D) with
    ``add_sequence_dim`` (ClassEmbedder)."""
    table = params["embedding"]
    out = table[torch.as_tensor(c, device=table.device).long().reshape(-1)]
    return out[:, None, :] if add_sequence_dim else out


def class_embedder_uc(n_classes: int, bs: int, device="cuda"):
    """The extra "unconditional" class id, n_classes - 1, for ``bs`` rows."""
    return torch.full((bs,), n_classes - 1, dtype=torch.int32, device=resolve_device(device))


def class_embedder_multi_cond_apply(params, batch: dict, key_name: str,
                                    add_sequence_dim: bool = False):
    """ClassEmbedderForMultiCond: embeds batch[key_name] (its first element
    when it is a list) and returns a shallow copy of the batch with that
    key replaced (re-listed if it was a list)."""
    val = batch[key_name]
    islist = isinstance(val, list)
    out = class_embedder_apply(params, val[0] if islist else val, add_sequence_dim)
    return dict(batch, **{key_name: [out] if islist else out})


# ---------------------------------------------------------------------------
# FrozenOpenCLIPEmbedder2 (modules.py:519-619)
# ---------------------------------------------------------------------------


def open_clip_embedder2(params, tokens, cfg: ClipTextConfig, layer: str = "last",
                        legacy: bool = True, return_pooled: bool = False):
    """The OpenCLIP text embedder with a selectable output layer.
    legacy: ln_final of the selected hidden state, alone. Not legacy: the
    selected raw hidden state ("last" is ln_final(last)), and with
    ``return_pooled`` also the eot-pooled projection."""
    if layer not in ("last", "penultimate"):
        raise ValueError(f"layer must be 'last' or 'penultimate', got {layer!r}")
    outs = clip_text_apply(params, tokens, cfg)
    if legacy:
        if return_pooled:
            raise ValueError("the legacy embedder returns no pooled output")
        return layer_norm(params["ln_final"], outs[layer], eps=cfg.ln_eps)
    z = outs["final"] if layer == "last" else outs[layer]
    return (z, outs["pooled"]) if return_pooled else z


# ---------------------------------------------------------------------------
# FrozenOpenCLIPImageEmbedder (modules.py:774-932)
# ---------------------------------------------------------------------------


def clip_image_preprocess(x, size: int = 224):
    """(B, H, W, 3) in [-1, 1] -> (B, size, size, 3) CLIP-normalized f32:
    the antialiased Keys-cubic resize of ``jax.image.resize(...,
    "cubic")``, then [0, 1], then the CLIP mean and std."""
    x = (resize_images(x, size, "cubic") + 1.0) / 2.0
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def open_clip_image_embedder(params, images, cfg: ClipVisionConfig, draws=None,
                             ucg_rate: float = 0.0, unsqueeze_dim: bool = False,
                             repeat_to_max_len: bool = False, max_length: int = 77,
                             output_tokens: bool = False):
    """images: (B, H, W, 3) in [-1, 1] -> the pooled CLIP image embedding
    (FrozenOpenCLIPImageEmbedder.forward): rows zeroed at ``ucg_rate`` by
    the draw "ucg", then optionally a sequence axis or a repeat to
    ``max_length``; with ``output_tokens`` (tokens, pooled)."""
    z = clip_vision_apply(params, clip_image_preprocess(images, cfg.image_size), cfg,
                          output_tokens=output_tokens)
    tokens = None
    if output_tokens:
        z, tokens = z
    if ucg_rate > 0.0:
        if draws is None:
            raise ValueError(f"ucg dropout at rate {ucg_rate} needs draws ('ucg')")
        keep = draws.uniform("ucg", (z.shape[0],), z.device) < 1.0 - ucg_rate
        z = keep[:, None].to(z.dtype) * z
        if tokens is not None:
            tokens = keep[:, None, None].to(tokens.dtype) * tokens
    if unsqueeze_dim:
        z = z[:, None, :]
    if output_tokens:
        return tokens, z
    if repeat_to_max_len:
        z_ = z[:, None, :] if z.dim() == 2 else z
        return z_.expand(z_.shape[0], max_length, z_.shape[-1]), z
    return z


# ---------------------------------------------------------------------------
# FrozenCLIPT5Encoder (modules.py:935-960)
# ---------------------------------------------------------------------------


def clip_t5_encode(clip_params, t5_params, clip_tokens, t5_tokens, clip_cfg: ClipTextConfig,
                   t5_cfg: T5Config):
    """[clip_z, t5_z]: the CLIP tower's final-LN states and the T5
    encoder's last hidden state."""
    clip_z = clip_text_apply(clip_params, clip_tokens, clip_cfg)["final"]
    return [clip_z, t5_encode(t5_params, t5_tokens, t5_cfg)]


# ---------------------------------------------------------------------------
# SpatialRescaler (modules.py:963-1020)
# ---------------------------------------------------------------------------


def spatial_rescaler_init(init: Init, in_channels: int, out_channels: int,
                          kernel_size: int = 1, bias: bool = False):
    """The optional channel remap conv."""
    return {"mapper": conv2d_init(init, in_channels, out_channels, kernel=kernel_size,
                                  bias=bias)}


def spatial_rescaler(x, n_stages: int = 1, method: str = "bilinear", multiplier: float = 0.5,
                     params=None):
    """x: (B, H, W, C) -> resized each stage by ``multiplier`` (and
    channel-remapped with ``params``). "area" is a mean pool (integer
    factors only); "nearest" takes F.interpolate's source index
    (``nn.nearest_indices``), not jax.image.resize's half-pixel one;
    "bilinear" and "bicubic" are jax.image.resize's antialiased kernels
    (ops/image_resize.py)."""
    for _ in range(n_stages):
        b, h, w, c = x.shape
        nh, nw = int(h * multiplier), int(w * multiplier)
        if method == "area":
            f = h // nh
            if nh * f != h or nw * f != w:
                raise ValueError(f"area resize needs an integer factor, got {h}x{w} -> "
                                 f"{nh}x{nw}")
            x = x.reshape(b, nh, f, nw, f, c).mean(dim=(2, 4))
        elif method == "nearest":
            x = x.index_select(1, nearest_indices(h, nh, x.device))
            x = x.index_select(2, nearest_indices(w, nw, x.device))
        else:
            kernel = {"bilinear": "linear", "bicubic": "cubic"}[method]
            x = resize_images(x, (nh, nw), kernel).to(x.dtype)
    if params is not None:
        x = conv2d(params["mapper"], x)
    return x


# ---------------------------------------------------------------------------
# LowScaleEncoder (modules.py:1023-1114)
# ---------------------------------------------------------------------------


def make_linear_beta_schedule(timesteps: int = 1000, linear_start: float = 1e-4,
                              linear_end: float = 2e-2):
    """The "linear" schedule, linspace(sqrt(start), sqrt(end))^2 in f64,
    as float32 (CPU)."""
    betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps, dtype=np.float64) ** 2
    return torch.from_numpy(betas.astype(np.float32))


@dataclasses.dataclass(frozen=True)
class LowScaleConfig:
    timesteps: int = 1000
    linear_start: float = 1e-4
    linear_end: float = 2e-2
    max_noise_level: int = 250
    output_size: Optional[int] = 64
    scale_factor: float = 1.0


def _half_pixel_indices(src: int, dst: int, device):
    """floor((o + 0.5) * src / dst) in float32: jax.image.resize's
    "nearest"."""
    pos = (torch.arange(dst, dtype=torch.float32) + 0.5) * src / dst
    return torch.floor(pos).long().to(device)


def low_scale_encode(vae_params, x, draws, cfg: LowScaleConfig = LowScaleConfig(),
                     vae_cfg: VAEConfig = VAEConfig()):
    """x: (B, H, W, 3) -> (noised low-scale latent, noise_level (B,)):
    VAE-encode, sample the posterior ("vae_eps"), scale, q_sample at level
    "noise_level" with noise "noise", then jax.image.resize's nearest
    resize (half-pixel centres) to ``output_size``. The q_sample's f32
    schedule promotes a bf16 latent to f32, as in JAX."""
    z, _ = diagonal_gaussian_regularizer(vae_encode(vae_params, x, vae_cfg), draws)
    z = z * cfg.scale_factor
    betas = make_linear_beta_schedule(cfg.timesteps, cfg.linear_start, cfg.linear_end)
    alphas_cumprod = torch.cumprod(1.0 - betas, dim=0).to(z.device)
    level = draws.take("noise_level", (x.shape[0],), z.device,
                       lambda s, g, d: torch.randint(0, cfg.max_noise_level, s, generator=g,
                                                     device=d)).long()
    sqrt_ac = torch.sqrt(alphas_cumprod)[level][:, None, None, None]
    sqrt_1mac = torch.sqrt(1.0 - alphas_cumprod)[level][:, None, None, None]
    noise = draws.normal("noise", tuple(z.shape), z.device).to(z.dtype)
    z = sqrt_ac * z + sqrt_1mac * noise
    if cfg.output_size is not None:
        n = cfg.output_size
        z = z.index_select(1, _half_pixel_indices(z.shape[1], n, z.device))
        z = z.index_select(2, _half_pixel_indices(z.shape[2], n, z.device))
    return z, level


def low_scale_decode(vae_params, z, cfg: LowScaleConfig = LowScaleConfig(),
                     vae_cfg: VAEConfig = VAEConfig()):
    return vae_decode(vae_params, z / cfg.scale_factor, vae_cfg)


# ---------------------------------------------------------------------------
# GaussianEncoder (modules.py:1137-1153)
# ---------------------------------------------------------------------------


def gaussian_encoder(vae_params, x, draws, weight: float = 1.0, flatten_output: bool = True,
                     vae_cfg: VAEConfig = VAEConfig()):
    """VAE encoder + KL posterior sample ("vae_eps"): (log, z), z flattened
    to (B, hw, C) tokens with ``flatten_output``. Like the JAX package's,
    the encoder includes SDXL's quant_conv, which the reference's bare
    Encoder lacks."""
    z, log = diagonal_gaussian_regularizer(vae_encode(vae_params, x, vae_cfg), draws)
    log = dict(log, loss=log["kl_loss"], weight=weight)
    if flatten_output:
        b, h, w, c = z.shape
        z = z.reshape(b, h * w, c)
    return log, z


# ---------------------------------------------------------------------------
# Stable Video Diffusion's embedders (sgm encoders/modules.py)
# ---------------------------------------------------------------------------


def _gaussian_1d(k: int, sigma: float, device):
    t = torch.arange(k, dtype=torch.float32, device=device) - k // 2
    g = torch.exp(-t * t / (2.0 * sigma * sigma))
    return g / g.sum()


def sgm_clip_image_preprocess(x, size: int = 224):
    """(B, H, W, 3) in [-1, 1] -> (B, size, size, 3) CLIP-normalized f32, as
    sgm's FrozenOpenCLIPImageEmbedder.preprocess: ``kornia.geometry.resize``
    to size x size (bicubic, align_corners, antialias: where it shrinks, a
    separable Gaussian of sigma (factor - 1) / 2 over a kernel of
    int(max(4 sigma, 3)) taps made odd, reflect-padded), then [0, 1], then
    the CLIP mean and std."""
    x = x.float().permute(0, 3, 1, 2)
    h, w = x.shape[-2:]
    if (h, w) != (size, size):
        factors = (h / size, w / size)
        if max(factors) > 1:
            c = x.shape[1]
            sig = [max((f - 1.0) / 2.0, 0.001) for f in factors]
            ks = [int(max(4.0 * s, 3)) for s in sig]
            ks = [k + 1 - k % 2 for k in ks]
            gx = _gaussian_1d(ks[1], sig[1], x.device).view(1, 1, 1, -1).expand(c, 1, 1, -1)
            gy = _gaussian_1d(ks[0], sig[0], x.device).view(1, 1, -1, 1).expand(c, 1, -1, 1)
            x = F.conv2d(F.pad(x, (ks[1] // 2, ks[1] // 2, 0, 0), mode="reflect"), gx, groups=c)
            x = F.conv2d(F.pad(x, (0, 0, ks[0] // 2, ks[0] // 2), mode="reflect"), gy, groups=c)
        x = F.interpolate(x, size=(size, size), mode="bicubic", align_corners=True)
    x = (x + 1.0) / 2.0
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=x.device)[:, None, None]
    std = torch.tensor(CLIP_IMAGE_STD, device=x.device)[:, None, None]
    return ((x - mean) / std).permute(0, 2, 3, 1)


def open_clip_image_prediction_embedder(params, vid, cfg: ClipVisionConfig):
    """FrozenOpenCLIPImagePredictionEmbedder at svd.yaml's n_cond_frames =
    n_copies = 1: vid (B, H, W, 3) in [-1, 1] -> the pooled image
    embedding (B, 1, embed_dim)."""
    return clip_vision_apply(params, sgm_clip_image_preprocess(vid, cfg.image_size), cfg)[:, None]


def video_prediction_embedder_with_encoder(vae_params, vid, vae_cfg: VAEConfig):
    """VideoPredictionEmbedderWithEncoder at svd.yaml's settings (is_ae, one
    conditioning frame, one copy, no scale factor): the VAE posterior's
    mode of vid (B, H, W, 3) -> (B, H / 8, W / 8, z_channels), in the VAE's
    dtype. The encode runs in the VAE's dtype too: svd.yaml's
    ``disable_encoder_autocast`` has sgm encode in float32, so a bfloat16
    VAE departs from the source here."""
    dtype = vae_params["quant_conv"]["w"].dtype
    return diagonal_gaussian_sample(vae_encode(vae_params, vid.to(dtype), vae_cfg))
