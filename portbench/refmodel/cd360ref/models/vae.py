"""SDXL VAE (port of custom_diffusion360_tpu/models/vae.py): the decoder
for sampling; the encoder, diagonal-Gaussian sample and
``encode_first_stage`` for the diffusion training step, where the VAE is
frozen and encodes under ``torch.no_grad``; and ``autoencoding_engine_encode``
with a pluggable latent regularizer and the identity first stage for the
autoencoder trainer (train/ae_engine.py), which trains the VAE itself.
``vae_encode`` and ``vae_decode`` compute in the input's dtype and cast each
parameter to it differentiably, so float32 parameters that require grad get
their gradient. NHWC; single-head attention at the bottleneck, the plain
attention here. Every conv is ``F.conv2d``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.attention import dot_product_attention
from .nn import (
    Init,
    conv2d,
    conv2d_init,
    group_norm,
    group_norm_init,
    group_norm_silu,
    torch_dtype,
    upsample_nearest_2x,
)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    in_channels: int = 3
    out_ch: int = 3
    z_channels: int = 4
    double_z: bool = True
    scale_factor: float = 0.13025


def _conv3(p, x):
    """3x3 SAME conv of a res block or upsample."""
    return conv2d(p, x)


def _gn_silu(p, x):
    return group_norm_silu(p, x, num_groups=min(32, x.shape[-1]))


def _gn(p, x):
    return group_norm(p, x, num_groups=min(32, x.shape[-1]))


def _init_res(init: Init, in_ch, out_ch):
    p = {
        "norm1": group_norm_init(init, in_ch),
        "conv1": conv2d_init(init, in_ch, out_ch, 3),
        "norm2": group_norm_init(init, out_ch),
        "conv2": conv2d_init(init, out_ch, out_ch, 3),
    }
    if in_ch != out_ch:
        p["nin_shortcut"] = conv2d_init(init, in_ch, out_ch, 1)
    return p


def _res_apply(p, x):
    h = _conv3(p["conv1"], _gn_silu(p["norm1"], x))
    h = _conv3(p["conv2"], _gn_silu(p["norm2"], h))
    if "nin_shortcut" in p:
        x = conv2d(p["nin_shortcut"], x)
    return x + h


def _init_attn(init: Init, ch):
    return {"norm": group_norm_init(init, ch),
            "q": conv2d_init(init, ch, ch, 1), "k": conv2d_init(init, ch, ch, 1),
            "v": conv2d_init(init, ch, ch, 1),
            "proj_out": conv2d_init(init, ch, ch, 1)}


def _attn_apply(p, x):
    """Single-head bottleneck self-attention."""
    b, h, w, c = x.shape
    hn = _gn(p["norm"], x)
    q = conv2d(p["q"], hn).reshape(b, h * w, 1, c)
    k = conv2d(p["k"], hn).reshape(b, h * w, 1, c)
    v = conv2d(p["v"], hn).reshape(b, h * w, 1, c)
    out = dot_product_attention(q, k, v).reshape(b, h, w, c)
    return x + conv2d(p["proj_out"], out)


def _downsample(p, x):
    """Stride-2 3x3 conv after a (0, 1) zero pad of H and W (the reference
    pads bottom and right only); the pad is taken in NHWC so the conv reads
    a channels-last view."""
    x = F.pad(x, (0, 0, 0, 1, 0, 1))
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"].to(x.dtype), p["b"].to(x.dtype), stride=2)
    return y.permute(0, 2, 3, 1)


def init_vae_params(cfg: VAEConfig = VAEConfig(), seed: int = 0, device="cuda",
                    dtype=torch.float32):
    """Seeded random parameters with the JAX tree's structure: "encoder",
    "decoder", "quant_conv" and "post_quant_conv"."""
    init = Init(seed, resolve_device(device), torch_dtype(dtype))
    n_lv = len(cfg.ch_mult)
    bi = cfg.ch * cfg.ch_mult[-1]
    enc = {"conv_in": conv2d_init(init, cfg.in_channels, cfg.ch, 3)}
    in_mult = (1,) + tuple(cfg.ch_mult)
    for i in range(n_lv):
        block_in, block_out = cfg.ch * in_mult[i], cfg.ch * cfg.ch_mult[i]
        lvl = {"block": [_init_res(init, block_in if j == 0 else block_out, block_out)
                         for j in range(cfg.num_res_blocks)]}
        if i != n_lv - 1:
            lvl["downsample"] = conv2d_init(init, block_out, block_out, 3)
        enc[f"down_{i}"] = lvl
    enc["mid"] = {"block_1": _init_res(init, bi, bi), "attn_1": _init_attn(init, bi),
                  "block_2": _init_res(init, bi, bi)}
    zc = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
    enc["norm_out"] = group_norm_init(init, bi)
    enc["conv_out"] = conv2d_init(init, bi, zc, 3)

    dec = {
        "conv_in": conv2d_init(init, cfg.z_channels, bi, 3),
        "mid": {"block_1": _init_res(init, bi, bi), "attn_1": _init_attn(init, bi),
                "block_2": _init_res(init, bi, bi)},
    }
    block_in = bi
    for i in reversed(range(n_lv)):
        block_out = cfg.ch * cfg.ch_mult[i]
        blocks = [_init_res(init, block_in if j == 0 else block_out, block_out)
                  for j in range(cfg.num_res_blocks + 1)]
        block_in = block_out
        lvl = {"block": blocks}
        if i != 0:
            lvl["upsample"] = conv2d_init(init, block_out, block_out, 3)
        dec[f"up_{i}"] = lvl
    dec["norm_out"] = group_norm_init(init, block_in)
    dec["conv_out"] = conv2d_init(init, block_in, cfg.out_ch, 3)
    return {"encoder": enc, "decoder": dec,
            "quant_conv": conv2d_init(init, zc, zc, 1),
            "post_quant_conv": conv2d_init(init, cfg.z_channels, cfg.z_channels, 1)}


def vae_encode(params, x, cfg: VAEConfig = VAEConfig()):
    """x: (B, H, W, 3) in [-1, 1] -> moments (B, H/8, W/8, 2 * z) in x.dtype."""
    enc = params["encoder"]
    h = conv2d(enc["conv_in"], x)
    for i in range(len(cfg.ch_mult)):
        lvl = enc[f"down_{i}"]
        for bp in lvl["block"]:
            h = _res_apply(bp, h)
        if "downsample" in lvl:
            h = _downsample(lvl["downsample"], h)
    h = _res_apply(enc["mid"]["block_1"], h)
    h = _attn_apply(enc["mid"]["attn_1"], h)
    h = _res_apply(enc["mid"]["block_2"], h)
    h = conv2d(enc["conv_out"], _gn_silu(enc["norm_out"], h))
    return conv2d(params["quant_conv"], h)


def diagonal_gaussian_sample(moments, eps=None):
    """moments = [mean | logvar] on the channel axis; logvar clamped to
    [-30, 20]; returns mean + exp(logvar / 2) * eps (the mean when eps is
    None). eps: standard-normal draws of the mean's shape."""
    mean, logvar = moments.chunk(2, dim=-1)
    if eps is None:
        return mean
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    return mean + std * eps.to(mean.device, mean.dtype)


@torch.no_grad()
def encode_first_stage(params, x, cfg: VAEConfig = VAEConfig(), eps=None):
    """Images (B, H, W, 3) in [-1, 1] -> scaled latents (B, H/8, W/8, z):
    encode, sample with the draws ``eps`` (the mean when None), times
    scale_factor. No gradient: the VAE is frozen."""
    z = diagonal_gaussian_sample(vae_encode(params, x, cfg), eps)
    return z * cfg.scale_factor


def vae_decode(params, z, cfg: VAEConfig = VAEConfig()):
    """z: (B, h, w, z_channels) -> (B, 8h, 8w, 3), computed in z.dtype."""
    dec = params["decoder"]
    z = conv2d(params["post_quant_conv"], z)
    h = conv2d(dec["conv_in"], z)
    h = _res_apply(dec["mid"]["block_1"], h)
    h = _attn_apply(dec["mid"]["attn_1"], h)
    h = _res_apply(dec["mid"]["block_2"], h)
    for i in reversed(range(len(cfg.ch_mult))):
        lvl = dec[f"up_{i}"]
        for bp in lvl["block"]:
            h = _res_apply(bp, h)
        if "upsample" in lvl:
            h = _conv3(lvl["upsample"], upsample_nearest_2x(h))
    return conv2d(dec["conv_out"], _gn_silu(dec["norm_out"], h))


# latent side at/above which a batch decodes one row at a time (1024^2
# output): only one image's decoder activations are live at once
_PER_ROW_DECODE_MIN_LATENT = 128


def decode_first_stage(params, z, cfg: VAEConfig = VAEConfig()):
    """Latents -> images in [-1, 1] (unclipped): z / scale_factor, then the
    decoder; batches at latent side >= 128 decode row by row."""
    z = z / cfg.scale_factor
    if z.shape[0] == 1 or z.shape[1] < _PER_ROW_DECODE_MIN_LATENT:
        return vae_decode(params, z, cfg)
    return torch.cat([vae_decode(params, z[i:i + 1], cfg) for i in range(z.shape[0])])


def autoencoding_engine_encode(params, x, regularizer=None, draws=None,
                               cfg: VAEConfig = VAEConfig(), return_reg_log=False):
    """Encode, then regularize the moments: ``regularizer`` is a callable
    ``moments -> (z, log_dict)`` (identity, a quantizer of
    models/regularizers.py); by default the KL posterior, sampled with the
    draw "vae_eps" when ``draws`` is given, else its mean."""
    from .regularizers import diagonal_gaussian_regularizer

    moments = vae_encode(params, x, cfg)
    if regularizer is None:
        z, reg_log = diagonal_gaussian_regularizer(moments, draws, sample=draws is not None)
    else:
        z, reg_log = regularizer(moments)
    return (z, reg_log) if return_reg_log else z


def identity_first_stage_encode(params, x, *_, **__):
    """A no-op first stage for pixel-space diffusion; ``params`` is unused."""
    return x


def identity_first_stage_decode(params, z, *_, **__):
    return z
