"""SDXL VAE decoder (port of the decode half of custom_diffusion360_tpu/
models/vae.py). NHWC; single-head attention at the bottleneck, which goes to
the attention kernel on CUDA (d = 512 at full width). The encoder comes with
training and is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

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
    out_ch: int = 3
    z_channels: int = 4
    scale_factor: float = 0.13025


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
    h = conv2d(p["conv1"], _gn_silu(p["norm1"], x))
    h = conv2d(p["conv2"], _gn_silu(p["norm2"], h))
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


def init_vae_params(cfg: VAEConfig = VAEConfig(), seed: int = 0, device="cuda",
                    dtype=torch.float32):
    """Seeded random decoder-side parameters ("decoder", "post_quant_conv")
    with the JAX tree's structure."""
    init = Init(seed, resolve_device(device), torch_dtype(dtype))
    bi = cfg.ch * cfg.ch_mult[-1]
    dec = {
        "conv_in": conv2d_init(init, cfg.z_channels, bi, 3),
        "mid": {"block_1": _init_res(init, bi, bi), "attn_1": _init_attn(init, bi),
                "block_2": _init_res(init, bi, bi)},
    }
    block_in = bi
    for i in reversed(range(len(cfg.ch_mult))):
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
    return {"decoder": dec,
            "post_quant_conv": conv2d_init(init, cfg.z_channels, cfg.z_channels, 1)}


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
            h = conv2d(lvl["upsample"], upsample_nearest_2x(h))
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
