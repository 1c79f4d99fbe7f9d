"""The remaining sgm network blocks (port of custom_diffusion360_tpu/models/
extra_blocks.py): LinearAttention and LinAttnBlock, SpatialSelfAttention,
BasicTransformerSingleLayerBlock, TransposedUpsample, the DDPM pixel-space
Model (the VAE-net-shaped diffusion UNet with the DDPM skip stack and
[sin | cos] timestep embedding), and DiracDistribution / normal_kl.

NHWC, (in, out) linear weights, OIHW conv kernels. The transposed
upsample's kernel is the JAX tree's (kh, kw, OUT, IN) forward-conv kernel
after ``io.from_jax``'s HWIO -> OIHW turn: (IN, OUT, kh, kw), which is
``F.conv_transpose2d``'s weight layout. The GroupNorms run the GroupNorm
kernel on the card, the single-layer block's LayerNorms the LayerNorm
kernel and its long self-attention the attention kernel
(``transformer.cross_attention_apply``); the linear and spatial attention
are plain PyTorch, as the JAX package's plain einsums.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import resolve_device
from .nn import (
    Init,
    conv2d,
    conv2d_init,
    group_norm,
    group_norm_init,
    group_norm_silu,
    layer_norm,
    layer_norm_init,
    linear,
    linear_init,
    silu,
    torch_dtype,
    upsample_nearest_2x,
)
from .transformer import (
    cross_attention_apply,
    feedforward_apply,
    init_cross_attention,
    init_feedforward,
)

# ---------------------------------------------------------------------------
# DDPM timestep embedding (model.py:26-44): [sin | cos], /(half - 1) spacing
# ---------------------------------------------------------------------------


def ddpm_timestep_embedding(t, dim: int):
    """t: (N,) -> (N, dim) f32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / (half - 1))
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


# ---------------------------------------------------------------------------
# LinearAttention (attention.py:124-145), LinAttnBlock (model.py:154-159)
# ---------------------------------------------------------------------------


def init_linear_attention(init: Init, dim: int, heads: int = 4, dim_head: int = 32):
    hidden = dim_head * heads
    return {"to_qkv": linear_init(init, dim, hidden * 3, bias=False),
            "to_out": linear_init(init, hidden, dim)}


def linear_attention_apply(p, x, heads: int = 4):
    """x: (B, H, W, C): keys softmaxed over the tokens, then two (d, e)
    contractions instead of an (n, n) score matrix."""
    b, h, w, c = x.shape
    qkv = linear(p["to_qkv"], x.reshape(b, h * w, -1))
    hidden = qkv.shape[-1] // 3
    qkv = qkv.reshape(b, h * w, 3, heads, hidden // heads)  # "b (qkv heads c) h w"
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    k = torch.softmax(k, dim=1)
    context = torch.einsum("bnhd,bnhe->bhde", k, v)
    out = torch.einsum("bhde,bnhd->bnhe", context, q).reshape(b, h * w, hidden)
    return linear(p["to_out"], out).reshape(b, h, w, c)


def init_lin_attn_block(init: Init, in_channels: int):
    """One head of ``in_channels``."""
    return init_linear_attention(init, in_channels, heads=1, dim_head=in_channels)


def lin_attn_block_apply(p, x):
    return linear_attention_apply(p, x, heads=1)


# ---------------------------------------------------------------------------
# SpatialSelfAttention (attention.py:147-189)
# ---------------------------------------------------------------------------


def init_spatial_self_attention(init: Init, in_channels: int):
    p = {"norm": group_norm_init(init, in_channels)}
    for name in ("q", "k", "v", "proj_out"):
        p[name] = linear_init(init, in_channels, in_channels)
    return p


def spatial_self_attention_apply(p, x):
    """x: (B, H, W, C) -> residual single-head attention over the tokens
    (its 1x1 convs are linears on the tokens); f32 scores and softmax."""
    b, h, w, c = x.shape
    t = group_norm(p["norm"], x).reshape(b, h * w, c)
    q, k, v = linear(p["q"], t), linear(p["k"], t), linear(p["v"], t)
    s = torch.einsum("bic,bjc->bij", q.float(), k.float()) * (c ** -0.5)
    a = torch.softmax(s, dim=2).to(v.dtype)
    out = torch.einsum("bij,bjc->bic", a, v)
    return x + linear(p["proj_out"], out).reshape(b, h, w, c)


# ---------------------------------------------------------------------------
# BasicTransformerSingleLayerBlock (attention.py:640-681)
# ---------------------------------------------------------------------------


def init_single_layer_block(init: Init, dim: int, n_heads: int, d_head: int, context_dim=None):
    return {
        "norm1": layer_norm_init(init, dim),
        "attn1": init_cross_attention(init, dim, context_dim or dim, n_heads, d_head),
        "norm2": layer_norm_init(init, dim),
        "ff": init_feedforward(init, dim),
    }


def single_layer_block_apply(p, x, context=None, *, n_heads: int):
    """x: (B, N, dim); attn1 attends to ``context`` (itself when None),
    then the GEGLU feed-forward, each pre-LN with a residual."""
    x = cross_attention_apply(p["attn1"], layer_norm(p["norm1"], x), context,
                              n_heads=n_heads) + x
    return feedforward_apply(p["ff"], layer_norm(p["norm2"], x)) + x


# ---------------------------------------------------------------------------
# TransposedUpsample (openaimodel.py:167-180)
# ---------------------------------------------------------------------------


def init_transposed_upsample(init: Init, channels: int, out_channels=None, ks: int = 5):
    """Kernel (channels, out_channels, ks, ks): conv_transpose2d's layout,
    the JAX tree's (ks, ks, OUT, IN) after io.from_jax."""
    out_channels = out_channels or channels
    bound = math.sqrt(1.0 / (channels * ks * ks))
    return {"w": init.uniform((channels, out_channels, ks, ks), bound),
            "b": init.uniform((out_channels,), bound)}


def transposed_upsample_apply(p, x):
    """Learned 2x upsample without padding: out = 2 in + ks - 2 (torch
    ConvTranspose2d at stride 2)."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), p["w"].to(x.dtype), p["b"].to(x.dtype),
                           stride=2)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# DDPM pixel-space Model (model.py:312-485)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DDPMModelConfig:
    ch: int = 64
    out_ch: int = 3
    ch_mult: Tuple[int, ...] = (1, 2, 4, 8)
    num_res_blocks: int = 2
    attn_resolutions: Tuple[int, ...] = (16,)
    in_channels: int = 3
    resolution: int = 64
    use_timestep: bool = True
    attn_type: str = "vanilla"  # or "linear" / "none"


def _init_res(init: Init, cin, cout, temb_ch):
    p = {
        "norm1": group_norm_init(init, cin),
        "conv1": conv2d_init(init, cin, cout, 3),
        "norm2": group_norm_init(init, cout),
        "conv2": conv2d_init(init, cout, cout, 3),
    }
    if temb_ch > 0:
        p["temb_proj"] = linear_init(init, temb_ch, cout)
    if cin != cout:
        p["nin_shortcut"] = conv2d_init(init, cin, cout, 1)
    return p


def _res_apply(p, x, temb):
    """ResnetBlock, temb added between the convs; GroupNorm eps 1e-6 and
    swish."""
    h = conv2d(p["conv1"], group_norm_silu(p["norm1"], x))
    if temb is not None:
        h = h + linear(p["temb_proj"], silu(temb))[:, None, None].to(h.dtype)
    h = conv2d(p["conv2"], group_norm_silu(p["norm2"], h))
    if "nin_shortcut" in p:
        x = conv2d(p["nin_shortcut"], x)
    return x + h


def _init_attn_any(init: Init, ch, attn_type):
    if attn_type == "vanilla":
        return init_spatial_self_attention(init, ch)
    if attn_type == "linear":
        return init_lin_attn_block(init, ch)
    return {}


def _attn_any(p, x, attn_type):
    if attn_type == "vanilla":
        return spatial_self_attention_apply(p, x)
    if attn_type == "linear":
        return lin_attn_block_apply(p, x)
    return x


def init_ddpm_model_params(cfg: DDPMModelConfig = DDPMModelConfig(), seed: int = 0,
                           device="cuda", dtype=torch.float32):
    """Seeded random parameters with the JAX tree's structure (the draws
    differ from JAX's)."""
    init = Init(seed, resolve_device(device), torch_dtype(dtype))
    temb_ch = cfg.ch * 4 if cfg.use_timestep else 0
    params = {"conv_in": conv2d_init(init, cfg.in_channels, cfg.ch, 3)}
    if cfg.use_timestep:
        params["temb"] = {"dense0": linear_init(init, cfg.ch, temb_ch),
                          "dense1": linear_init(init, temb_ch, temb_ch)}
    in_mult = (1,) + tuple(cfg.ch_mult)
    curr_res = cfg.resolution
    down = []
    for i, mult in enumerate(cfg.ch_mult):
        lvl = {"block": [], "attn": []}
        block_in, block_out = cfg.ch * in_mult[i], cfg.ch * mult
        for _ in range(cfg.num_res_blocks):
            lvl["block"].append(_init_res(init, block_in, block_out, temb_ch))
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                lvl["attn"].append(_init_attn_any(init, block_in, cfg.attn_type))
        if i != len(cfg.ch_mult) - 1:
            lvl["downsample"] = conv2d_init(init, block_in, block_in, 3)
            curr_res //= 2
        down.append(lvl)
    params["down"] = down
    params["mid"] = {"block_1": _init_res(init, block_in, block_in, temb_ch),
                     "attn_1": _init_attn_any(init, block_in, cfg.attn_type),
                     "block_2": _init_res(init, block_in, block_in, temb_ch)}
    up = [None] * len(cfg.ch_mult)
    for i in reversed(range(len(cfg.ch_mult))):
        lvl = {"block": [], "attn": []}
        block_out = skip_in = cfg.ch * cfg.ch_mult[i]
        for i_block in range(cfg.num_res_blocks + 1):
            if i_block == cfg.num_res_blocks:
                skip_in = cfg.ch * in_mult[i]
            lvl["block"].append(_init_res(init, block_in + skip_in, block_out, temb_ch))
            block_in = block_out
            if curr_res in cfg.attn_resolutions:
                lvl["attn"].append(_init_attn_any(init, block_in, cfg.attn_type))
        if i != 0:
            lvl["upsample"] = conv2d_init(init, block_in, block_in, 3)
            curr_res *= 2
        up[i] = lvl
    params["up"] = up
    params["norm_out"] = group_norm_init(init, block_in)
    params["conv_out"] = conv2d_init(init, block_in, cfg.out_ch, 3)
    return params


def ddpm_model_apply(params, x, t=None, context=None, cfg: DDPMModelConfig = DDPMModelConfig()):
    """x: (B, H, W, C) NHWC; ``context`` concatenates on the channels."""
    if context is not None:
        x = torch.cat([x, context], dim=-1)
    temb = None
    if cfg.use_timestep:
        temb = ddpm_timestep_embedding(t, cfg.ch)
        temb = linear(params["temb"]["dense1"], silu(linear(params["temb"]["dense0"], temb)))

    hs = [conv2d(params["conv_in"], x)]
    for lvl in params["down"]:
        for j, bp in enumerate(lvl["block"]):
            h = _res_apply(bp, hs[-1], temb)
            if lvl["attn"]:
                h = _attn_any(lvl["attn"][j], h, cfg.attn_type)
            hs.append(h)
        if "downsample" in lvl:  # VAE-style (0, 1) pad, stride 2
            hs.append(conv2d(lvl["downsample"], hs[-1], stride=2, padding=((0, 1), (0, 1))))

    h = _res_apply(params["mid"]["block_1"], hs[-1], temb)
    h = _attn_any(params["mid"]["attn_1"], h, cfg.attn_type)
    h = _res_apply(params["mid"]["block_2"], h, temb)

    for i in reversed(range(len(cfg.ch_mult))):
        lvl = params["up"][i]
        for j, bp in enumerate(lvl["block"]):
            h = _res_apply(bp, torch.cat([h, hs.pop()], dim=-1), temb)
            if lvl["attn"]:
                h = _attn_any(lvl["attn"][j], h, cfg.attn_type)
        if "upsample" in lvl:
            h = conv2d(lvl["upsample"], upsample_nearest_2x(h))
    return conv2d(params["conv_out"], group_norm_silu(params["norm_out"], h))


# ---------------------------------------------------------------------------
# distributions (distributions.py:13-21, 75-102)
# ---------------------------------------------------------------------------


def dirac_sample(value):
    """DiracDistribution: sample() == mode() == value."""
    return value


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N1 || N2) of diagonal Gaussians, broadcast."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))
