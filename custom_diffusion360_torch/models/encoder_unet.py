"""Half-UNet encoder / classifier (EncoderUNetModel) and its attention pieces
(port of custom_diffusion360_tpu/models/encoder_unet.py; sgm
openaimodel.py: EncoderUNetModel, AttentionBlock, QKVAttention(Legacy),
AttentionPool2d), e.g. the noisy classifier of classifier guidance.

NHWC activations, (in, out) linear weights; the qkv projections keep the
reference's channel orders (head-major for the legacy order, qkv-major for
the new one), so torch checkpoints map weight for weight. The attention is
plain PyTorch, as the JAX package's plain einsums: q and k each scaled by
ch^-1/4 in the activation dtype, f32 scores and softmax. The GroupNorms
(eps 1e-5 in the attention blocks and heads) run the GroupNorm kernel on
the card; the ResBlocks are the UNet's (``unet._resblock_apply``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from .. import resolve_device
from .nn import (
    Init,
    conv2d,
    conv2d_init,
    group_norm,
    group_norm_init,
    group_norm_silu,
    linear,
    linear_init,
    silu,
    timestep_embedding,
    torch_dtype,
)
from .unet import _init_resblock, _resblock_apply

# ---------------------------------------------------------------------------
# qkv attention, both channel orders (openaimodel.py:450-513)
# ---------------------------------------------------------------------------


def qkv_attention(qkv, n_heads: int, legacy: bool = True):
    """qkv: (B, T, 3 H ch) -> (B, T, H ch). legacy: channels ordered
    [h, (q k v), ch] (QKVAttentionLegacy); else [(q k v), h, ch]
    (QKVAttention)."""
    b, t, width = qkv.shape
    ch = width // (3 * n_heads)
    if legacy:
        parts = qkv.reshape(b, t, n_heads, 3, ch)
        q, k, v = parts[:, :, :, 0], parts[:, :, :, 1], parts[:, :, :, 2]
    else:
        parts = qkv.reshape(b, t, 3, n_heads, ch)
        q, k, v = parts[:, :, 0], parts[:, :, 1], parts[:, :, 2]
    scale = 1.0 / math.sqrt(math.sqrt(ch))
    w = torch.einsum("bthc,bshc->bhts", (q * scale).float(), (k * scale).float())
    w = torch.softmax(w, dim=-1).to(qkv.dtype)
    return torch.einsum("bhts,bshc->bthc", w, v).reshape(b, t, n_heads * ch)


def _heads(channels, num_heads, num_head_channels):
    if num_head_channels == -1:
        return num_heads
    if channels % num_head_channels:
        raise ValueError(f"{channels} channels do not split into heads of {num_head_channels}")
    return channels // num_head_channels


def attention_block_init(init: Init, channels: int):
    return {
        "norm": group_norm_init(init, channels),
        "qkv": linear_init(init, channels, 3 * channels),
        "proj_out": linear_init(init, channels, channels, zero=True),
    }


def attention_block_apply(p, x, num_heads: int = 1, num_head_channels: int = -1,
                          use_new_attention_order: bool = False):
    """x: (B, H, W, C) -> the same; residual self-attention over the H W
    tokens (AttentionBlock: its 1x1 convs are linears on the tokens, its
    GroupNorm runs on the (B, T, C) tokens)."""
    b, h, w, c = x.shape
    heads = _heads(c, num_heads, num_head_channels)
    tokens = x.reshape(b, h * w, c)
    qkv = linear(p["qkv"], group_norm(p["norm"], tokens, eps=1e-5))
    a = qkv_attention(qkv, heads, legacy=not use_new_attention_order)
    return (tokens + linear(p["proj_out"], a)).reshape(b, h, w, c)


def attention_pool2d_init(init: Init, spacial_dim: int, embed_dim: int, output_dim=None):
    return {
        # (tokens, C) channels-last; the reference keeps (C, HW + 1)
        "pos": init.normal((spacial_dim ** 2 + 1, embed_dim), embed_dim ** -0.5),
        "qkv": linear_init(init, embed_dim, 3 * embed_dim),
        "proj": linear_init(init, embed_dim, output_dim or embed_dim),
    }


def attention_pool2d_apply(p, x, num_heads_channels: int):
    """x: (B, H, W, C) -> (B, out_dim): CLIP-style attention pooling from a
    prepended mean token (AttentionPool2d, new qkv order)."""
    b, h, w, c = x.shape
    tokens = x.reshape(b, h * w, c)
    tokens = torch.cat([tokens.mean(dim=1, keepdim=True), tokens], dim=1)
    tokens = tokens + p["pos"].to(tokens.dtype)
    a = qkv_attention(linear(p["qkv"], tokens), c // num_heads_channels, legacy=False)
    return linear(p["proj"], a)[:, 0]


# ---------------------------------------------------------------------------
# EncoderUNetModel (openaimodel.py:1102-1304)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EncoderUNetConfig:
    image_size: int = 64
    in_channels: int = 4
    model_channels: int = 64
    out_channels: int = 10
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2)  # downsampling factors, as the JAX config
    channel_mult: Tuple[int, ...] = (1, 2, 4, 8)
    num_heads: int = 1
    num_head_channels: int = -1
    use_new_attention_order: bool = False
    pool: str = "adaptive"  # adaptive | attention | spatial | spatial_v2


def _build_spec(cfg: EncoderUNetConfig):
    """The constructor loop's layout: (blocks, middle channels, final
    downsampling factor, spatial feature width); a block lists ("conv_in",
    in, out), ("res", in, out), ("attn", ch) and ("down", ch) layers."""
    blocks = [[("conv_in", cfg.in_channels, cfg.model_channels)]]
    feature_size = ch = cfg.model_channels
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            layers = [("res", ch, mult * cfg.model_channels)]
            ch = mult * cfg.model_channels
            if ds in cfg.attention_resolutions:
                layers.append(("attn", ch))
            blocks.append(layers)
            feature_size += ch
        if level != len(cfg.channel_mult) - 1:
            blocks.append([("down", ch)])
            ds *= 2
            feature_size += ch
    return blocks, ch, ds, feature_size + ch  # + the middle block


def init_encoder_unet_params(cfg: EncoderUNetConfig = EncoderUNetConfig(), seed: int = 0,
                             device="cuda", dtype=torch.float32):
    """Seeded random parameters with the JAX tree's structure (the draws
    differ from JAX's)."""
    init = Init(seed, resolve_device(device), torch_dtype(dtype))
    blocks, mid_ch, ds, feature_size = _build_spec(cfg)
    emb_dim = cfg.model_channels * 4
    params = {
        "time_embed": {"l1": linear_init(init, cfg.model_channels, emb_dim),
                       "l2": linear_init(init, emb_dim, emb_dim)},
        "middle_block": [_init_resblock(init, mid_ch, mid_ch, emb_dim),
                         attention_block_init(init, mid_ch),
                         _init_resblock(init, mid_ch, mid_ch, emb_dim)],
        "input_blocks": [],
    }
    for block in blocks:
        bp = []
        for spec in block:
            if spec[0] == "conv_in":
                bp.append(conv2d_init(init, spec[1], spec[2], 3))
            elif spec[0] == "res":
                bp.append(_init_resblock(init, spec[1], spec[2], emb_dim))
            elif spec[0] == "attn":
                bp.append(attention_block_init(init, spec[1]))
            else:  # down: the stride-2 conv
                bp.append(conv2d_init(init, spec[1], spec[1], 3))
        params["input_blocks"].append(bp)

    if cfg.pool == "adaptive":
        params["out"] = {"norm": group_norm_init(init, mid_ch),
                         "conv": conv2d_init(init, mid_ch, cfg.out_channels, 1, zero=True)}
    elif cfg.pool == "attention":
        if cfg.num_head_channels == -1:
            raise ValueError("attention pooling needs num_head_channels")
        params["out"] = {"norm": group_norm_init(init, mid_ch),
                         "pool": attention_pool2d_init(init, cfg.image_size // ds, mid_ch,
                                                       cfg.out_channels)}
    elif cfg.pool in ("spatial", "spatial_v2"):
        params["out"] = {"l1": linear_init(init, feature_size, 2048),
                         "l2": linear_init(init, 2048, cfg.out_channels)}
        if cfg.pool == "spatial_v2":
            params["out"]["norm"] = group_norm_init(init, 2048)
    else:
        raise NotImplementedError(f"Unexpected {cfg.pool} pooling")
    return params


def encoder_unet_apply(params, x, timesteps, cfg: EncoderUNetConfig = EncoderUNetConfig()):
    """x: (B, H, W, Cin) NHWC, timesteps (B,) -> (B, out_channels)
    (EncoderUNetModel.forward)."""
    blocks, _, _, _ = _build_spec(cfg)
    te = params["time_embed"]
    emb = linear(te["l2"], silu(linear(te["l1"], timestep_embedding(timesteps,
                                                                     cfg.model_channels))))
    spatial = cfg.pool.startswith("spatial")
    results = []
    h = x
    for block, bp in zip(blocks, params["input_blocks"]):
        for spec, p in zip(block, bp):
            if spec[0] == "conv_in":
                h = conv2d(p, h)
            elif spec[0] == "res":
                h = _resblock_apply(p, h, emb)
            elif spec[0] == "attn":
                h = attention_block_apply(p, h, cfg.num_heads, cfg.num_head_channels,
                                          cfg.use_new_attention_order)
            else:  # torch Downsample: stride 2, padding 1 on both sides (not XLA SAME)
                h = conv2d(p, h, stride=2, padding=((1, 1), (1, 1)))
        if spatial:
            results.append(h.mean(dim=(1, 2)))
    mid = params["middle_block"]
    h = _resblock_apply(mid[0], h, emb)
    h = attention_block_apply(mid[1], h, cfg.num_heads, cfg.num_head_channels,
                              cfg.use_new_attention_order)
    h = _resblock_apply(mid[2], h, emb)

    out = params["out"]
    if cfg.pool == "adaptive":
        h = group_norm_silu(out["norm"], h, eps=1e-5).mean(dim=(1, 2), keepdim=True)
        return conv2d(out["conv"], h).reshape(h.shape[0], -1)
    if cfg.pool == "attention":
        h = group_norm_silu(out["norm"], h, eps=1e-5)
        return attention_pool2d_apply(out["pool"], h, cfg.num_head_channels)
    results.append(h.mean(dim=(1, 2)))
    h = torch.cat(results, dim=-1)
    if cfg.pool == "spatial":
        return linear(out["l2"], torch.relu(linear(out["l1"], h)))
    # spatial_v2: Linear -> GroupNorm32(2048) -> SiLU -> Linear
    h = linear(out["l1"], h)
    h = silu(group_norm(out["norm"], h[:, None, :], eps=1e-5)[:, 0])
    return linear(out["l2"], h)
