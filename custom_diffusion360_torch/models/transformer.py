"""Spatial transformer stack with FeatureNeRF pose conditioning (port of
custom_diffusion360_tpu/models/transformer.py, inference path).

Blocks at depth ``d % poscontrol_interval == 0`` of image-cross transformers
render a FeatureNeRF feature from precomputed reference tokens (delta-buffer
``ref_features``) or take it from the render cache (``nerf_cache``) and fuse
it into the stream through the identity-initialized ``pose_emb_layers``. The
live reference stream of training and log_images, and the x3 guider's render
dedupe, are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..geometry.cameras import Cameras
from ..ops.attention import dot_product_attention, dot_product_attention_qkv
from ..ops.volume_render import volume_render
from .nerf import NerfConfig, init_nerf_params, nerfsd_apply
from .nn import (
    Init,
    gelu,
    group_norm,
    group_norm_init,
    layer_norm,
    layer_norm_init,
    linear,
    linear_init,
    trunc_exp,
)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    dim: int
    depth: int
    n_heads: int
    d_head: int
    context_dim: int = 2048
    image_cross: bool = False
    poscontrol_interval: int = 4
    use_prev_weights_imp_sample: bool = True
    rgb_predict: bool = True
    add_lora: bool = False
    lora_rank: int = 32
    nerf: Optional[NerfConfig] = None

    def block_has_nerf(self, d: int) -> bool:
        return self.image_cross and (d % self.poscontrol_interval == 0)

    def block_imp_sample_next(self, d: int) -> bool:
        return (
            self.use_prev_weights_imp_sample
            and self.block_has_nerf(d)
            and self.depth >= self.poscontrol_interval
            and d < (self.depth // self.poscontrol_interval) * self.poscontrol_interval
        )


# ---------------------------------------------------------------------------
# attention / feedforward
# ---------------------------------------------------------------------------


def init_cross_attention(init: Init, query_dim, context_dim, n_heads, d_head,
                         add_lora=False, lora_rank=32):
    inner = n_heads * d_head
    p = {
        "to_q": linear_init(init, query_dim, inner, bias=False),
        "to_k": linear_init(init, context_dim, inner, bias=False),
        "to_v": linear_init(init, context_dim, inner, bias=False),
        "to_out": linear_init(init, inner, query_dim),
    }
    if add_lora:
        r = lora_rank
        p["lora"] = {
            "q_down": linear_init(init, query_dim, r, bias=False, std=1.0 / r),
            "q_up": linear_init(init, r, inner, bias=False, zero=True),
            "k_down": linear_init(init, context_dim, r, bias=False, std=1.0 / r),
            "k_up": linear_init(init, r, inner, bias=False, zero=True),
            "v_down": linear_init(init, context_dim, r, bias=False, std=1.0 / r),
            "v_up": linear_init(init, r, inner, bias=False, zero=True),
            "o_down": linear_init(init, inner, r, bias=False, std=1.0 / r),
            "o_up": linear_init(init, r, query_dim, bias=False, zero=True),
        }
    return p


def context_kv(p, ctx):
    """Cross-attention K/V for a fixed context (B, M, Cc) -> (k, v), each
    (B, M, inner); hoists the text projections out of the sampler loop."""
    if "to_kv" in p:
        k, v = linear(p["to_kv"], ctx).chunk(2, dim=-1)
    else:
        k = linear(p["to_k"], ctx)
        v = linear(p["to_v"], ctx)
    if "lora" in p:
        lp = p["lora"]
        k = k + linear(lp["k_up"], linear(lp["k_down"], ctx))
        v = v + linear(lp["v_up"], linear(lp["v_down"], ctx))
    return k, v


def cross_attention_apply(p, x, context=None, *, n_heads: int, kv=None):
    """x: (B, N, C); context: (B, M, Cc) or None (self-attention). Takes the
    canonical params (to_q/to_k/to_v) or the fused inference layout of
    :func:`fuse_attention_params` (to_qkv, to_q + to_kv); kv: precomputed
    (k, v) from :func:`context_kv`."""
    ctx = x if context is None else context
    if kv is not None:
        q = linear(p["to_q"], x)
        k, v = kv
        if "lora" in p:
            lp = p["lora"]
            q = q + linear(lp["q_up"], linear(lp["q_down"], x))
    elif context is None and "to_qkv" in p:
        if "lora" not in p:
            out = dot_product_attention_qkv(linear(p["to_qkv"], x), n_heads)
            return linear(p["to_out"], out)
        q, k, v = linear(p["to_qkv"], x).chunk(3, dim=-1)
    elif context is not None and "to_kv" in p:
        q = linear(p["to_q"], x)
        k, v = linear(p["to_kv"], ctx).chunk(2, dim=-1)
    else:
        q = linear(p["to_q"], x)
        k = linear(p["to_k"], ctx)
        v = linear(p["to_v"], ctx)
    if kv is None and "lora" in p:
        lp = p["lora"]
        q = q + linear(lp["q_up"], linear(lp["q_down"], x))
        k = k + linear(lp["k_up"], linear(lp["k_down"], ctx))
        v = v + linear(lp["v_up"], linear(lp["v_down"], ctx))
    b, n, inner = q.shape
    d_head = inner // n_heads
    q = q.reshape(b, n, n_heads, d_head)
    k = k.reshape(b, k.shape[1], n_heads, d_head)
    v = v.reshape(b, v.shape[1], n_heads, d_head)
    out = dot_product_attention(q, k, v).reshape(b, n, inner)
    final = linear(p["to_out"], out)
    if "lora" in p:
        final = final + linear(p["lora"]["o_up"], linear(p["lora"]["o_down"], out))
    return final


def fuse_attention_params(params):
    """Params tree with q/k/v projections fused for inference: every
    transformer block's attn1 gets ``to_qkv`` = [wq | wk | wv] and attn2
    ``to_kv`` = [wk | wv]; LoRA adapters are merged first (W + down @ up).
    Returns a new tree; the input is not modified."""
    def merge_lora(attn):
        if "lora" not in attn:
            return attn
        a = dict(attn)
        lp = a.pop("lora")

        def merged(base, down, up):
            return dict(base, w=base["w"] + lp[down]["w"] @ lp[up]["w"])

        a["to_q"] = merged(a["to_q"], "q_down", "q_up")
        a["to_k"] = merged(a["to_k"], "k_down", "k_up")
        a["to_v"] = merged(a["to_v"], "v_down", "v_up")
        a["to_out"] = merged(a["to_out"], "o_down", "o_up")
        return a

    def fuse_block(blk):
        out = dict(blk)
        a1 = blk.get("attn1")
        if isinstance(a1, dict) and "to_q" in a1:
            a1 = merge_lora(dict(a1))
            w = torch.cat([a1.pop("to_q")["w"], a1.pop("to_k")["w"],
                           a1.pop("to_v")["w"]], dim=1)
            a1["to_qkv"] = {"w": w}
            out["attn1"] = a1
        a2 = blk.get("attn2")
        if isinstance(a2, dict) and "to_k" in a2:
            a2 = merge_lora(dict(a2))
            w = torch.cat([a2.pop("to_k")["w"], a2.pop("to_v")["w"]], dim=1)
            a2["to_kv"] = {"w": w}
            out["attn2"] = a2
        return out

    def walk(node):
        if isinstance(node, dict):
            if "attn1" in node and "attn2" in node:
                node = fuse_block(node)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


def init_feedforward(init: Init, dim, mult=4):
    inner = dim * mult
    return {"proj": linear_init(init, dim, inner * 2),  # GEGLU
            "out": linear_init(init, inner, dim)}


def feedforward_apply(p, x):
    a, gate = linear(p["proj"], x).chunk(2, dim=-1)
    return linear(p["out"], a * gelu(gate))


# ---------------------------------------------------------------------------
# transformer block
# ---------------------------------------------------------------------------


def init_transformer_block(init: Init, cfg: TransformerConfig, d: int):
    lora = cfg.add_lora and cfg.block_has_nerf(d)
    p = {
        "attn1": init_cross_attention(init, cfg.dim, cfg.dim, cfg.n_heads,
                                      cfg.d_head, lora, cfg.lora_rank),
        "attn2": init_cross_attention(init, cfg.dim, cfg.context_dim, cfg.n_heads,
                                      cfg.d_head, lora, cfg.lora_rank),
        "ff": init_feedforward(init, cfg.dim),
        "norm1": layer_norm_init(init, cfg.dim),
        "norm2": layer_norm_init(init, cfg.dim),
        "norm3": layer_norm_init(init, cfg.dim),
    }
    if cfg.block_has_nerf(d):
        p["pose_emb_layers"] = linear_init(init, 2 * cfg.dim, cfg.dim, bias=False, eye=True)
        p["pose_featurenerf"] = init_nerf_params(init, cfg.nerf)
    return p


def _reference_attn(p, cams, context_ref, context, prev_weights,
                    cfg: TransformerConfig, d: int):
    """NeRF render + text cross-attention on the per-point features + volume
    render. Returns (rendered (B, hw, C) f32, fg_mask, prev_weights, alphas,
    rgb)."""
    nerf_out = nerfsd_apply(
        p["pose_featurenerf"], cams, context_ref, cfg.nerf,
        prev_weights=prev_weights if cfg.use_prev_weights_imp_sample else None,
        imp_sample_next_step=cfg.block_imp_sample_next(d),
    )
    cdt = cfg.nerf.cdtype
    feats = nerf_out["features"]  # (B, hw, S, C) f32
    b, hw, s, c = feats.shape
    feats = feats.reshape(b, hw * s, c)
    feats = feats + cross_attention_apply(
        p["attn2"], layer_norm(p["norm2"], feats.to(cdt)), context.to(cdt),
        n_heads=cfg.n_heads,
    ).float()
    feats = feats.reshape(b, hw, s, c)
    sigma = trunc_exp(nerf_out["sigma"])
    sigma_uniform = (trunc_exp(nerf_out["sigma_uniform"])
                     if nerf_out["sigma_uniform"] is not None else None)
    rgb = torch.sigmoid(nerf_out["rgb"]) if nerf_out["rgb"] is not None else None
    rendered = volume_render(feats, sigma, nerf_out["dists"], rgb=rgb,
                             densities_uniform=sigma_uniform,
                             dists_uniform=nerf_out["dists_uniform"])
    new_prev = rendered["weights_uniform"] if cfg.use_prev_weights_imp_sample else None
    return (rendered["feats"], rendered["fg_mask"], new_prev, rendered["alphas"],
            rendered["rgb"])


def transformer_block_apply(p, x, context, cfg: TransformerConfig, d: int, *,
                            context_ref=None, cams: Optional[Cameras] = None,
                            prev_weights=None, nerf_cache=None, ctx_kv=None):
    """One BasicTransformerBlock step. x: (B, hw, C). context_ref: reference
    tokens for the render (CompactRefTokens); nerf_cache: a
    rendered feature (B, hw, C) replacing the render; ctx_kv: precomputed
    text (k, v). Returns (x, aux) with aux = dict(fg_mask, prev_weights,
    alphas, rgb, rendered)."""
    x = cross_attention_apply(p["attn1"], layer_norm(p["norm1"], x), None,
                              n_heads=cfg.n_heads) + x
    x = cross_attention_apply(p["attn2"], layer_norm(p["norm2"], x), context,
                              n_heads=cfg.n_heads, kv=ctx_kv) + x

    aux = dict(fg_mask=None, prev_weights=prev_weights, alphas=None, rgb=None,
               rendered=None)
    if "pose_emb_layers" in p and (context_ref is not None or nerf_cache is not None):
        xf = x.float()  # f32 island (reference attention.py:626)
        if nerf_cache is not None:
            rendered = nerf_cache
        else:
            rendered, fg_mask, new_prev, alphas, rgb = _reference_attn(
                p, cams, context_ref, context.float(), prev_weights, cfg, d,
            )
            aux.update(fg_mask=fg_mask, prev_weights=new_prev, alphas=alphas,
                       rgb=rgb, rendered=rendered)
        c = xf.shape[-1]
        w = p["pose_emb_layers"]["w"].float()
        x = (xf @ w[:c] + rendered.float() @ w[c:]).to(x.dtype)

    x = feedforward_apply(p["ff"], layer_norm(p["norm3"], x)) + x
    return x, aux


# ---------------------------------------------------------------------------
# spatial transformer
# ---------------------------------------------------------------------------


def init_spatial_transformer(init: Init, in_channels: int, cfg: TransformerConfig):
    inner = cfg.n_heads * cfg.d_head
    return {
        "norm": group_norm_init(init, in_channels),
        "proj_in": linear_init(init, in_channels, inner),
        "blocks": [init_transformer_block(init, cfg, d) for d in range(cfg.depth)],
        "proj_out": linear_init(init, inner, in_channels, zero=True),
    }


def spatial_transformer_apply(p, x, context, cfg: TransformerConfig, *,
                              cams: Optional[Cameras] = None, nerf_cache=None,
                              ref_features=None, ctx_kv=None):
    """x: (B, H, W, C) NHWC. ref_features: {d: reference tokens} for the
    render; nerf_cache: {d: rendered feats}; ctx_kv: per-depth text (k, v).
    Returns (x, aux) with aux = dict(fg_masks, alphas, rgbs, rendered)."""
    b, h, w, c = x.shape
    x_in = x
    x = group_norm(p["norm"], x).reshape(b, h * w, c)
    x = linear(p["proj_in"], x)

    prev_weights = None
    fg_masks, alphas_list, rgbs, rendered_out = [], [], [], {}
    for d in range(cfg.depth):
        blk = p["blocks"][d]
        kv = None if ctx_kv is None else ctx_kv[d]
        refs = None if ref_features is None else ref_features.get(d)
        cache = None if nerf_cache is None else nerf_cache.get(d)
        if cfg.block_has_nerf(d) and (refs is not None or cache is not None):
            x, aux = transformer_block_apply(
                blk, x, context, cfg, d, context_ref=refs, cams=cams,
                prev_weights=prev_weights, nerf_cache=cache, ctx_kv=kv,
            )
            prev_weights = aux["prev_weights"]
            if aux["fg_mask"] is not None:
                fg_masks.append(aux["fg_mask"])
            if aux["alphas"] is not None:
                alphas_list.append(aux["alphas"])
            if aux["rgb"] is not None:
                rgbs.append(aux["rgb"])
            if aux["rendered"] is not None:
                rendered_out[d] = aux["rendered"]
        else:
            x, _ = transformer_block_apply(blk, x, context, cfg, d, ctx_kv=kv)

    x = linear(p["proj_out"], x).reshape(b, h, w, c) + x_in
    return x, dict(fg_masks=fg_masks, alphas=alphas_list, rgbs=rgbs,
                   rendered=rendered_out)
