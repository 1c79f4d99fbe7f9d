"""Spatial transformer stack with FeatureNeRF pose conditioning (port of
custom_diffusion360_tpu/models/transformer.py).

Blocks at depth ``d % poscontrol_interval == 0`` of image-cross transformers
render a FeatureNeRF feature and fuse it into the stream through the
identity-initialized ``pose_emb_layers``. The render reads precomputed
reference tokens (delta-buffer ``ref_features``, sampling), the render cache
(``nerf_cache``), or, in training, the dense tokens of the live reference
stream ``xr``: the reference views run the same frozen weights in lockstep,
without gradient (``torch.no_grad``, where the JAX package stop-gradients
them), and each pose block renders from the reference activations that
enter it. Training uses the canonical un-fused q/k/v projections.

Tensor parallelism (``parallel/tp.py``): with local slices of the
projections (``shard_params_tp``) inside ``tensor_parallel(group)``, every
attention runs on its local heads (its width / d_head) and every to_out and
ff out ends with an all-reduce over the model group, in float32, the bias
in the first rank's partial product. A projection is split when its local width times the group size is the
full one (heads x d_head, or 4 x dim for the feed-forward).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from ..geometry.cameras import Cameras
from ..ops.attention import dot_product_attention, dot_product_attention_qkv
from ..ops.volume_render import volume_render
from ..parallel import tp
from .nerf import CompactRefTokens, NerfConfig, init_nerf_params, nerfsd_apply
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


def _row_linear(p, x, split: bool):
    """A row-parallel product: split, the bias in the model group's first
    partial product, the partial products summed in float32 and rounded
    once to x's dtype. In a group of one it is ``linear`` bit for bit."""
    if not split:
        return linear(p, x)
    q = {"w": p["w"]}
    if "b" in p:
        q["b"] = tp.bias_on_first(p["b"])
    y = linear(q, x)
    return tp.reduce_from_model(y.float()).to(y.dtype)


def cross_attention_apply(p, x, context=None, *, n_heads: int, kv=None,
                          d_head: Optional[int] = None):
    """x: (B, N, C); context: (B, M, Cc) or None (self-attention). Takes the
    canonical params (to_q/to_k/to_v) or the fused inference layout of
    :func:`fuse_attention_params` (to_qkv, to_q + to_kv); kv: precomputed
    (k, v) from :func:`context_kv`. ``n_heads`` x ``d_head`` is the full
    width (d_head defaults to the local width / n_heads); local
    tensor-parallel slices run width / d_head heads."""
    inner = p["to_out"]["w"].shape[0]
    d_head = inner // n_heads if d_head is None else d_head
    split = tp.is_split(inner, n_heads * d_head)
    heads = inner // d_head
    if split:
        x = tp.copy_to_model(x)
        context = None if context is None else tp.copy_to_model(context)
    ctx = x if context is None else context
    if kv is not None:
        q = linear(p["to_q"], x)
        k, v = kv
        if "lora" in p:
            lp = p["lora"]
            q = q + linear(lp["q_up"], linear(lp["q_down"], x))
    elif context is None and "to_qkv" in p:
        if "lora" not in p:
            out = dot_product_attention_qkv(linear(p["to_qkv"], x), heads)
            return _row_linear(p["to_out"], out, split)
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
    b, n, _ = q.shape
    q = q.reshape(b, n, heads, d_head)
    k = k.reshape(b, k.shape[1], heads, d_head)
    v = v.reshape(b, v.shape[1], heads, d_head)
    out = dot_product_attention(q, k, v).reshape(b, n, inner)
    final = _row_linear(p["to_out"], out, split)
    if "lora" in p:
        final = final + linear(p["lora"]["o_up"], linear(p["lora"]["o_down"], out))
    return final


def _cat_into(buffers: dict, path, parts):
    """torch.cat(parts, dim=1), written into ``buffers[path]`` where that
    holds a tensor of the result's shape, dtype and device, else made anew
    and kept there."""
    shape = (parts[0].shape[0], sum(p.shape[1] for p in parts))
    buf = buffers.get(path)
    if (buf is not None and tuple(buf.shape) == shape and buf.dtype == parts[0].dtype
            and buf.device == parts[0].device):
        return torch.cat(parts, dim=1, out=buf)
    buffers[path] = out = torch.cat(parts, dim=1)
    return out


def fuse_attention_params(params, buffers: Optional[dict] = None):
    """Params tree with q/k/v projections fused for inference: every
    transformer block's attn1 gets ``to_qkv`` = [wq | wk | wv] and attn2
    ``to_kv`` = [wk | wv]; LoRA adapters are merged first (W + down @ up).
    Returns a new tree; the input is not modified.

    ``buffers``: a dict {path: tensor} of the leaves that an earlier call
    made. Each made leaf is written into its buffer where shape, dtype and
    device match, else made anew and kept there: so the fused weights keep
    their addresses from call to call (the cached UNet's CUDA graphs read
    them there, ``models/unet_graphs.py``) while carrying the values the
    source leaves hold now."""
    buffers = {} if buffers is None else buffers

    def merge_lora(attn, path):
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
        a["to_out"]["w"] = _cat_into(buffers, path + ("to_out", "w"), [a["to_out"]["w"]])
        return a

    def fuse_block(blk, path):
        out = dict(blk)
        a1 = blk.get("attn1")
        if isinstance(a1, dict) and "to_q" in a1:
            a1 = merge_lora(dict(a1), path + ("attn1",))
            w = _cat_into(buffers, path + ("attn1", "to_qkv", "w"),
                          [a1.pop("to_q")["w"], a1.pop("to_k")["w"], a1.pop("to_v")["w"]])
            a1["to_qkv"] = {"w": w}
            out["attn1"] = a1
        a2 = blk.get("attn2")
        if isinstance(a2, dict) and "to_k" in a2:
            a2 = merge_lora(dict(a2), path + ("attn2",))
            w = _cat_into(buffers, path + ("attn2", "to_kv", "w"),
                          [a2.pop("to_k")["w"], a2.pop("to_v")["w"]])
            a2["to_kv"] = {"w": w}
            out["attn2"] = a2
        return out

    def walk(node, path):
        if isinstance(node, dict):
            if "attn1" in node and "attn2" in node:
                node = fuse_block(node, path)
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return node

    return walk(params, ())


FF_MULT = 4  # the feed-forward's inner width over dim


def init_feedforward(init: Init, dim, mult=FF_MULT):
    inner = dim * mult
    return {"proj": linear_init(init, dim, inner * 2),  # GEGLU
            "out": linear_init(init, inner, dim)}


def feedforward_apply(p, x):
    """GEGLU feed-forward; proj is [a | gate] (locally [a_r | gate_r] under
    tensor parallelism)."""
    split = tp.is_split(p["out"]["w"].shape[0], FF_MULT * x.shape[-1])
    if split:
        x = tp.copy_to_model(x)
    a, gate = linear(p["proj"], x).chunk(2, dim=-1)
    return _row_linear(p["out"], a * gelu(gate), split)


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
                    cfg: TransformerConfig, d: int, mask_ref=None, draws=None):
    """NeRF render + text cross-attention on the per-point features + volume
    render. Returns (rendered (B, hw, C) f32, fg_mask, prev_weights, alphas,
    rgb).

    The x3 render dedupe (``CD360_CFG3_DEDUPE``, on unless "0"): under the
    x3 guider the reference rows are [zero | chosen | chosen], so with the
    target cameras declared shared across the copies (CompactRefTokens
    ``shared_cams``) copies 1 and 2 are identical through the ray-march and
    the encode. The encode then runs on the two unique copies; their
    per-point features are attended and rendered under the uc context (rows
    0 and 1), the chosen rows again under the c context (row 2), and the
    rendered outputs are concatenated. Only at inference, with compact
    tokens, three copies, no ``mask_ref`` and neither rows nor views
    sharded (as the JAX package keeps it off under ``ref_sharding``).
    """
    dd_b = 0
    if (isinstance(context_ref, CompactRefTokens) and context_ref.copies == 3
            and context_ref.shared_cams and context_ref.rows is None
            and context_ref.views is None and mask_ref is None and draws is None
            and os.environ.get("CD360_CFG3_DEDUPE", "1") != "0"):
        dd_b = context_ref.batch
        context_ref = CompactRefTokens(context_ref.zero, context_ref.chosen, dd_b, 2)
        cams = cams[: 2 * dd_b]
        if prev_weights is not None:
            prev_weights = prev_weights[: 2 * dd_b]
    nerf_out = nerfsd_apply(
        p["pose_featurenerf"], cams, context_ref, cfg.nerf,
        prev_weights=prev_weights if cfg.use_prev_weights_imp_sample else None,
        imp_sample_next_step=cfg.block_imp_sample_next(d), mask_ref=mask_ref, draws=draws,
    )
    cdt = cfg.nerf.cdtype

    def finish(nout, context):
        feats = nout["features"]  # (B, hw, S, C) f32
        b, hw, s, c = feats.shape
        feats = feats.reshape(b, hw * s, c)
        feats = feats + cross_attention_apply(
            p["attn2"], layer_norm(p["norm2"], feats.to(cdt)), context.to(cdt),
            n_heads=cfg.n_heads, d_head=cfg.d_head,
        ).float()
        feats = feats.reshape(b, hw, s, c)
        sigma = trunc_exp(nout["sigma"])
        sigma_uniform = (trunc_exp(nout["sigma_uniform"])
                         if nout["sigma_uniform"] is not None else None)
        rgb = torch.sigmoid(nout["rgb"]) if nout["rgb"] is not None else None
        rendered = volume_render(feats, sigma, nout["dists"], rgb=rgb,
                                 densities_uniform=sigma_uniform,
                                 dists_uniform=nout["dists_uniform"])
        new_prev = rendered["weights_uniform"] if cfg.use_prev_weights_imp_sample else None
        return (rendered["feats"], rendered["fg_mask"], new_prev, rendered["alphas"],
                rendered["rgb"])

    if not dd_b:
        return finish(nerf_out, context)
    chosen = {k: v[dd_b: 2 * dd_b] if isinstance(v, torch.Tensor) else v
              for k, v in nerf_out.items()}
    out_a = finish(nerf_out, context[: 2 * dd_b])
    out_b = finish(chosen, context[2 * dd_b:])
    return tuple(None if ta is None else torch.cat([ta, tb]) for ta, tb in zip(out_a, out_b))


def transformer_block_apply(p, x, context, cfg: TransformerConfig, d: int, *,
                            context_ref=None, cams: Optional[Cameras] = None,
                            prev_weights=None, nerf_cache=None, ctx_kv=None,
                            mask_ref=None, draws=None):
    """One BasicTransformerBlock step. x: (B, hw, C). context_ref: reference
    tokens for the render (CompactRefTokens, or dense (B, N, hw, C) from the
    reference stream, masked by ``mask_ref``); nerf_cache: a rendered
    feature (B, hw, C) replacing the render; ctx_kv: precomputed text (k,
    v); draws: the render's training draws. Returns (x, aux) with aux =
    dict(fg_mask, prev_weights, alphas, rgb, rendered)."""
    x = cross_attention_apply(p["attn1"], layer_norm(p["norm1"], x), None,
                              n_heads=cfg.n_heads, d_head=cfg.d_head) + x
    x = cross_attention_apply(p["attn2"], layer_norm(p["norm2"], x), context,
                              n_heads=cfg.n_heads, kv=ctx_kv, d_head=cfg.d_head) + x

    aux = dict(fg_mask=None, prev_weights=prev_weights, alphas=None, rgb=None,
               rendered=None)
    if "pose_emb_layers" in p and (context_ref is not None or nerf_cache is not None):
        xf = x.float()  # f32 island (reference attention.py:626)
        if nerf_cache is not None:
            rendered = nerf_cache
        else:
            rendered, fg_mask, new_prev, alphas, rgb = _reference_attn(
                p, cams, context_ref, context.float(), prev_weights, cfg, d,
                mask_ref=mask_ref, draws=draws,
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
                              ref_features=None, ctx_kv=None, xr=None,
                              context_ref=None, mask_ref=None, draws=None):
    """x: (B, H, W, C) NHWC. ref_features: {d: reference tokens} for the
    render; nerf_cache: {d: rendered feats}; ctx_kv: per-depth text (k, v).
    Training: xr (B * Nref, H, W, C), the reference stream, run under
    torch.no_grad with its text context ``context_ref`` (B * Nref, M, Cc);
    each pose block at depth d renders from its dense tokens with the
    per-row ``mask_ref`` and the draws ``draws.child(str(d))``.
    Returns (x, xr or None, aux) with aux = dict(fg_masks, alphas, rgbs,
    rendered, ref_tokens), ref_tokens {d: (B, Nref, hw, C)} the reference
    stream's tokens each pose block rendered from (training and capture)."""
    b, h, w, c = x.shape
    x_in = x
    x = group_norm(p["norm"], x).reshape(b, h * w, c)
    x = linear(p["proj_in"], x)
    if xr is not None:
        xr_in = xr
        br = xr.shape[0]
        with torch.no_grad():
            xr = linear(p["proj_in"], group_norm(p["norm"], xr).reshape(br, h * w, c))

    prev_weights = None
    fg_masks, alphas_list, rgbs, rendered_out, ref_tokens_out = [], [], [], {}, {}
    for d in range(cfg.depth):
        blk = p["blocks"][d]
        kv = None if ctx_kv is None else ctx_kv[d]
        if xr is not None:
            with torch.no_grad():
                xr, _ = transformer_block_apply(blk, xr, context_ref, cfg, d)
        refs = None if ref_features is None else ref_features.get(d)
        if xr is not None and cfg.block_has_nerf(d):
            refs = xr.reshape(b, br // b, h * w, -1)
            ref_tokens_out[d] = refs
        cache = None if nerf_cache is None else nerf_cache.get(d)
        if cfg.block_has_nerf(d) and (refs is not None or cache is not None):
            x, aux = transformer_block_apply(
                blk, x, context, cfg, d, context_ref=refs, cams=cams,
                prev_weights=prev_weights, nerf_cache=cache, ctx_kv=kv,
                mask_ref=mask_ref, draws=None if draws is None else draws.child(str(d)),
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
    if xr is not None:
        with torch.no_grad():
            xr = linear(p["proj_out"], xr).reshape(br, h, w, c) + xr_in
    return x, xr, dict(fg_masks=fg_masks, alphas=alphas_list, rgbs=rgbs,
                       rendered=rendered_out, ref_tokens=ref_tokens_out)
