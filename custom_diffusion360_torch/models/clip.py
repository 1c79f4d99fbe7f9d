"""CLIP text towers (SDXL's two text encoders) with V* modifier-token rows,
and the CLIP vision tower (port of custom_diffusion360_tpu/models/clip.py).

One pre-LN causal transformer serves both towers; the configs differ in
width, depth and activation, and in which output the conditioner reads:
CLIP-L's ``final`` (all layers + ln_final) and bigG's ``penultimate``
hidden state plus ``pooled`` = ln_final(last)[eot] @ text_projection.
Token ids at or above ``vocab_size`` index the ``modifier_rows`` (the V*
tokens, the only trainable rows: the embedding table stays frozen).

Layer parameters are stacked along a leading layer axis, as the JAX tree
holds them for ``lax.scan``, so a JAX tree carries across unchanged; the
layers run as a Python loop over that axis. Activations follow the
parameters' dtype; the 77-token attention is plain PyTorch with f32 logits.

The vision tower (open_clip's ViT, ViT-H/14 by default; the evaluation's
CLIP-I and CLIP-T) reuses the text block with a zero mask over its 257
tokens (head dimension 80 at ViT-H/14, plain PyTorch as in JAX, where it is
an ``einsum`` and no Pallas kernel). Its patch embedding ``patch_embed``
stays in the JAX tree's HWIO layout (p, p, 3, width), so a JAX tree carries
across unchanged (``io.from_jax`` turns only 4-D ``"w"`` leaves to OIHW)
and the torch loader writes the same layout; the tower applies it as one
product of the flattened (kh, kw, c) patches, which is the stride-p VALID
convolution.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..utils.trace import spanned
from .nn import Init, layer_norm, layer_norm_init, linear, linear_init, torch_dtype


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: int = 4
    context_length: int = 77
    act: str = "quick_gelu"  # CLIP-L; bigG uses "gelu"
    ln_eps: float = 1e-5
    num_modifier_tokens: int = 1
    text_projection: bool = False  # bigG pooled path


CLIP_L_CONFIG = ClipTextConfig()
OPEN_CLIP_BIGG_CONFIG = ClipTextConfig(
    width=1280, layers=32, heads=20, act="gelu", text_projection=True
)


def _act(name):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    raise ValueError(name)


def _init_blocks(init: Init, d: int, mlp_ratio: int, n: int):
    """``n`` pre-LN blocks of width ``d``, stacked along a leading axis."""
    m = d * mlp_ratio

    def stacked(make):
        layers = [make() for _ in range(n)]
        return {k: torch.stack([lay[k] for lay in layers]) for k in layers[0]}

    return {
        "ln1": stacked(lambda: layer_norm_init(init, d)),
        "q": stacked(lambda: linear_init(init, d, d)),
        "k": stacked(lambda: linear_init(init, d, d)),
        "v": stacked(lambda: linear_init(init, d, d)),
        "o": stacked(lambda: linear_init(init, d, d)),
        "ln2": stacked(lambda: layer_norm_init(init, d)),
        "fc1": stacked(lambda: linear_init(init, d, m)),
        "fc2": stacked(lambda: linear_init(init, m, d)),
    }


def init_clip_text_params(cfg: ClipTextConfig, seed: int = 0, device="cuda",
                          dtype=torch.float32):
    """Seeded random parameters with the JAX tree's structure (layer-stacked
    blocks, zero modifier rows); the draws differ from JAX's."""
    init = Init(seed, resolve_device(device), torch_dtype(dtype))
    d = cfg.width
    p = {
        "token_embedding": init.normal((cfg.vocab_size, d), 0.02),
        "positional_embedding": init.normal((cfg.context_length, d), 0.01),
        "blocks": _init_blocks(init, d, cfg.mlp_ratio, cfg.layers),
        "ln_final": layer_norm_init(init, d),
        "modifier_rows": init.zeros((cfg.num_modifier_tokens, d)),
    }
    if cfg.text_projection:
        p["text_projection"] = {"w": init.normal((d, d), d**-0.5)}
    return p


def init_modifier_rows(params, init_token_ids=(42170,)):
    """Seed the V* rows from existing token rows (the reference initializes
    <new1> from token id 42170)."""
    rows = torch.stack([params["token_embedding"][i] for i in init_token_ids])
    return dict(params, modifier_rows=rows.clone())


def _layer(blocks, i):
    return {name: {k: v[i] for k, v in sub.items()} for name, sub in blocks.items()}


def _block_apply(p, x, mask, act, cfg: ClipTextConfig):
    b, t, d = x.shape
    h = cfg.heads
    hd = d // h
    y = layer_norm(p["ln1"], x, eps=cfg.ln_eps)
    q = linear(p["q"], y).reshape(b, t, h, hd)
    k = linear(p["k"], y).reshape(b, t, h, hd)
    v = linear(p["v"], y).reshape(b, t, h, hd)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    probs = torch.softmax(logits * (hd**-0.5) + mask, dim=-1).to(v.dtype)
    attn = torch.einsum("bhnm,bmhd->bnhd", probs, v).reshape(b, t, d)
    x = x + linear(p["o"], attn)
    y = layer_norm(p["ln2"], x, eps=cfg.ln_eps)
    return x + linear(p["fc2"], act(linear(p["fc1"], y)))


@spanned("cd360.clip")
def clip_text_apply(params, tokens, cfg: ClipTextConfig):
    """tokens: (B, T) int; ids >= vocab_size index ``modifier_rows``
    (ids beyond the table clamp, as JAX's take(mode="clip")).

    Returns dict: last, penultimate, final (= ln_final(last)), each
    (B, T, D) in the embedding dtype, and pooled (B, D) or None. Under a
    profiler, the call runs inside the span ``cd360.clip``.
    """
    table = params["token_embedding"]
    table = torch.cat([table, params["modifier_rows"].to(table.dtype)], dim=0)
    b, t = tokens.shape
    ids = tokens.to(table.device).long().clamp(0, table.shape[0] - 1)
    x = table[ids.reshape(-1)].reshape(b, t, -1)
    x = x + params["positional_embedding"][:t].to(x.dtype)

    mask = torch.triu(torch.full((t, t), float("-inf"), device=x.device), diagonal=1)
    act = _act(cfg.act)
    states = [x]
    for i in range(cfg.layers):
        states.append(_block_apply(_layer(params["blocks"], i), states[-1], mask, act, cfg))
    last = states[-1]
    penultimate = states[-2]  # the embedding itself for a one-layer tower
    final = layer_norm(params["ln_final"], last, eps=cfg.ln_eps)

    pooled = None
    if "text_projection" in params:
        # eot = the highest token id of each row (first one on ties)
        eot = torch.argmax(tokens.to(final.device).long(), dim=-1)
        rows = final[torch.arange(b, device=final.device), eot]
        pooled = rows @ params["text_projection"]["w"].to(rows.dtype)
    return {"last": last, "penultimate": penultimate, "final": final, "pooled": pooled}


# ---------------------------------------------------------------------------
# CLIP vision tower (open_clip VisionTransformer; the evaluation's towers)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    mlp_ratio: int = 4
    embed_dim: int = 1024  # projection output (ViT-H/14)
    act: str = "gelu"
    ln_eps: float = 1e-5

    @property
    def grid(self):
        return self.image_size // self.patch_size


def init_clip_vision_params(cfg: ClipVisionConfig, seed: int = 0, device="cuda",
                            dtype=torch.float32):
    """Seeded random parameters with the JAX tree's structure: the HWIO
    patch embedding (no bias), class token, learned positions, ln_pre, the
    layer-stacked blocks, ln_post and the projection; the draws differ
    from JAX's."""
    init = Init(seed, resolve_device(device), torch_dtype(dtype))
    d = cfg.width
    scale = d**-0.5
    return {
        "patch_embed": init.normal((cfg.patch_size, cfg.patch_size, 3, d), 0.02),
        "class_embedding": init.normal((d,), scale),
        "positional_embedding": init.normal((cfg.grid * cfg.grid + 1, d), scale),
        "ln_pre": layer_norm_init(init, d),
        "blocks": _init_blocks(init, d, cfg.mlp_ratio, cfg.layers),
        "ln_post": layer_norm_init(init, d),
        "proj": init.normal((d, cfg.embed_dim), scale),
    }


def clip_vision_apply(params, images, cfg: ClipVisionConfig, output_tokens: bool = False):
    """images: (B, H, W, 3) preprocessed NHWC (``embedders.
    clip_image_preprocess``) -> pooled (B, embed_dim); with
    ``output_tokens`` also the (B, grid^2, width) patch-token states."""
    b = images.shape[0]
    p, g, d = cfg.patch_size, cfg.grid, cfg.width
    w = params["patch_embed"]
    x = images[:, :g * p, :g * p].to(w.dtype)  # VALID: whole patches only
    patches = x.reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, g * g, p * p * 3)
    x = patches @ w.reshape(p * p * 3, d)
    cls = params["class_embedding"].to(x.dtype).expand(b, 1, d)
    x = torch.cat([cls, x], dim=1) + params["positional_embedding"].to(x.dtype)
    x = layer_norm(params["ln_pre"], x, eps=cfg.ln_eps)
    # the JAX tower runs its blocks under a text config of the same width,
    # heads and activation, so their LayerNorms take that config's eps
    blk_cfg = ClipTextConfig(width=d, heads=cfg.heads, mlp_ratio=cfg.mlp_ratio, act=cfg.act)
    act = _act(cfg.act)
    mask = torch.zeros((1, 1, 1, 1), device=x.device)  # bidirectional
    for i in range(cfg.layers):
        x = _block_apply(_layer(params["blocks"], i), x, mask, act, blk_cfg)
    pooled = layer_norm(params["ln_post"], x[:, 0], eps=cfg.ln_eps)
    pooled = pooled @ params["proj"].to(pooled.dtype)
    if output_tokens:
        return pooled, x[:, 1:]
    return pooled


def load_clip_vision_torch(state_dict, cfg: ClipVisionConfig, naming: str = "open_clip"):
    """Torch CLIP vision weights -> the tower's parameters (f32 CPU
    tensors). ``naming="open_clip"``: open_clip VisionTransformer keys
    (``visual.conv1``, the packed ``attn.in_proj_*`` split into q, k and
    v, ``mlp.c_fc`` / ``c_proj``); ``"hf"``: HuggingFace
    CLIPVisionModelWithProjection keys. The conv kernel goes OIHW ->
    HWIO."""
    from ..io.torch_convert import hf_clip_blocks, open_clip_blocks

    sd = {k: torch.as_tensor(v.detach().cpu() if hasattr(v, "detach") else v).float()
          for k, v in state_dict.items()
          if k.startswith(("visual.", "vision_model.", "visual_projection."))}

    def norm(prefix):
        return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}

    if naming == "open_clip":
        return {
            "patch_embed": sd["visual.conv1.weight"].permute(2, 3, 1, 0).contiguous(),
            "class_embedding": sd["visual.class_embedding"],
            "positional_embedding": sd["visual.positional_embedding"],
            "ln_pre": norm("visual.ln_pre"),
            "blocks": open_clip_blocks(sd, "visual.", cfg.width, cfg.layers),
            "ln_post": norm("visual.ln_post"),
            "proj": sd["visual.proj"],  # already (width, embed_dim)
        }
    if naming == "hf":
        emb = "vision_model.embeddings."
        return {
            "patch_embed": sd[emb + "patch_embedding.weight"].permute(2, 3, 1, 0).contiguous(),
            "class_embedding": sd[emb + "class_embedding"].reshape(-1),
            "positional_embedding": sd[emb + "position_embedding.weight"],
            "ln_pre": norm("vision_model.pre_layrnorm"),
            "blocks": hf_clip_blocks(sd, "vision_model.encoder.layers.", cfg.layers),
            "ln_post": norm("vision_model.post_layernorm"),
            "proj": sd["visual_projection.weight"].t().contiguous(),
        }
    raise ValueError(f"unknown CLIP vision naming {naming!r}; choose open_clip or hf")
