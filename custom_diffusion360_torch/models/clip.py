"""CLIP text towers (SDXL's two text encoders) with V* modifier-token rows
(port of the text half of custom_diffusion360_tpu/models/clip.py).

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
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .. import resolve_device
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


def init_clip_text_params(cfg: ClipTextConfig, seed: int = 0, device="cuda",
                          dtype=torch.float32):
    """Seeded random parameters with the JAX tree's structure (layer-stacked
    blocks, zero modifier rows); the draws differ from JAX's."""
    init = Init(seed, resolve_device(device), torch_dtype(dtype))
    d, m, n = cfg.width, cfg.width * cfg.mlp_ratio, cfg.layers

    def stacked(make):
        layers = [make() for _ in range(n)]
        return {k: torch.stack([lay[k] for lay in layers]) for k in layers[0]}

    p = {
        "token_embedding": init.normal((cfg.vocab_size, d), 0.02),
        "positional_embedding": init.normal((cfg.context_length, d), 0.01),
        "blocks": {
            "ln1": stacked(lambda: layer_norm_init(init, d)),
            "q": stacked(lambda: linear_init(init, d, d)),
            "k": stacked(lambda: linear_init(init, d, d)),
            "v": stacked(lambda: linear_init(init, d, d)),
            "o": stacked(lambda: linear_init(init, d, d)),
            "ln2": stacked(lambda: layer_norm_init(init, d)),
            "fc1": stacked(lambda: linear_init(init, d, m)),
            "fc2": stacked(lambda: linear_init(init, m, d)),
        },
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


def clip_text_apply(params, tokens, cfg: ClipTextConfig):
    """tokens: (B, T) int; ids >= vocab_size index ``modifier_rows``
    (ids beyond the table clamp, as JAX's take(mode="clip")).

    Returns dict: last, penultimate, final (= ln_final(last)), each
    (B, T, D) in the embedding dtype, and pooled (B, D) or None.
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
