"""sgm SDXL checkpoints -> the port's parameter trees (port of
custom_diffusion360_tpu/io/torch_convert.py).

The port keeps the JAX tree's keys and layouts except for conv kernels,
which stay torch's OIHW (io/from_jax.py): so torch linears transpose
(out, in) -> (in, out), conv kernels are taken as they are, and GroupNorm/
LayerNorm weight/bias become scale/bias. Key layouts: the sgm SDXL UNet
(``model.diffusion_model.*``), the sgm VAE (``first_stage_model.*``), the HF
CLIPTextModel (``conditioner.embedders.0.transformer.*``) and the open_clip
text tower (``conditioner.embedders.1.model.*``). Leaves keep the
checkpoint's dtype; a ``.safetensors`` file is read without the
``safetensors`` package (io/safetensors.py).
"""
from __future__ import annotations

import pickle
from typing import Dict

import torch

from ..models.clip import CLIP_L_CONFIG, OPEN_CLIP_BIGG_CONFIG, ClipTextConfig
from ..models.unet import UNetConfig, build_unet_spec
from ..models.vae import VAEConfig
from .safetensors import load_safetensors


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` or torch ``.ckpt``/``.pt`` file -> {key: CPU
    tensor}. A torch file is read with ``weights_only=True``, and with
    ``weights_only=False`` only when that reader refuses it (a Lightning
    checkpoint pickles more than tensors), which can run code stored in the
    file: load only checkpoints from a source you trust."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: v.detach().cpu() for k, v in sd.items()}


def _lin(sd, prefix, bias=True):
    p = {"w": sd[prefix + ".weight"].t().contiguous()}
    if bias and prefix + ".bias" in sd:
        p["b"] = sd[prefix + ".bias"]
    return p


def _conv(sd, prefix):
    p = {"w": sd[prefix + ".weight"]}  # OIHW, the port's layout
    if prefix + ".bias" in sd:
        p["b"] = sd[prefix + ".bias"]
    return p


def _norm(sd, prefix):
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def _stack(trees):
    """Stack a list of equally-keyed nested dicts leaf by leaf (the text
    towers' layer axis)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


def _attn(sd, p):
    return {"to_q": _lin(sd, p + ".to_q"), "to_k": _lin(sd, p + ".to_k"),
            "to_v": _lin(sd, p + ".to_v"), "to_out": _lin(sd, p + ".to_out.0")}


def _transformer_block(sd, p, has_nerf):
    out = {
        "attn1": _attn(sd, p + ".attn1"),
        "attn2": _attn(sd, p + ".attn2"),
        "ff": {"proj": _lin(sd, p + ".ff.net.0.proj"), "out": _lin(sd, p + ".ff.net.2")},
        "norm1": _norm(sd, p + ".norm1"),
        "norm2": _norm(sd, p + ".norm2"),
        "norm3": _norm(sd, p + ".norm3"),
    }
    if has_nerf and p + ".pose_emb_layers.weight" in sd:
        out["pose_emb_layers"] = _lin(sd, p + ".pose_emb_layers", bias=False)
        nerf_p = p + ".pose_featurenerf.model"
        out["pose_featurenerf"] = {
            "plane_coefs": {"l1": _lin(sd, nerf_p + ".plane_coefs.0"),
                            "l2": _lin(sd, nerf_p + ".plane_coefs.2")},
            "decoder": _lin(sd, nerf_p + ".decoder", bias=False),
        }
        if nerf_p + ".nviews.weight" in sd:
            out["pose_featurenerf"]["nviews"] = _lin(sd, nerf_p + ".nviews")
    return out


def _spatial_transformer(sd, p, cfg: UNetConfig, ch, depth, attn_id):
    tcfg = cfg.transformer_config(ch, depth, attn_id)
    return {
        "norm": _norm(sd, p + ".norm"),
        "proj_in": _lin(sd, p + ".proj_in"),
        "proj_out": _lin(sd, p + ".proj_out"),
        "blocks": [_transformer_block(sd, f"{p}.transformer_blocks.{d}", tcfg.block_has_nerf(d))
                   for d in range(depth)],
    }


def _resblock(sd, p):
    out = {
        "norm_in": _norm(sd, p + ".in_layers.0"),
        "conv_in": _conv(sd, p + ".in_layers.2"),
        "emb": _lin(sd, p + ".emb_layers.1"),
        "norm_out": _norm(sd, p + ".out_layers.0"),
        "conv_out": _conv(sd, p + ".out_layers.3"),
    }
    if p + ".skip_connection.weight" in sd:
        out["skip"] = _conv(sd, p + ".skip_connection")
    return out


def convert_unet_state_dict(sd, cfg: UNetConfig = UNetConfig(),
                            prefix: str = "model.diffusion_model."):
    """sgm SDXL UNet keys -> an ``init_unet_params``-shaped tree."""
    P = prefix
    inb_spec, mid_spec, outb_spec, _ = build_unet_spec(cfg)

    def layer(spec, p):
        kind = spec[0]
        if kind == "conv_in":
            return _conv(sd, p)
        if kind == "res":
            return _resblock(sd, p)
        if kind == "attn":
            _, ch, depth, attn_id = spec
            return _spatial_transformer(sd, p, cfg, ch, depth, attn_id)
        if kind == "down":
            return _conv(sd, p + ".op")
        if kind == "up":
            return _conv(sd, p + ".conv")
        raise ValueError(kind)

    params = {
        "time_embed": {"l1": _lin(sd, P + "time_embed.0"), "l2": _lin(sd, P + "time_embed.2")},
        "label_emb": {"l1": _lin(sd, P + "label_emb.0.0"), "l2": _lin(sd, P + "label_emb.0.2")},
        "out_norm": _norm(sd, P + "out.0"),
        "out_conv": _conv(sd, P + "out.2"),
    }
    params["input_blocks"] = [[layer(s, f"{P}input_blocks.{i}.{j}") for j, s in enumerate(block)]
                              for i, block in enumerate(inb_spec)]
    params["middle_block"] = [layer(s, f"{P}middle_block.{j}") for j, s in enumerate(mid_spec)]
    params["output_blocks"] = [[layer(s, f"{P}output_blocks.{i}.{j}")
                                for j, s in enumerate(block)]
                               for i, block in enumerate(outb_spec)]
    return params


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


def _vae_res(sd, p):
    out = {"norm1": _norm(sd, p + ".norm1"), "conv1": _conv(sd, p + ".conv1"),
           "norm2": _norm(sd, p + ".norm2"), "conv2": _conv(sd, p + ".conv2")}
    if p + ".nin_shortcut.weight" in sd:
        out["nin_shortcut"] = _conv(sd, p + ".nin_shortcut")
    return out


def _vae_attn(sd, p):
    return {"norm": _norm(sd, p + ".norm"), "q": _conv(sd, p + ".q"), "k": _conv(sd, p + ".k"),
            "v": _conv(sd, p + ".v"), "proj_out": _conv(sd, p + ".proj_out")}


def convert_vae_state_dict(sd, cfg: VAEConfig = VAEConfig(), prefix: str = "first_stage_model."):
    P = prefix
    n_lv = len(cfg.ch_mult)
    enc = {"conv_in": _conv(sd, P + "encoder.conv_in")}
    for i in range(n_lv):
        lvl = {"block": [_vae_res(sd, f"{P}encoder.down.{i}.block.{j}")
                         for j in range(cfg.num_res_blocks)]}
        if i != n_lv - 1:
            lvl["downsample"] = _conv(sd, f"{P}encoder.down.{i}.downsample.conv")
        enc[f"down_{i}"] = lvl
    enc["mid"] = {"block_1": _vae_res(sd, P + "encoder.mid.block_1"),
                  "attn_1": _vae_attn(sd, P + "encoder.mid.attn_1"),
                  "block_2": _vae_res(sd, P + "encoder.mid.block_2")}
    enc["norm_out"] = _norm(sd, P + "encoder.norm_out")
    enc["conv_out"] = _conv(sd, P + "encoder.conv_out")

    dec = {"conv_in": _conv(sd, P + "decoder.conv_in"),
           "mid": {"block_1": _vae_res(sd, P + "decoder.mid.block_1"),
                   "attn_1": _vae_attn(sd, P + "decoder.mid.attn_1"),
                   "block_2": _vae_res(sd, P + "decoder.mid.block_2")}}
    for i in range(n_lv):
        lvl = {"block": [_vae_res(sd, f"{P}decoder.up.{i}.block.{j}")
                         for j in range(cfg.num_res_blocks + 1)]}
        if i != 0:
            lvl["upsample"] = _conv(sd, f"{P}decoder.up.{i}.upsample.conv")
        dec[f"up_{i}"] = lvl
    dec["norm_out"] = _norm(sd, P + "decoder.norm_out")
    dec["conv_out"] = _conv(sd, P + "decoder.conv_out")
    return {"encoder": enc, "decoder": dec, "quant_conv": _conv(sd, P + "quant_conv"),
            "post_quant_conv": _conv(sd, P + "post_quant_conv")}


# ---------------------------------------------------------------------------
# text towers
# ---------------------------------------------------------------------------


def _split_rows(table, cfg: ClipTextConfig):
    """(vocab rows, the appended V* rows or zeros if there are none)."""
    extra = table[cfg.vocab_size:]
    if not extra.numel():
        extra = torch.zeros((cfg.num_modifier_tokens, cfg.width), dtype=torch.float32)
    return table[: cfg.vocab_size], extra


def hf_clip_blocks(sd, prefix: str, layers: int):
    """The layer-stacked blocks of a HuggingFace CLIP encoder
    (``<prefix><i>.self_attn.q_proj`` ...), text or vision."""
    blocks = []
    for i in range(layers):
        lp = f"{prefix}{i}."
        blocks.append({
            "ln1": _norm(sd, lp + "layer_norm1"),
            "q": _lin(sd, lp + "self_attn.q_proj"),
            "k": _lin(sd, lp + "self_attn.k_proj"),
            "v": _lin(sd, lp + "self_attn.v_proj"),
            "o": _lin(sd, lp + "self_attn.out_proj"),
            "ln2": _norm(sd, lp + "layer_norm2"),
            "fc1": _lin(sd, lp + "mlp.fc1"),
            "fc2": _lin(sd, lp + "mlp.fc2"),
        })
    return _stack(blocks)


def open_clip_blocks(sd, prefix: str, width: int, layers: int):
    """The layer-stacked blocks of an open_clip transformer
    (``<prefix>transformer.resblocks.<i>``), the packed qkv ``in_proj``
    split into q, k and v; text or vision."""
    d = width
    blocks = []
    for i in range(layers):
        lp = f"{prefix}transformer.resblocks.{i}."
        in_w = sd[lp + "attn.in_proj_weight"]  # (3d, d)
        in_b = sd[lp + "attn.in_proj_bias"]
        blk = {"ln1": _norm(sd, lp + "ln_1")}
        for j, name in enumerate("qkv"):
            blk[name] = {"w": in_w[j * d:(j + 1) * d].t().contiguous(),
                         "b": in_b[j * d:(j + 1) * d]}
        blk.update({"o": _lin(sd, lp + "attn.out_proj"), "ln2": _norm(sd, lp + "ln_2"),
                    "fc1": _lin(sd, lp + "mlp.c_fc"), "fc2": _lin(sd, lp + "mlp.c_proj")})
        blocks.append(blk)
    return _stack(blocks)


def convert_clip_l_state_dict(sd, cfg: ClipTextConfig,
                              prefix: str = "conditioner.embedders.0.transformer."):
    """HF CLIPTextModel keys. Embedding rows past cfg.vocab_size (appended
    V* rows) become ``modifier_rows``."""
    P = prefix + "text_model."
    base, extra = _split_rows(sd[P + "embeddings.token_embedding.weight"], cfg)
    return {
        "token_embedding": base,
        "positional_embedding": sd[P + "embeddings.position_embedding.weight"],
        "blocks": hf_clip_blocks(sd, P + "encoder.layers.", cfg.layers),
        "ln_final": _norm(sd, P + "final_layer_norm"),
        "modifier_rows": extra,
    }


def convert_open_clip_state_dict(sd, cfg: ClipTextConfig,
                                 prefix: str = "conditioner.embedders.1.model."):
    """open_clip text-tower keys (packed qkv ``in_proj``)."""
    P = prefix
    base, extra = _split_rows(sd[P + "token_embedding.weight"], cfg)
    return {
        "token_embedding": base,
        "positional_embedding": sd[P + "positional_embedding"],
        "blocks": open_clip_blocks(sd, P, cfg.width, cfg.layers),
        "ln_final": _norm(sd, P + "ln_final"),
        "text_projection": {"w": sd[P + "text_projection"]},
        "modifier_rows": extra,
    }


def load_sdxl_checkpoint(path: str, unet_cfg: UNetConfig = UNetConfig(),
                         vae_cfg: VAEConfig = VAEConfig(),
                         clip_l_cfg: ClipTextConfig = CLIP_L_CONFIG,
                         open_clip_cfg: ClipTextConfig = OPEN_CLIP_BIGG_CONFIG):
    """A whole base checkpoint (the sd_xl_base_1.0.safetensors layout) ->
    {"unet", "vae", "conditioner": {"clip_l", "open_clip"}} of CPU tensors."""
    sd = load_torch_state_dict(path)
    return {
        "unet": convert_unet_state_dict(sd, unet_cfg),
        "vae": convert_vae_state_dict(sd, vae_cfg),
        "conditioner": {"clip_l": convert_clip_l_state_dict(sd, clip_l_cfg),
                        "open_clip": convert_open_clip_state_dict(sd, open_clip_cfg)},
    }
