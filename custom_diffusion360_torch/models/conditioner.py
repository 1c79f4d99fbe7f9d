"""SDXL conditioner: the two text towers plus the size-tuple embedders,
target rows first (port of custom_diffusion360_tpu/models/conditioner.py).

  crossattn = [CLIP-L final (768) | bigG penultimate (1280)]   -> (*, T, 2048)
  vector    = [bigG pooled (1280) | orig_size PE (512) |
               crop_coords PE (512) | target_size PE (512)]    -> (*, 2816) f32

Batch layout: the B target rows, then the B * n reference rows
(sample-major). The conditioner takes token ids as int tensors
(``tokens_clip`` / ``tokens_open`` and their ``_ref`` variants), made by
data/tokenizer.py on the host. ``force_zero_txt`` zeroes the text
contributions (crossattn and the pooled part of vector), as sgm's
force_uc_zero_embeddings=["txt"]; ``ref=False`` returns the target rows
only, as at inference. Under a profiler the outermost conditioner call
runs inside the span ``cd360.conditioner``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils.trace import spanned
from .clip import (
    CLIP_L_CONFIG,
    OPEN_CLIP_BIGG_CONFIG,
    ClipTextConfig,
    clip_text_apply,
    init_clip_text_params,
)
from .nn import timestep_embedding


@dataclasses.dataclass(frozen=True)
class ConditionerConfig:
    clip_l: ClipTextConfig = CLIP_L_CONFIG
    open_clip: ClipTextConfig = OPEN_CLIP_BIGG_CONFIG
    size_outdim: int = 256


def init_conditioner_params(cfg: ConditionerConfig = ConditionerConfig(), seed: int = 0,
                            device="cuda", dtype=torch.float32):
    return {
        "clip_l": init_clip_text_params(cfg.clip_l, seed, device, dtype),
        "open_clip": init_clip_text_params(cfg.open_clip, seed + 1, device, dtype),
    }


def embed_size_tuple(x, outdim: int = 256):
    """Sinusoidal embedding of each coordinate, concatenated:
    (B, D) -> (B, D * outdim) f32."""
    b, d = x.shape
    return timestep_embedding(x.reshape(-1), outdim).reshape(b, d * outdim)


def _embed_rows(params, tokens_clip, tokens_open, sizes, cfg, force_zero_txt=False):
    out_l = clip_text_apply(params["clip_l"], tokens_clip, cfg.clip_l)["final"]
    out_g = clip_text_apply(params["open_clip"], tokens_open, cfg.open_clip)
    crossattn = torch.cat([out_l, out_g["penultimate"].to(out_l.dtype)], dim=-1)
    pooled = out_g["pooled"].float()
    if force_zero_txt:
        crossattn = torch.zeros_like(crossattn)
        pooled = torch.zeros_like(pooled)
    size_embs = [embed_size_tuple(s.to(pooled.device).float(), cfg.size_outdim) for s in sizes]
    return crossattn, torch.cat([pooled] + size_embs, dim=-1)


@spanned("cd360.conditioner")
def apply_conditioner(params, batch: dict, cfg: ConditionerConfig = ConditionerConfig(), *,
                      force_zero_txt: bool = False, ref: bool = True):
    """batch keys: tokens_clip, tokens_open (B, T); original_size,
    crop_coords, target_size (B, 2); with ``ref`` also the ``_ref``
    variants ((B * n, ...)). Returns {"crossattn": ((1 + n) B, T, 2048),
    "vector": ((1 + n) B, 2816)}, the target rows first."""
    return _conditioner(params, batch, cfg, force_zero_txt, ref)


def _conditioner(params, batch, cfg, force_zero_txt, ref):
    sizes = [batch["original_size"], batch["crop_coords"], batch["target_size"]]
    ca, vec = _embed_rows(params, batch["tokens_clip"], batch["tokens_open"], sizes, cfg,
                          force_zero_txt)
    if not ref:
        return {"crossattn": ca, "vector": vec}
    sizes_ref = [batch["original_size_ref"], batch["crop_coords_ref"],
                 batch["target_size_ref"]]
    ca_r, vec_r = _embed_rows(params, batch["tokens_clip_ref"], batch["tokens_open_ref"],
                              sizes_ref, cfg, force_zero_txt)
    return {"crossattn": torch.cat([ca, ca_r], dim=0), "vector": torch.cat([vec, vec_r], dim=0)}


@spanned("cd360.conditioner")
def get_unconditional_conditioning(params, batch_c: dict, batch_uc: Optional[dict] = None,
                                   cfg: ConditionerConfig = ConditionerConfig(), *,
                                   force_uc_zero_txt: bool = True, ref: bool = False):
    """(c, uc): the conditioner on ``batch_c``, and on ``batch_uc`` (or
    ``batch_c`` again) with the text zeroed when ``force_uc_zero_txt``.
    ``ref=False`` is inference: target rows only."""
    c = _conditioner(params, batch_c, cfg, False, ref)
    uc = _conditioner(params, batch_uc if batch_uc is not None else batch_c, cfg,
                      force_uc_zero_txt, ref)
    return c, uc
