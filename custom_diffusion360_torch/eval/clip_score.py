"""CLIP similarity metrics over the port's CLIP towers (port of
custom_diffusion360_tpu/eval/clip_score.py).

CLIP-T (image against its prompt) and CLIP-I (image against an image), the
two customization-quality scores of the paper's evaluation protocol: the
cosine similarity of the L2-normalized embeddings, per sample.
"""
from __future__ import annotations

import torch

from ..models.clip import ClipTextConfig, ClipVisionConfig, clip_text_apply, clip_vision_apply
from ..models.embedders import clip_image_preprocess


def _normalize(x, eps=1e-8):
    return x / (torch.linalg.norm(x, dim=-1, keepdim=True) + eps)


def clip_image_embed(vision_params, images, cfg: ClipVisionConfig):
    """images: (B, H, W, 3) in [-1, 1] -> L2-normalized (B, D)."""
    return _normalize(clip_vision_apply(vision_params,
                                        clip_image_preprocess(images, cfg.image_size), cfg))


def clip_text_embed(text_params, tokens, cfg: ClipTextConfig):
    """tokens: (B, T) -> L2-normalized (B, D), through the tower's pooled
    eot projection (a tower with ``text_projection``)."""
    pooled = clip_text_apply(text_params, tokens, cfg)["pooled"]
    if pooled is None:
        raise ValueError("text tower has no text_projection for pooling")
    return _normalize(pooled)


def clip_score(vision_params, text_params, images, tokens, vision_cfg: ClipVisionConfig,
               text_cfg: ClipTextConfig):
    """CLIP-T: per-sample cosine similarity (B,) of images and their
    prompts."""
    zi = clip_image_embed(vision_params, images, vision_cfg)
    zt = clip_text_embed(text_params, tokens, text_cfg)
    return (zi * zt.to(zi.dtype)).sum(-1)


def clip_image_similarity(vision_params, images_a, images_b, cfg: ClipVisionConfig):
    """CLIP-I: per-sample cosine similarity (B,) of two image sets
    (generated against real views of the concept)."""
    za = clip_image_embed(vision_params, images_a, cfg)
    zb = clip_image_embed(vision_params, images_b, cfg)
    return (za * zb).sum(-1)
