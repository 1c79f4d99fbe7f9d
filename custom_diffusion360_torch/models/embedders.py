"""The CLIP image preprocess of the FrozenOpenCLIPImageEmbedder (port of
``clip_image_preprocess`` and the CLIP mean and std of
custom_diffusion360_tpu/models/embedders.py; the rest of that module is
not ported yet).
"""
from __future__ import annotations

import torch

from ..ops.image_resize import resize_images

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_image_preprocess(x, size: int = 224):
    """(B, H, W, 3) in [-1, 1] -> (B, size, size, 3) CLIP-normalized f32:
    the antialiased Keys-cubic resize of ``jax.image.resize(...,
    "cubic")``, then [0, 1], then the CLIP mean and std."""
    x = (resize_images(x, size, "cubic") + 1.0) / 2.0
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std
