"""Carry parameters across from the JAX package.

``from_jax_params(tree)`` takes a JAX params pytree with numpy leaves (for
example ``jax.tree.map(np.asarray, params)``) and returns the port's nested
dicts/lists of tensors under the same keys. Linear weights keep their
(in, out) layout; conv kernels (4-D ``"w"`` leaves) go from JAX's HWIO to
torch's OIHW; every other leaf (embeddings, ``modifier_rows``, positional
embeddings, the stacked text blocks, ``text_projection``, norms, scalars)
is copied as it is, and a None leaf stays None. So a whole JAX
``Engine.init_params`` tree ({"unet", "vae", "conditioner"}, the VAE
encoder and ``quant_conv`` included) carries across, and so does an
``init_ae_engine`` tree ({"ae", "disc", "lpips"}: the scalar ``logvar``,
the PatchGAN's and VGG16's kernels, ActNorm's ``loc`` / ``scale``, the
LPIPS ``lins`` list, and ``lpips`` None without LPIPS). Nothing here
imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device


def _leaf(key, value, device, dtype):
    arr = np.asarray(value)
    if key == "w" and arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "f" and arr.dtype.itemsize != 4):
        arr = arr.astype(np.float32)  # bf16 / f16 / f64 leaves via f32
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def from_jax_params(tree, device="cuda", dtype=None):
    """Port parameters from a JAX params tree of numpy-convertible leaves.
    ``dtype`` (optional) casts every floating leaf."""
    device = resolve_device(device)

    def walk(node, key=None):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _leaf(key, node, device, dtype)

    return walk(tree)
