"""Plain multi-head attention: f32 logits and softmax, no kernel.

Inputs are (batch, seq, heads, head_dim), the layout the models keep.
"""
from __future__ import annotations

from typing import Optional

import torch


def dot_product_attention(q, k, v, scale: Optional[float] = None):
    """q: (b, n, h, d); k, v: (b, m, h, d) -> (b, n, h, d) in v.dtype."""
    d = q.shape[-1]
    if scale is None:
        scale = d**-0.5
    dtype = v.dtype
    qf, kf, vf = (t.float() for t in (q, k, v))
    logits = torch.einsum("bnhd,bmhd->bhnm", qf, kf)
    probs = torch.softmax(logits * scale, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", probs, vf).to(dtype)


def dot_product_attention_qkv(qkv, n_heads: int, scale: Optional[float] = None):
    """qkv: (b, n, 3*h*d), columns [q | k | v] -> (b, n, h*d)."""
    b, n, inner3 = qkv.shape
    inner = inner3 // 3
    d = inner // n_heads
    q, k, v = (t.reshape(b, n, n_heads, d) for t in torch.split(qkv, inner, dim=-1))
    return dot_product_attention(q, k, v, scale).reshape(b, n, inner)
