"""Multi-head attention dispatch (port of custom_diffusion360_tpu/ops/
attention.py).

Inputs are (batch, seq, heads, head_dim), the layout the models keep.
A CUDA attention with more than 128 keys goes to the attention kernel
(``block_attention``, or with ``CD360_ATTN_BNHD=1``, read at each call,
``block_attention_bnhd`` on the (b, n, h, d) operands as they are);
short-KV attention (77-token text cross-attention)
takes the plain f32 path, as on the TPU (ops/attention.py:54-63 there), and
on the CPU the kernel wrapper runs its own plain version. The TPU's split between a whole-KV kernel
(m <= 4096) and the library flash kernel (longer KV) has no counterpart: the
Hopper kernel streams KV at any length.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from .block_attention import block_attention, block_attention_bnhd, block_attention_qkv_fused

KERNEL_MIN_KV = 128  # m above this goes to the kernel wrapper


def _plain_attention(q, k, v, scale: float):
    """q: (b, n, h, d); k/v: (b, m, h, d). f32 math, out in v.dtype.
    (JAX: _xla_attention.)"""
    dtype = v.dtype
    qf, kf, vf = (t.float() for t in (q, k, v))
    logits = torch.einsum("bnhd,bmhd->bhnm", qf, kf)
    probs = torch.softmax(logits * scale, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", probs, vf).to(dtype)


def dot_product_attention(q, k, v, scale: Optional[float] = None):
    """Softmax attention. q: (b, n, h, d); k, v: (b, m, h, d) -> (b, n, h, d).

    ``scale`` defaults to d**-0.5. More than KERNEL_MIN_KV keys: the kernel
    wrapper (the (b, n, h, d) one under ``CD360_ATTN_BNHD=1``); fewer: the
    plain f32 path.
    """
    d = q.shape[-1]
    if scale is None:
        scale = d**-0.5
    if k.shape[1] > KERNEL_MIN_KV and os.environ.get("CD360_ATTN_BNHD", "") == "1":
        return block_attention_bnhd(q, k, v, scale)
    if k.shape[1] > KERNEL_MIN_KV:
        out = block_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale
        )
        return out.transpose(1, 2)
    return _plain_attention(q, k, v, scale)


def dot_product_attention_qkv(qkv, n_heads: int, scale: Optional[float] = None):
    """Self-attention from the fused to_qkv projection output.

    qkv: (b, n, 3*h*d), columns ordered [q | k | v] -> (b, n, h*d). Past
    KERNEL_MIN_KV tokens the kernel reads a strided (b, 3, h, n, d) view of
    ``qkv`` in place (no split, no transpose copies); else split and
    :func:`dot_product_attention`.
    """
    b, n, inner3 = qkv.shape
    inner = inner3 // 3
    d = inner // n_heads
    if scale is None:
        scale = d**-0.5
    if n > KERNEL_MIN_KV:
        q5 = qkv.view(b, n, 3, n_heads, d).permute(0, 2, 3, 1, 4)
        out = block_attention_qkv_fused(q5, scale)  # (b, h, n, d)
        return out.transpose(1, 2).reshape(b, n, inner)
    q, k, v = torch.split(qkv, inner, dim=-1)
    q = q.reshape(b, n, n_heads, d)
    k = k.reshape(b, n, n_heads, d)
    v = v.reshape(b, n, n_heads, d)
    return dot_product_attention(q, k, v, scale).reshape(b, n, inner)


def attention_padded_kv(q, k, v, kv_len: int, scale: Optional[float] = None):
    """Attention where k/v were zero-padded along seq to ``k.shape[1]``;
    keys at or beyond ``kv_len`` get a -1e30 logit. f32 logits, probabilities
    cast to v.dtype before the PV product, as in the JAX version."""
    d = q.shape[-1]
    if scale is None:
        scale = d**-0.5
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
    mask = torch.arange(k.shape[1], device=q.device) < kv_len
    logits = torch.where(mask, logits * scale, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", probs, v)
