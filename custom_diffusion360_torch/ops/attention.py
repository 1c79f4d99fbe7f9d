"""Multi-head attention dispatch (port of custom_diffusion360_tpu/ops/
attention.py).

Inputs are (batch, seq, heads, head_dim), the layout the models keep.
An attention with more than 128 keys and a head dim that is a multiple of
64 goes to the attention kernel (``block_attention``, or with
``CD360_ATTN_BNHD=1``, read at each call, ``block_attention_bnhd`` on the
(b, n, h, d) operands as they are); short-KV attention (77-token text
cross-attention) and other head dims (the 32-channel bottleneck of a small
autoencoder) take the plain f32 path, as on the TPU (ops/attention.py:54-90
there), and on the CPU the kernel wrapper runs its own plain version. The
TPU's split between a whole-KV kernel (m <= 4096) and the library flash
kernel (longer KV) has no counterpart: the Hopper kernel streams KV at any
length. Under a profiler the plain path runs inside the span
``cd360.op.attention_plain``.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from ..utils.trace import span
from .block_attention import block_attention, block_attention_bnhd, block_attention_qkv_fused

KERNEL_MIN_KV = 128  # m above this goes to the kernel wrapper
KERNEL_HEAD_MULTIPLE = 64  # ... when d is a multiple of this (the JAX gate)


def _to_kernel(d: int, m: int) -> bool:
    return m > KERNEL_MIN_KV and d % KERNEL_HEAD_MULTIPLE == 0


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

    ``scale`` defaults to d**-0.5. More than KERNEL_MIN_KV keys and d a
    multiple of KERNEL_HEAD_MULTIPLE: the kernel wrapper (the (b, n, h, d)
    one under ``CD360_ATTN_BNHD=1``); else the plain f32 path.
    """
    d = q.shape[-1]
    if scale is None:
        scale = d**-0.5
    kernel = _to_kernel(d, k.shape[1])
    if kernel and os.environ.get("CD360_ATTN_BNHD", "") == "1":
        return block_attention_bnhd(q, k, v, scale)
    if kernel:
        out = block_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale
        )
        return out.transpose(1, 2)
    with span("cd360.op.attention_plain"):
        return _plain_attention(q, k, v, scale)


def dot_product_attention_qkv(qkv, n_heads: int, scale: Optional[float] = None):
    """Self-attention from the fused to_qkv projection output.

    qkv: (b, n, 3*h*d), columns ordered [q | k | v] -> (b, n, h*d). Where
    the kernel takes it (past KERNEL_MIN_KV tokens, d a multiple of
    KERNEL_HEAD_MULTIPLE) it reads a strided (b, 3, h, n, d) view of ``qkv``
    in place (no split, no transpose copies); else split and
    :func:`dot_product_attention`.
    """
    b, n, inner3 = qkv.shape
    inner = inner3 // 3
    d = inner // n_heads
    if scale is None:
        scale = d**-0.5
    if _to_kernel(d, n):
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
