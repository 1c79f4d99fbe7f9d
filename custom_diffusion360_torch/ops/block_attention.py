"""Self-attention kernel wrappers (port of custom_diffusion360_tpu/ops/
block_attention.py).

The TPU package has three Pallas attention kernels on the sampling path:
``block_attention_qkv_fused`` (packed (b, 3, h, n, d) operand), the
whole-KV-resident ``block_attention`` and the library flash kernel for long
KV. On Hopper one streaming kernel (``csrc/attention.cu``) serves all three:
it reads q/k/v through explicit strides, so the packed layout costs nothing,
and it streams KV through shared memory, so the KV length is not limited.

``attention_fwd`` is the one wrapper that launches it: for CUDA tensors it
launches the kernel (or raises on what the kernel does not take); for CPU
tensors it runs the plain version ``attention_plain``.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from . import _build

KERNEL_HEAD_DIMS = (64, 512)


def attention_plain(q, k, v, scale: float, kv_len: Optional[int] = None):
    """softmax(q k^T * scale) v in f32, keys >= kv_len masked with -1e30.
    q: (b, h, n, d); k, v: (b, h, m, d) -> (b, h, n, d) in q.dtype.
    (JAX: block_attention._xla_f32.)"""
    qf, kf, vf = (t.float() for t in (q, k, v))
    s = torch.einsum("bhnd,bhmd->bhnm", qf, kf) * scale
    if kv_len is not None and kv_len < k.shape[2]:
        mask = torch.arange(k.shape[2], device=s.device) < kv_len
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", p, vf).to(q.dtype)


def _check_operand(t, name):
    if t.dtype != torch.bfloat16:
        raise TypeError(f"attention kernel takes bfloat16, got {name} {t.dtype}")
    outer = [s for s, n in zip(t.stride()[:-1], t.shape[:-1]) if n > 1]
    if t.stride(-1) != 1 or any(s % 8 for s in outer):
        raise ValueError(
            f"attention kernel needs {name} with a unit head-dim stride and "
            f"other strides divisible by 8, got strides {t.stride()}"
        )
    if t.data_ptr() % 16:
        raise ValueError(f"attention kernel needs {name} 16-byte aligned")


def attention_fwd(q, k, v, scale: float, kv_len: Optional[int] = None):
    """Non-causal attention. q: (b, h, n, d); k, v: (b, h, m, d), any
    strides with a unit last stride -> (b, h, n, d).

    CUDA tensors launch ``csrc/attention.cu`` (bf16, d in KERNEL_HEAD_DIMS);
    the result is a (b, h, n, d) view of (b, n, h, d) storage, so callers in
    the models' (b, n, h, d) layout transpose back for free. CPU tensors run
    ``attention_plain``. Launches are counted in ``attention_fwd.launches``,
    and by shape (b, h, n, m, d, kv_len) in ``attention_fwd.launches_by_shape``.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, kv_len)
    b, h, n, d = q.shape
    m = k.shape[2]
    if k.shape != (b, h, m, d) or v.shape != (b, h, m, d):
        raise ValueError(f"attention shapes q {q.shape} k {k.shape} v {v.shape}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel is built for d in {KERNEL_HEAD_DIMS}, got {d}")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError("attention kernel needs q, k, v on one CUDA device")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(t, name)
    kv_len = m if kv_len is None else int(kv_len)
    if not 0 < kv_len <= m:
        raise ValueError(f"kv_len {kv_len} outside (0, {m}]")
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    fn = _build.load("attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, h, n, m, d, kv_len, float(scale), strides, stream)
    _build.check(rc, "attention_fwd")
    attention_fwd.launches += 1
    attention_fwd.launches_by_shape[(b, h, n, m, d, kv_len)] += 1
    return out


attention_fwd.launches = 0
attention_fwd.launches_by_shape = Counter()


def block_attention(q, k, v, scale: float, kv_len: Optional[int] = None):
    """softmax(q k^T * scale) v. q: (b, h, n, d); k, v: (b, h, m, d).
    Keys at or beyond ``kv_len`` are masked. (JAX: block_attention; its
    block_q is a TPU tiling knob with no counterpart here.)"""
    return attention_fwd(q, k, v, scale, kv_len)


def block_attention_qkv_fused(qkv, scale: float):
    """Self-attention from one packed (b, 3, h, n, d) operand, typically a
    strided view of the (b, n, 3*h*d) fused to_qkv output -> (b, h, n, d).
    The kernel reads q, k and v in place. (JAX: block_attention_qkv_fused.)"""
    return attention_fwd(qkv[:, 0], qkv[:, 1], qkv[:, 2], scale, None)
