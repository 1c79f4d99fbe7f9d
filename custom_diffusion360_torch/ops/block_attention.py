"""Self-attention kernel wrappers (port of custom_diffusion360_tpu/ops/
block_attention.py).

The TPU package has three Pallas attention kernels on the sampling path:
``block_attention_qkv_fused`` (packed (b, 3, h, n, d) operand), the
whole-KV-resident ``block_attention`` and the library flash kernel for long
KV. On Hopper two streaming kernels serve all three, by head dim: d = 64
(every UNet and pose-block attention) goes to ``csrc/attention_sm90.cu``,
d = 512 (the VAE's one-head mid-block) to ``csrc/attention512_sm90.cu``.
Both are wgmma + TMA kernels with a producer and two consumer warpgroups;
both read q/k/v in place through TMA maps built from the strides that
``tma_map_args`` computes, so the packed and (b, n, h, d) layouts cost
nothing, and both stream KV through shared memory, so the KV length is not
limited. The d = 512 kernel splits the keys
across blocks when its grid would leave SMs idle (``split_count``), with a
merge launch of the per-split partials (``attention_splitkv_plain`` is the
same arithmetic in plain PyTorch).

``attention_fwd`` is the one wrapper that launches them: for CUDA tensors
it launches the kernel (or raises on what the kernel does not take); for
CPU tensors it runs the plain version ``attention_plain``.

Both wrappers take an ``out=`` buffer to write into, and both hand their
launch to ``capture_split`` while one is set: the piecewise CUDA-graph
capture of the cached UNet evaluation (``models/unet_graphs.py``) ends a
graph there, so that every attention launch stays eager, inside its span
and counted, between the replayed segments.

``block_attention`` and ``block_attention_qkv_fused`` are autograd
Functions around it: the forward is ``attention_fwd``, the backward the
JAX package's recompute in plain f32 (``attention_bwd_plain``, JAX
block_attention._bwd); the TPU package has no backward kernel either.

``block_attention_bnhd`` is the same attention on operands in the models'
(b, n, h, d) layout (JAX ``block_attention_bnhd``, the transpose-free
kernel that never compiled on the TPU): the kernel reads the (b, h, n, d)
views of that storage through their strides and writes its output into
(b, n, h, d) storage, so neither side copies. Its launches are counted
apart, in ``attention_bnhd_fwd``.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Optional

import torch

from ..utils.trace import span
from . import _build

KERNEL_HEAD_DIMS = (64, 512)  # csrc/attention_sm90.cu, csrc/attention512_sm90.cu
# csrc/attention512_sm90.cu's query rows per block and keys per K/V tile:
# the key splits are runs of whole tiles
D512_BQ, D512_BK = 64, 32


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


def split_count(bh: int, n: int, m: int, num_sms: int) -> int:
    """Key splits of the d = 512 kernel for bh = b * h heads of n queries
    over m keys on a card of ``num_sms`` SMs: the largest s that keeps the
    grid of ceil(n / 64) * bh * s blocks (one per SM) within one wave, at
    least 1 and at most the 32-key tiles there are. 2 at (1, 1, 4096) on
    132 SMs (128 blocks), 1 once the query tiles alone fill the card."""
    blocks = -(-n // D512_BQ) * bh
    return max(1, min(num_sms // blocks, -(-m // D512_BK)))


def attention_splitkv_plain(q, k, v, scale: float, kv_len: Optional[int] = None,
                            splits: int = 1):
    """``attention_plain`` as the d = 512 kernel computes it with ``splits``
    key splits, in f32: split s takes keys [s * c, (s + 1) * c), c =
    32 * ceil(ceil(m / 32) / splits); each gives its unnormalised P V, row
    max (of scale * q.k) and sum, keys >= kv_len weighted exactly 0, and the
    merge weights split s by exp(max_s - max), a split with no live key by
    exactly 0. q: (b, h, n, d); k, v: (b, h, m, d) -> (b, h, n, d) in
    q.dtype. For tests: no path calls it."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    m = k.shape[2]
    kv_len = m if kv_len is None else int(kv_len)
    tiles = -(-m // D512_BK)
    chunk = D512_BK * -(-tiles // splits)
    parts = []
    for start in range(0, m, chunk):
        keys = torch.arange(start, min(start + chunk, m), device=q.device)
        s = torch.einsum("bhnd,bhmd->bhnm", qf, kf[:, :, keys]) * scale
        s = torch.where(keys < kv_len, s, torch.full_like(s, -torch.inf))
        mx = s.amax(-1, keepdim=True)
        p = torch.exp(s - torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx)))
        parts.append((mx, p.sum(-1, keepdim=True),
                      torch.einsum("bhnm,bhmd->bhnd", p, vf[:, :, keys])))
    top = torch.stack([mx for mx, _, _ in parts]).amax(0)
    out, total = torch.zeros_like(parts[0][2]), torch.zeros_like(top)
    for mx, l, o in parts:
        w = torch.where(l > 0, torch.exp(mx - top), torch.zeros_like(mx))
        out, total = out + w * o, total + w * l
    return (out / total).to(q.dtype)


def tma_map_args(q, k, v, out):
    """What ``csrc/attention_sm90.cu`` (d = 64) and
    ``csrc/attention512_sm90.cu`` (d = 512) encode their four TMA maps from,
    for (b, h, n, d) q and out and (b, h, m, d) k and v views of bf16 storage:
    ``(offsets, strides)``, the byte offset of each operand's first element
    in its storage and its (seq, head, batch) byte strides, q, k, v, out in
    turn (12 strides). Each map is 4-D over (d, seq, head, batch); the C side
    encodes exactly these. A dim of extent 1 is never stepped, but TMA still
    wants a valid stride there: it gets the operand's whole span, rounded up
    to 16 bytes. Raises on a non-bf16 operand, d not 64 or 512 or not the
    same for all four, a head-dim stride other than 1, and an offset or
    stride that is not a multiple of 16 bytes (TMA's alignment). Memoized
    on the operands' dtypes, shapes, strides and offsets: the main paths
    launch a few shapes thousands of times, and the host's time per launch
    is the step's time."""
    return _tma_map_args(*((t.dtype, tuple(t.shape), t.stride(), t.storage_offset())
                           for t in (q, k, v, out)))


@functools.lru_cache(maxsize=1024)
def _tma_map_args(*operands):
    offsets, strides = [], []
    d = operands[0][1][-1]
    for (dtype, shape, stride, offset), name in zip(operands, ("q", "k", "v", "out")):
        if dtype != torch.bfloat16:
            raise TypeError(f"attention kernel takes bfloat16, got {name} {dtype}")
        if len(shape) != 4 or shape[-1] not in KERNEL_HEAD_DIMS or shape[-1] != d:
            raise ValueError(f"the attention kernels are built for d = 64 and d = 512 alike "
                             f"for q, k, v and out, got {name} {shape}")
        if stride[-1] != 1:
            raise ValueError(f"attention kernel needs a unit head-dim stride, got {name} "
                             f"strides {stride}")
        size = 2  # bytes of a bf16
        span = -(-max(st * n for st, n in zip(stride[:3], shape[:3])) * size // 16) * 16
        for dim in (2, 1, 0):  # seq, head, batch
            st = stride[dim] * size if shape[dim] > 1 else max(span, 16)
            if st % 16:
                raise ValueError(f"attention kernel needs {name} strides of a multiple of "
                                 f"16 bytes, got strides {stride} (elements)")
            strides.append(st)
        if offset * size % 16:
            raise ValueError(f"attention kernel needs {name} 16-byte aligned, got a "
                             f"storage offset of {offset * size} bytes")
        offsets.append(offset * size)
    return tuple(offsets), tuple(strides)


@functools.lru_cache(maxsize=1024)
def _longlongs(values):
    """A ctypes long long array of ``values``, one per tuple: the C entry
    points read it during the call and keep no pointer to it."""
    return (ctypes.c_longlong * len(values))(*values)


def _launch(q, k, v, scale: float, kv_len: Optional[int], out=None):
    """One launch of ``csrc/attention_sm90.cu`` (d = 64) or
    ``csrc/attention512_sm90.cu`` (d = 512; with its merge launch when the
    keys are split) on CUDA (b, h, n, d) q and (b, h, m, d) k, v -> (b, h,
    n, d) view of (b, n, h, d) storage, or ``out``, a (b, h, n, d) tensor
    of q's dtype and device to write into; raises on what the kernel does
    not take. Counts nothing; records its key splits in ``splits_launched``."""
    b, h, n, d = q.shape
    m = k.shape[2]
    if k.shape != (b, h, m, d) or v.shape != (b, h, m, d):
        raise ValueError(f"attention shapes q {q.shape} k {k.shape} v {v.shape}")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel is built for d in {KERNEL_HEAD_DIMS}, got {d}")
    index = q.get_device()  # -1 off the card
    if index < 0 or k.get_device() != index or v.get_device() != index:
        raise ValueError("attention kernel needs q, k, v on one CUDA device")
    kv_len = m if kv_len is None else int(kv_len)
    if not 0 < kv_len <= m:
        raise ValueError(f"kv_len {kv_len} outside (0, {m}]")
    if out is None:
        out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    elif out.shape != q.shape or out.dtype != q.dtype or out.device != q.device:
        raise ValueError(f"attention out {tuple(out.shape)} {out.dtype} {out.device} is not "
                         f"q's {tuple(q.shape)} {q.dtype} {q.device}")
    _, strides = tma_map_args(q, k, v, out)  # checks dtype, d, strides and offsets
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.data_ptr() % 16:
            raise ValueError(f"attention kernel needs {name} 16-byte aligned")
    if d == 64:
        splits = 1
        name, call = "attention_sm90", (b, h, n, m, kv_len, float(scale))
    else:
        splits = split_count(b * h, n, m, _build.num_sms(index))
        workspace = (None, None)  # not read with one split
        if splits > 1:  # per-split O and (max, sum), rows padded to whole query tiles
            rows = -(-n // D512_BQ) * D512_BQ
            ws = torch.empty((splits, b * h, rows, d), dtype=torch.float32, device=q.device)
            ml = torch.empty((splits, b * h, rows, 2), dtype=torch.float32, device=q.device)
            workspace = (ws.data_ptr(), ml.data_ptr())
        name = "attention512_sm90"
        call = (*workspace, b, h, n, m, kv_len, float(scale), splits)
    fn = _build.load(name)
    with _build.on_device(index):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *call,
                _longlongs(strides), _build.current_stream(index))
    _build.check(rc, name)
    splits_launched[(b, h, n, m, d)] = splits
    return out


# the key splits that the last launch at each (b, h, n, m, d) ran with
splits_launched = {}

# while a piecewise CUDA-graph capture runs (models/unet_graphs.py): called
# as capture_split(wrapper, q, k, v, scale, kv_len) in place of a launch
capture_split = None


def layout_of(q):
    """How a (b, h, n, d) operand lies in memory, from its strides: "packed"
    (a view of the (b, n, 3, h, d) to_qkv output), "bnhd" (a view of
    (b, n, h, d) storage), "bhnd" (contiguous) or "strided"."""
    b, h, n, d = q.shape
    if q.stride(2) == d and q.stride(1) == n * d:
        return "bhnd"
    if q.stride(1) == d and q.stride(2) == h * d:
        return "bnhd"
    if q.stride(1) == d and q.stride(2) == 3 * h * d:
        return "packed"
    return "strided"


def attention_fwd(q, k, v, scale: float, kv_len: Optional[int] = None, out=None):
    """Non-causal attention. q: (b, h, n, d); k, v: (b, h, m, d), any
    strides with a unit last stride -> (b, h, n, d), written into ``out``
    where given (CUDA).

    CUDA tensors launch ``csrc/attention_sm90.cu`` (d = 64) or
    ``csrc/attention512_sm90.cu`` (d = 512), bf16; the result is a (b, h, n, d) view
    of (b, n, h, d) storage, so callers in the models' (b, n, h, d) layout
    transpose back for free, inside the span ``cd360.op.attention``. CPU
    tensors run ``attention_plain``. Launches are counted by shape and q's
    layout (b, h, n, m, d, kv_len, ``layout_of(q)``) in
    ``attention_fwd.launches_by_shape``. While ``capture_split`` is set,
    the call goes to it.
    """
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, kv_len)
    if capture_split is not None:
        return capture_split(attention_fwd, q, k, v, scale, kv_len)
    with span("cd360.op.attention"):
        out = _launch(q, k, v, scale, kv_len, out)
    b, h, n, d = q.shape
    m = k.shape[2]
    attention_fwd.launches_by_shape[
        (b, h, n, m, d, m if kv_len is None else int(kv_len), layout_of(q))] += 1
    return out


attention_fwd.launches_by_shape = Counter()


def attention_bnhd_fwd(q, k, v, scale: float, kv_len: Optional[int] = None, out=None):
    """Non-causal attention on the (b, n, h, d) layout: q (b, n, h, d), k, v
    (b, m, h, d) -> contiguous (b, n, h, d), or ``out`` of that shape.
    CUDA: the attention kernel on the (b, h, *, d) views, no transpose
    copies, inside the span ``cd360.op.attention``; launches counted by
    shape (b, n, h, m, d, kv_len) in ``attention_bnhd_fwd.launches_by_shape``;
    while ``capture_split`` is set, the call goes to it. CPU:
    ``attention_plain`` on the transposed views."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if q.device.type == "cpu":
        return attention_plain(qt, kt, vt, scale, kv_len).transpose(1, 2)
    if capture_split is not None:
        return capture_split(attention_bnhd_fwd, q, k, v, scale, kv_len)
    with span("cd360.op.attention"):
        out = _launch(qt, kt, vt, scale, kv_len,
                      None if out is None else out.transpose(1, 2)).transpose(1, 2)
    b, n, h, d = q.shape
    m = k.shape[1]
    attention_bnhd_fwd.launches_by_shape[(b, n, h, m, d, m if kv_len is None else int(kv_len))] += 1
    return out


attention_bnhd_fwd.launches_by_shape = Counter()


def attention_bwd_plain(q, k, v, g, scale: float, kv_len: Optional[int] = None):
    """(dq, dk, dv) of softmax(q k^T * scale) v for the output cotangent g,
    recomputed in f32 and cast to the operand dtypes (JAX:
    block_attention._bwd). q, g: (b, h, n, d); k, v: (b, h, m, d)."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    s = torch.einsum("bhnd,bhmd->bhnm", qf, kf) * scale
    if kv_len is not None and kv_len < k.shape[2]:
        mask = torch.arange(k.shape[2], device=s.device) < kv_len
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    del s
    dv = torch.einsum("bhnm,bhnd->bhmd", p, gf)
    dp = torch.einsum("bhnd,bhmd->bhnm", gf, vf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    del p, dp
    dq = torch.einsum("bhnm,bhmd->bhnd", ds, kf) * scale
    dk = torch.einsum("bhnm,bhnd->bhmd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, kv_len):
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (scale, kv_len)
        return attention_fwd(q, k, v, scale, kv_len)

    @staticmethod
    def backward(ctx, g):
        return (*attention_bwd_plain(*ctx.saved_tensors, g, *ctx.cfg), None, None)


class _AttentionQKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, scale):
        ctx.save_for_backward(qkv)
        ctx.scale = scale
        return attention_fwd(qkv[:, 0], qkv[:, 1], qkv[:, 2], scale, None)

    @staticmethod
    def backward(ctx, g):
        (qkv,) = ctx.saved_tensors
        grads = attention_bwd_plain(qkv[:, 0], qkv[:, 1], qkv[:, 2], g, ctx.scale)
        return torch.stack(grads, dim=1), None


def attention_bwd_bnhd_plain(q, k, v, g, scale: float, kv_len: Optional[int] = None):
    """(dq, dk, dv) of the (b, n, h, d)-layout attention for the output
    cotangent g, recomputed in f32 (JAX: block_attention._bwd_bnhd)."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    s = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale
    if kv_len is not None and kv_len < k.shape[1]:
        mask = torch.arange(k.shape[1], device=s.device) < kv_len
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    del s
    dv = torch.einsum("bhnm,bnhd->bmhd", p, gf)
    dp = torch.einsum("bnhd,bmhd->bhnm", gf, vf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    del p, dp
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _AttentionBNHD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, kv_len):
        ctx.save_for_backward(q, k, v)
        ctx.cfg = (scale, kv_len)
        return attention_bnhd_fwd(q, k, v, scale, kv_len)

    @staticmethod
    def backward(ctx, g):
        return (*attention_bwd_bnhd_plain(*ctx.saved_tensors, g, *ctx.cfg), None, None)


def _needs_grad(*tensors):
    """Whether a gradient can flow to any of ``tensors``: the wrappers skip
    their autograd Functions otherwise (inference mode, no_grad, frozen
    inputs), which saves the host a few microseconds a launch."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def block_attention(q, k, v, scale: float, kv_len: Optional[int] = None):
    """softmax(q k^T * scale) v. q: (b, h, n, d); k, v: (b, h, m, d).
    Keys at or beyond ``kv_len`` are masked. Differentiable. (JAX:
    block_attention; its block_q is a TPU tiling knob with no counterpart
    here.)"""
    if _needs_grad(q, k, v):
        return _Attention.apply(q, k, v, scale, kv_len)
    return attention_fwd(q, k, v, scale, kv_len)


def block_attention_qkv_fused(qkv, scale: float):
    """Self-attention from one packed (b, 3, h, n, d) operand, typically a
    strided view of the (b, n, 3*h*d) fused to_qkv output -> (b, h, n, d).
    The kernel reads q, k and v in place; the backward returns the stacked
    (dq, dk, dv). (JAX: block_attention_qkv_fused.)"""
    if _needs_grad(qkv):
        return _AttentionQKV.apply(qkv, scale)
    return attention_fwd(qkv[:, 0], qkv[:, 1], qkv[:, 2], scale, None)


def block_attention_bnhd(q, k, v, scale: float, kv_len: Optional[int] = None):
    """softmax(q k^T * scale) v in the (b, n, h, d) layout. q: (b, n, h, d);
    k, v: (b, m, h, d). Keys at or beyond ``kv_len`` are masked.
    Differentiable; the backward is the f32 recompute. (JAX:
    block_attention_bnhd; block_q is a TPU tiling knob.)"""
    if _needs_grad(q, k, v):
        return _AttentionBNHD.apply(q, k, v, scale, kv_len)
    return attention_bnhd_fwd(q, k, v, scale, kv_len)
