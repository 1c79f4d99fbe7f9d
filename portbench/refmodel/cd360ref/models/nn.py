"""Functional layer library over dicts of tensors (port of
custom_diffusion360_tpu/models/nn.py).

Conventions: linear weights are stored (in, out) so application is
``x @ w``; conv kernels are OIHW and activations NHWC at the function
boundary (the conv runs on the channels-last NCHW view of the NHWC tensor,
so no layout copy is made); normalization statistics are float32 whatever
the activation dtype. The norms are the plain PyTorch forms below on
every device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name) -> torch.dtype:
    """"bfloat16" -> torch.bfloat16 (a torch.dtype passes through)."""
    return name if isinstance(name, torch.dtype) else _DTYPES[str(name)]


# ---------------------------------------------------------------------------
# initializers (seeded through an explicit torch.Generator)
# ---------------------------------------------------------------------------


class Init:
    """Seeded parameter factory: one generator, one device, one dtype."""

    def __init__(self, seed: int, device, dtype=torch.float32):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def uniform(self, shape, bound):
        t = torch.rand(shape, generator=self.gen, device=self.device)
        return (t * (2 * bound) - bound).to(self.dtype)

    def normal(self, shape, std):
        t = torch.randn(shape, generator=self.gen, device=self.device)
        return (t * std).to(self.dtype)

    def zeros(self, shape):
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def ones(self, shape):
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def eye(self, shape):
        return torch.eye(*shape, device=self.device, dtype=self.dtype)


def linear_init(init: Init, in_dim, out_dim, bias=True, zero=False, eye=False,
                std=None):
    """Kaiming-uniform (in, out) weight, as the JAX initializer."""
    bound = math.sqrt(1.0 / in_dim)
    if zero:
        w = init.zeros((in_dim, out_dim))
    elif eye:
        w = init.eye((in_dim, out_dim))
    elif std is not None:
        w = init.normal((in_dim, out_dim), std)
    else:
        w = init.uniform((in_dim, out_dim), bound)
    p = {"w": w}
    if bias:
        p["b"] = init.zeros((out_dim,)) if zero or eye else init.uniform((out_dim,), bound)
    return p


def conv2d_init(init: Init, in_ch, out_ch, kernel=3, bias=True, zero=False):
    bound = math.sqrt(1.0 / (in_ch * kernel * kernel))
    shape = (out_ch, in_ch, kernel, kernel)
    p = {"w": init.zeros(shape) if zero else init.uniform(shape, bound)}
    if bias:
        p["b"] = init.zeros((out_ch,)) if zero else init.uniform((out_ch,), bound)
    return p


def group_norm_init(init: Init, channels):
    return {"scale": init.ones((channels,)), "bias": init.zeros((channels,))}


layer_norm_init = group_norm_init

# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def linear(p, x):
    w = p["w"].to(x.dtype)
    b = p["b"].to(x.dtype) if "b" in p else None
    return F.linear(x, w.t(), b)


def conv_padding(padding, size, kernel, stride):
    """((top, bottom), (left, right)) of ``padding`` as XLA reads it:
    "VALID" pads nothing; "SAME" pads each axis by max((ceil(n / s) - 1) s
    + k - n, 0) in all, the smaller half first (so (0, 1) for a 3x3 kernel
    at stride 2 on an even axis); explicit pairs pass through."""
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding == "SAME":
        pads = []
        for n, k in zip(size, kernel):
            total = max((-(-n // stride) - 1) * stride + k - n, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    return tuple(tuple(pair) for pair in padding)


def conv2d(p, x, stride=1, padding="SAME"):
    """x: NHWC; kernel: OIHW. padding "SAME", "VALID" or ((top, bottom),
    (left, right)), as the JAX conv2d takes it; an asymmetric pair is an
    NHWC zero pad first, so the conv still reads a channels-last view."""
    w = p["w"].to(x.dtype)
    (pt, pb), (pl, pr) = conv_padding(padding, x.shape[1:3], w.shape[2:], stride)
    if pt != pb or pl != pr:
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
        pt = pl = 0
    b = p["b"].to(x.dtype) if "b" in p else None
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=(pt, pl))
    return y.permute(0, 2, 3, 1)


def group_norm(p, x, num_groups=32, eps=1e-6, act=None):
    """x: (N, ..., C) channels-last; per-sample, per-group mean and variance
    in f32 (two passes), optional SiLU, cast back to x's dtype."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = y * p["scale"].float() + p["bias"].float()
    if act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)


def group_norm_silu(p, x, num_groups=32, eps=1e-6):
    return group_norm(p, x, num_groups, eps, act="silu")


def layer_norm(p, x, eps=1e-5):
    """LayerNorm over the last axis, computed in f32, cast back."""
    c = x.shape[-1]
    y = F.layer_norm(x.float(), (c,), p["scale"].float(), p["bias"].float(), eps)
    return y.to(x.dtype)


def silu(x):
    return F.silu(x)


def gelu(x):
    return F.gelu(x, approximate="none")


def timestep_embedding(t, dim, max_period=10000.0):
    """t: (N,) possibly fractional -> (N, dim) f32, layout [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-15.0, 15.0))


def trunc_exp(x):
    """exp with the gradient of exp(clip(x, -15, 15)) (JAX: the custom VJP
    of models/nn.trunc_exp; reference attention.py:192-210)."""
    return _TruncExp.apply(x)


def nearest_indices(src: int, dst: int, device):
    """Source index of each of ``dst`` outputs, F.interpolate's nearest
    rule as the JAX package computes it: floor(o * f32(src / dst))."""
    return torch.floor(torch.arange(dst, dtype=torch.float32) * (src / dst)).long().to(device)


def nearest_resize_tokens(x, src_res: int, dst_res: int):
    """(..., src*src, C) -> (..., dst*dst, C) nearest neighbour (torch
    F.interpolate mode='nearest' semantics: floor(idx * src/dst))."""
    if src_res == dst_res:
        return x
    idx = nearest_indices(src_res, dst_res, x.device)
    img = x.reshape(tuple(x.shape[:-2]) + (src_res, src_res, x.shape[-1]))
    img = img.index_select(-3, idx).index_select(-2, idx)
    return img.reshape(tuple(x.shape[:-2]) + (dst_res * dst_res, x.shape[-1]))


def upsample_nearest_2x(x):
    """NHWC nearest 2x upsample."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)
