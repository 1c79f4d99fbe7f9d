"""Functional layer library over dicts of tensors (port of
custom_diffusion360_tpu/models/nn.py).

Conventions: linear weights are stored (in, out) so application is
``x @ w``; conv kernels are OIHW and activations NHWC at the function
boundary (the conv runs on the channels-last NCHW view of the NHWC tensor,
so no layout copy is made); normalization statistics are float32 whatever
the activation dtype.
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


def linear_init(init: Init, in_dim, out_dim, bias=True, zero=False, eye=False,
                std=None):
    """Kaiming-uniform (in, out) weight, as the JAX initializer."""
    bound = math.sqrt(1.0 / in_dim)
    if zero:
        w = init.zeros((in_dim, out_dim))
    elif eye:
        w = torch.eye(in_dim, out_dim, device=init.device, dtype=init.dtype)
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


def conv2d(p, x, stride=1, padding="SAME"):
    """x: NHWC; kernel: OIHW. padding "SAME" (odd kernels) or
    ((top, bottom), (left, right)) with symmetric pairs."""
    w = p["w"].to(x.dtype)
    if padding == "SAME":
        pad = (w.shape[2] // 2, w.shape[3] // 2)
    else:
        (pt, pb), (pl, pr) = padding
        if pt != pb or pl != pr:
            raise ValueError(f"asymmetric padding {padding} not supported")
        pad = (pt, pl)
    b = p["b"].to(x.dtype) if "b" in p else None
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def group_norm(p, x, num_groups=32, eps=1e-6):
    """x: (N, ..., C) channels-last; per-sample, per-group statistics in f32
    from one pass of per-channel moments (E[x^2] - E[x]^2, as the JAX
    version), then y = x * a + b in the activation dtype."""
    orig_dtype = x.dtype
    n, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    xs = x.reshape(n, -1, c).float()
    s1 = xs.sum(1)
    s2 = (xs * xs).sum(1)
    cnt = xs.shape[1] * cg
    mean_g = s1.reshape(n, num_groups, cg).sum(-1) / cnt
    ex2_g = s2.reshape(n, num_groups, cg).sum(-1) / cnt
    var_g = (ex2_g - mean_g * mean_g).clamp_min(0.0)
    mean_c = mean_g.repeat_interleave(cg, dim=-1)
    inv_c = torch.rsqrt(var_g + eps).repeat_interleave(cg, dim=-1)
    af = inv_c * p["scale"].float()
    a = af.to(orig_dtype)
    bsh = (p["bias"].float() - mean_c * af).to(orig_dtype)
    y = x.reshape(n, -1, c) * a[:, None] + bsh[:, None]
    return y.reshape(x.shape)


def group_norm_silu(p, x, num_groups=32, eps=1e-6):
    return F.silu(group_norm(p, x, num_groups, eps))


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


def trunc_exp(x):
    """exp; the truncated gradient of the JAX version matters only for
    training, which is not ported yet."""
    return torch.exp(x)


def upsample_nearest_2x(x):
    """NHWC nearest 2x upsample."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)
