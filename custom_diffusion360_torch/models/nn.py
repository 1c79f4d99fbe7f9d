"""Functional layer library over dicts of tensors (port of
custom_diffusion360_tpu/models/nn.py).

Conventions: linear weights are stored (in, out) so application is
``x @ w``; conv kernels are OIHW and activations NHWC at the function
boundary (the conv runs on the channels-last NCHW view of the NHWC tensor,
so no layout copy is made); normalization statistics are float32 whatever
the activation dtype. On CUDA tensors the norms run the LayerNorm and
GroupNorm(+SiLU) kernels (ops/norms.py), which raise on what they do not
take; on CPU tensors they are the plain PyTorch forms below.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..ops.norms import group_norm_fused, layer_norm_fused

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

    def full(self, shape, value):
        return torch.full(shape, float(value), device=self.device, dtype=self.dtype)


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


def conv_time_init(init: Init, in_ch, out_ch, kernel=3, zero=False):
    """A (kernel, 1, 1) convolution over the frame axis: OIDHW kernel
    (out, in, kernel, 1, 1), kaiming-uniform like ``conv2d_init``."""
    bound = math.sqrt(1.0 / (in_ch * kernel))
    shape = (out_ch, in_ch, kernel, 1, 1)
    if zero:
        return {"w": init.zeros(shape), "b": init.zeros((out_ch,))}
    return {"w": init.uniform(shape, bound), "b": init.uniform((out_ch,), bound)}


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


def conv_time(p, x, frames: int):
    """The (k, 1, 1) convolution over the frames of a clip, zero-padded by
    k // 2 frames at each end (sgm ``conv_nd(3, ..., (3, 1, 1))``). x:
    (B * frames, H, W, C) NHWC frames, clip-major; it runs on the
    channels-last NCDHW view of the clip, so no layout copy is made."""
    bt, h, w, c = x.shape
    k = p["w"].to(x.dtype)
    b = p["b"].to(x.dtype) if "b" in p else None
    clip = x.reshape(bt // frames, frames, h, w, c).permute(0, 4, 1, 2, 3)
    y = F.conv3d(clip, k, b, padding=(k.shape[2] // 2, 0, 0))
    return y.permute(0, 2, 3, 4, 1).reshape(bt, h, w, -1)


def group_norm(p, x, num_groups=32, eps=1e-6):
    """x: (N, ..., C) channels-last; per-sample, per-group statistics in f32.
    CUDA: the GroupNorm kernel. CPU: one pass of per-channel moments
    (E[x^2] - E[x]^2, as the JAX version), then y = x * a + b in the
    activation dtype."""
    if x.is_cuda:
        return group_norm_fused(x.contiguous(), p["scale"], p["bias"], num_groups, eps)
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
    """silu(group_norm(x)); one fused kernel on CUDA."""
    if x.is_cuda:
        return group_norm_fused(x.contiguous(), p["scale"], p["bias"], num_groups, eps,
                                act="silu")
    return F.silu(group_norm(p, x, num_groups, eps))


def layer_norm(p, x, eps=1e-5):
    """LayerNorm over the last axis, computed in f32, cast back. CUDA: the
    LayerNorm kernel."""
    if x.is_cuda:
        return layer_norm_fused(x.contiguous(), p["scale"], p["bias"], eps)
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


@functools.lru_cache(maxsize=64)
def nearest_indices(src: int, dst: int, device):
    """Source index of each of ``dst`` outputs, F.interpolate's nearest
    rule as the JAX package computes it: floor(o * f32(src / dst)). Made
    once a (src, dst, device): the copy to the device cannot be held in a
    CUDA-graph capture of the training step (train/train_graphs.py)."""
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
