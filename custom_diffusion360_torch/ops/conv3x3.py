"""SAME-padded, stride-1 3x3 convolution for the VAE (port of
custom_diffusion360_tpu/ops/conv3x3.py).

``conv3x3_gemm(x, w, bias)`` takes NHWC activations and the port's OIHW
kernel. For CUDA tensors it launches ``csrc/conv3x3.cu``, an implicit-GEMM
kernel that stages each output tile's input with its one-pixel halo in
shared memory (zeros at the image border, so no padded copy of the input)
and adds the bias in its epilogue; for CPU tensors it runs the plain
version ``conv3x3_plain`` (+ bias). Its gradient is the VJP of the plain
conv (an autograd Function), as the JAX package's custom_vjp.

The kernel reads the weight as (N, 3, 3, C): the wrapper re-lays each
parameter tensor once and keeps the copy while the parameter lives
(``relaid_weight``).
"""
from __future__ import annotations

import weakref
from collections import Counter

import torch
import torch.nn.functional as F

from . import _build

TH = TW = 32  # the JAX gate's tile: H and W multiples of 32
CHANNEL_MULTIPLE = 128  # C and N multiples of 128, as the JAX gate


def conv3x3_supported(x, w) -> bool:
    """The JAX package's shape conditions (conv3x3.py:76-90): x (B, H, W, C)
    and an OIHW (N, C, 3, 3) kernel with H, W multiples of 32 and C, N
    multiples of 128, in bf16 or f32. The CUDA kernel is bf16-only, so a
    CUDA f32 input is refused (it stays on cuDNN)."""
    if x.ndim != 4 or w.ndim != 4 or tuple(w.shape[2:]) != (3, 3):
        return False
    _, h, wd, c = x.shape
    n = w.shape[0]
    if x.is_cuda and x.dtype != torch.bfloat16:
        return False
    return (h % TH == 0 and wd % TW == 0 and c % CHANNEL_MULTIPLE == 0
            and n % CHANNEL_MULTIPLE == 0 and w.shape[1] == c
            and x.dtype in (torch.bfloat16, torch.float32))


def conv3x3_plain(x, w):
    """The conv in f32 on the permuted input, cast to x.dtype (JAX:
    conv3x3._conv3x3_ref). x: (B, H, W, C); w: (N, C, 3, 3)."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.float(), padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


# id(weight) -> (weakref to it, its version, the (N, 3, 3, C) copy)
_RELAID: dict = {}


def _version(w):
    # inference tensors (made under torch.inference_mode) keep no version
    # counter: an in-place change of one is not seen
    return None if w.is_inference() else w._version


def relaid_weight(w, dtype):
    """``w`` (N, C, 3, 3) as a contiguous (N, 3, 3, C) tensor of ``dtype``,
    made once per parameter tensor (and again if it is modified in place);
    the copy is dropped when the parameter is."""
    key = id(w)
    hit = _RELAID.get(key)
    if (hit is not None and hit[0]() is w and hit[1] == _version(w)
            and hit[2].dtype == dtype):
        return hit[2]
    relaid = w.permute(0, 2, 3, 1).to(dtype).contiguous()
    if hit is None:
        weakref.finalize(w, _RELAID.pop, key, None)
    _RELAID[key] = (weakref.ref(w), _version(w), relaid)
    return relaid


def conv3x3_fwd(x, w, bias=None):
    """Forward of :func:`conv3x3_gemm`. CUDA: the kernel (bf16, the shapes
    ``conv3x3_supported`` passes); launches counted in
    ``conv3x3_fwd.launches`` and by shape (B, H, W, C, N) in
    ``conv3x3_fwd.launches_by_shape``. CPU: the plain version + bias."""
    if x.device.type == "cpu":
        y = conv3x3_plain(x, w)
        return y if bias is None else y + bias.to(y.dtype)
    if not conv3x3_supported(x, w):
        raise ValueError(f"conv3x3 kernel does not take x {tuple(x.shape)} {x.dtype} "
                         f"with weight {tuple(w.shape)}")
    if w.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("conv3x3 kernel needs x, w and bias on one CUDA device")
    b, h, wd, c = x.shape
    n = w.shape[0]
    x = x.contiguous()
    w9 = relaid_weight(w, x.dtype)
    # held in a local until the launch is queued (no freed temporary)
    bias_k = None if bias is None else bias.to(x.dtype).contiguous()
    out = torch.empty((b, h, wd, n), dtype=x.dtype, device=x.device)
    fn = _build.load("conv3x3")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w9.data_ptr(), None if bias_k is None else bias_k.data_ptr(),
                out.data_ptr(), b, h, wd, c, n, stream)
    _build.check(rc, "conv3x3_fwd")
    conv3x3_fwd.launches += 1
    conv3x3_fwd.launches_by_shape[(b, h, wd, c, n)] += 1
    return out


conv3x3_fwd.launches = 0
conv3x3_fwd.launches_by_shape = Counter()


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return conv3x3_fwd(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        """The VJP of the plain conv in x.dtype (JAX: conv3x3._bwd)."""
        x, w = ctx.saved_tensors
        xn = x.permute(0, 3, 1, 2)
        gn = g.to(x.dtype).permute(0, 3, 1, 2)
        wx = w.to(x.dtype)
        dx = torch.nn.grad.conv2d_input(xn.shape, wx, gn, padding=1).permute(0, 2, 3, 1)
        dw = torch.nn.grad.conv2d_weight(xn, wx.shape, gn, padding=1).to(w.dtype)
        db = None if ctx.bias_dtype is None else g.sum((0, 1, 2)).to(ctx.bias_dtype)
        return dx, dw, db


def conv3x3_gemm(x, w, bias=None):
    """SAME-padded stride-1 3x3 conv, NHWC x OIHW -> NHWC in x.dtype, plus
    ``bias`` when given. Differentiable. Check :func:`conv3x3_supported`
    before calling it on CUDA tensors."""
    return _Conv3x3.apply(x, w, bias)
