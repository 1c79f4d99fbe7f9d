"""SAME-padded, stride-1 3x3 convolution for the VAE (port of
custom_diffusion360_tpu/ops/conv3x3.py).

``conv3x3_gemm(x, w, bias)`` takes NHWC activations and the port's OIHW
kernel. For CUDA tensors it launches ``csrc/conv3x3.cu``, an implicit GEMM
on wgmma whose operands arrive by TMA: one box of 64 input channels x
16 x 8 pixels per (tap, channel chunk), shifted by the tap and zero-filled
by TMA where it leaves the image (so no padded copy of the input), and a
64 x BN box of the weight; it adds the bias in its epilogue. For CPU
tensors it runs the plain version ``conv3x3_plain`` (+ bias). Its gradient
is the VJP of the plain conv (an autograd Function), as the JAX package's
custom_vjp.

The kernel reads the weight as (N, 3, 3, C): the wrapper re-lays each
parameter tensor once and keeps the copy while the parameter lives
(``relaid_weight``). ``conv3x3_map_args`` computes the three TMA maps'
dims, byte strides and boxes (the C side encodes exactly these), and
``tap_box_coords`` the box coordinates the kernel loads for a tap.
"""
from __future__ import annotations

import ctypes
import functools
import weakref

import torch
import torch.nn.functional as F

from ..utils.graphs import counted
from ..utils.trace import span
from . import _build

TH = TW = 32  # the JAX gate's tile: H and W multiples of 32
CHANNEL_MULTIPLE = 128  # C and N multiples of 128, as the JAX gate
# the kernel's tiling (csrc/conv3x3.cu): 16 x 8 pixel tiles (128 GEMM rows),
# 64 input channels per stage, 256 output channels per tile (128 where N is
# not a multiple of 256)
KERNEL_TW, KERNEL_TH, KERNEL_KC = 16, 8, 64


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


def block_n(n: int) -> int:
    """Output channels per kernel tile: 256 where N allows, else 128."""
    return 256 if n % 256 == 0 else 128


@functools.lru_cache(maxsize=64)
def conv3x3_map_args(b: int, h: int, w: int, c: int, n: int) -> tuple:
    """What ``csrc/conv3x3.cu`` encodes its three TMA maps from, for x (b, h,
    w, c), the re-laid weight (n, 9 c) and out (b, h, w, n), all contiguous
    bf16: 27 ints, for each map its dims (innermost first, in elements),
    byte strides of the outer dims and box, in turn:

    - x: dims (c, w, h, b), strides (2c, 2wc, 2hwc), box (64, 16, 8, 1);
    - weight: dims (9c, n), stride (18c,), box (64, BN);
    - out: dims (n, w, h, b), strides (2n, 2wn, 2hwn), box (64, 16, 4, 1),
      one consumer warpgroup's 64 pixels by 64 channels.

    Raises on shapes the kernel does not take (H % 8, W % 16, C % 64,
    N % 128); the gate ``conv3x3_supported`` is stricter."""
    if h % KERNEL_TH or w % KERNEL_TW or c % KERNEL_KC or n % 128 or b < 1:
        raise ValueError(f"conv3x3 kernel tiles 8 x 16 pixels, 64 input and 128 output "
                         f"channels: got x ({b}, {h}, {w}, {c}) and N = {n}")
    bn = block_n(n)
    return ((c, w, h, b), (2 * c, 2 * w * c, 2 * h * w * c), (KERNEL_KC, KERNEL_TW, KERNEL_TH, 1),
            (9 * c, n), (18 * c,), (KERNEL_KC, bn),
            (n, w, h, b), (2 * n, 2 * w * n, 2 * h * w * n), (64, KERNEL_TW, KERNEL_TH // 2, 1))


@functools.lru_cache(maxsize=64)
def _map_array(b, h, w, c, n):
    """``conv3x3_map_args`` flattened into the long long array the C entry
    point reads (it keeps no pointer to it)."""
    flat = [v for part in conv3x3_map_args(b, h, w, c, n) for v in part]
    return (ctypes.c_longlong * len(flat))(*flat)


def tap_box_coords(tap: int, chunk: int, c: int, b: int, y0: int, x0: int, n0: int) -> tuple:
    """The TMA box coordinates the kernel's producer loads for tap ``tap``
    (ky = tap // 3, kx = tap % 3) and input-channel chunk ``chunk`` of the
    output tile at pixel (y0, x0) of image b and channel n0: the x box at
    (c0, x0 + kx - 1, y0 + ky - 1, b), which TMA zero-fills where it leaves
    the image, and the weight box at (tap * C + c0, n0)."""
    ky, kx = divmod(tap, 3)
    c0 = chunk * KERNEL_KC
    return (c0, x0 + kx - 1, y0 + ky - 1, b), (tap * c + c0, n0)


_kernel = None  # the loaded ctypes entry point, kept off the per-call path


@counted
def conv3x3_fwd(x, w, bias=None):
    """Forward of :func:`conv3x3_gemm`. CUDA: the kernel (bf16, the shapes
    ``conv3x3_supported`` passes) inside the span ``cd360.op.conv3x3``;
    launches counted by shape (B, H, W, C, N) in
    ``conv3x3_fwd.launches_by_shape``. CPU: the plain version + bias."""
    global _kernel
    if x.device.type == "cpu":
        y = conv3x3_plain(x, w)
        return y if bias is None else y + bias.to(y.dtype)
    if not conv3x3_supported(x, w):
        raise ValueError(f"conv3x3 kernel does not take x {tuple(x.shape)} {x.dtype} "
                         f"with weight {tuple(w.shape)}")
    index = x.get_device()
    if w.get_device() != index or (bias is not None and bias.get_device() != index):
        raise ValueError("conv3x3 kernel needs x, w and bias on one CUDA device")
    b, h, wd, c = x.shape
    n = w.shape[0]
    if _kernel is None:
        _kernel = _build.load("conv3x3")
    with span("cd360.op.conv3x3"):
        x = x.contiguous()
        w9 = relaid_weight(w, x.dtype)
        # held in a local until the launch is queued (no freed temporary)
        bias_k = None if bias is None else bias.to(x.dtype).contiguous()
        if bias_k is not None and (bias_k.shape != (n,) or bias_k.data_ptr() % 4):
            raise ValueError(f"conv3x3 kernel needs a 4-byte aligned bias of shape ({n},)")
        if x.data_ptr() % 16:
            raise ValueError("conv3x3 kernel needs a 16-byte aligned input")
        out = torch.empty((b, h, wd, n), dtype=x.dtype, device=x.device)
        maps = _map_array(b, h, wd, c, n)
        with _build.on_device(index):
            rc = _kernel(x.data_ptr(), w9.data_ptr(),
                         None if bias_k is None else bias_k.data_ptr(), out.data_ptr(), maps,
                         _build.current_stream(index))
    _build.check(rc, "conv3x3_fwd")
    conv3x3_fwd.launches_by_shape[(b, h, wd, c, n)] += 1
    return out


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
