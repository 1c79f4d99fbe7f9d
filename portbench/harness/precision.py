"""The control's precision: the reference with the operands of every
matrix product, convolution and attention product rounded to float8 e4m3
(a per-tensor scale to its largest value, f32 accumulation), the step
below the bfloat16 that the configurations state."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

E4M3_MAX = 448.0
MIN_INNER = 16  # operands whose last axis is shorter (camera geometry, points) stay f32


def to_e4m3(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, back in t's
    dtype. The rounding passes the gradient straight through, as fp8
    training does, so the backward runs on the rounded operands."""
    with torch.no_grad():
        scale = t.abs().amax().float().clamp_min(1e-30) / E4M3_MAX
        rounded = ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)
    return t + (rounded - t).detach() if t.requires_grad else rounded


def _round(x, inner: int = MIN_INNER):
    if (isinstance(x, torch.Tensor) and x.is_floating_point() and x.dim() >= 2
            and x.shape[-1] >= inner):
        return to_e4m3(x)
    return x


_PRODUCTS = {F.linear, torch.matmul, torch.Tensor.__matmul__, torch.Tensor.matmul,
             torch.mm, torch.bmm, torch.addmm, torch.Tensor.__rmatmul__}


class Fp8Products(TorchFunctionMode):
    """Within: every matrix product, convolution and einsum takes its
    operands rounded to e4m3 (a convolution's input and its whole kernel,
    whatever the kernel's width)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS:
            args = tuple(_round(a) for a in args)
        elif func is F.conv2d:
            args = (_round(args[0], 1), _round(args[1], 1)) + tuple(args[2:])
        elif func is torch.einsum:
            args = (args[0],) + tuple(_round(a) for a in args[1:])
        return func(*args, **kwargs)
