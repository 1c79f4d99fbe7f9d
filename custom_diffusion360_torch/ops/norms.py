"""LayerNorm and GroupNorm(+SiLU) kernel wrappers (port of
custom_diffusion360_tpu/ops/norms.py).

The TPU package kept its fused Pallas norms off the model path because a
custom call is a synchronization point in XLA's fused schedule; on a CUDA
stream a kernel is just the next launch, so here they carry every norm of
the models on the card: ``csrc/layer_norm.cu`` and ``csrc/group_norm.cu``.

``layer_norm_fused`` and ``group_norm_fused`` launch the kernel for CUDA
tensors (or raise on what it does not take) and run the plain version
(``_ln_plain`` / ``_gn_plain``, f32 statistics) for CPU tensors. Where a
gradient is wanted they go through autograd Functions whose backward is the
plain closed form (LayerNorm) or the VJP of the plain version (GroupNorm),
in f32, as the JAX package's ``_ln_bwd`` / ``_gn_bwd``; both skip the
Function when no gradient can flow (inference mode, ``no_grad``, or no
input that requires grad), since they run hundreds of times a UNet step and
the host's time per launch is the step's time. Both kernels read bf16 or
f32 scale and bias as they are (no copies); the GroupNorm kernel makes two
launches a call with one scratch tensor for its per-chunk statistics.
Launches are counted by shape on ``layer_norm_fused`` / ``group_norm_fused``
(``launches_by_shape``); the card's launches run inside the spans
``cd360.op.layer_norm`` / ``cd360.op.group_norm``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..utils.graphs import counted
from ..utils.trace import span
from . import _build

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}
CHANNEL_MULTIPLE = 8  # 16-byte vectors of bf16


def _ln_plain(x, scale, bias, eps):
    """LayerNorm over the last axis in f32, cast back (JAX: _ln_xla)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def _gn_plain(x, scale, bias, num_groups, eps, act=None):
    """GroupNorm of (N, ..., C) channels-last x per (sample, group) in f32,
    optional SiLU, cast back (JAX: _gn_xla)."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 3), keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape) * scale.float() + bias.float()
    if act == "silu":
        y = F.silu(y)
    return y.to(x.dtype)


def _check_input(x, what):
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} kernel takes bf16 or f32, got {x.dtype}")
    if x.shape[-1] % CHANNEL_MULTIPLE:
        raise ValueError(f"{what} kernel needs channels divisible by "
                         f"{CHANNEL_MULTIPLE}, got {x.shape[-1]}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what} kernel needs a contiguous, 16-byte aligned input")


def _check_params(x, scale, bias, what):
    """Scale and bias as the norm kernels read them: (C,) contiguous,
    16-byte aligned, both bf16 or both f32, on x's device."""
    c = x.shape[-1]
    for t, name in ((scale, "scale"), (bias, "bias")):
        if t.dtype not in _DTYPES or t.dtype != scale.dtype:
            raise TypeError(f"{what} kernel takes scale and bias both bf16 or both f32, got "
                            f"{scale.dtype} and {bias.dtype}")
        if t.shape != (c,) or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what} kernel needs a contiguous, 16-byte aligned {name} of "
                             f"shape ({c},), got {tuple(t.shape)}")
        if t.get_device() != x.get_device():
            raise ValueError(f"{what} kernel needs {name} on {x.device}, got {t.device}")


_ln_kernel = None  # the loaded ctypes entry point, kept off the per-call path


def _ln_forward(x, scale, bias, eps):
    global _ln_kernel
    if x.device.type == "cpu":
        return _ln_plain(x, scale, bias, eps)
    _check_input(x, "layer_norm")
    _check_params(x, scale, bias, "layer_norm")
    c = x.shape[-1]
    rows = x.numel() // c
    if _ln_kernel is None:
        _ln_kernel = _build.load("layer_norm")
    index = x.get_device()
    with span("cd360.op.layer_norm"), _build.on_device(index):
        y = torch.empty_like(x)
        rc = _ln_kernel(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, c,
                        float(eps), _DTYPES[x.dtype], _DTYPES[scale.dtype],
                        _build.current_stream(index))
    _build.check(rc, "layer_norm_fused")
    layer_norm_fused.launches_by_shape[
        (rows, c, _DTYPE_NAMES[x.dtype], _DTYPE_NAMES[scale.dtype])] += 1
    return y


def gn_chunks(n: int, hw: int, c: int, itemsize: int, groups: int) -> int:
    """Row chunks per sample of the GroupNorm kernel's statistics launch:
    about one block per SM of an H100 (132) over the whole batch, but no
    chunk shorter than four rows for each of its threads (a block reads
    max(1, 1024 // vectors a row) rows in parallel, 16 bytes a vector), and
    at most 132 * 32 (chunk, group) partials a sample, which the apply
    launch stages in shared memory."""
    vectors = c * itemsize // 16
    min_rows = 4 * max(1, 1024 // vectors)
    return max(1, min(-(-132 // n), -(-hw // min_rows), 132 * 32 // groups))


MAX_GROUPS = 256  # the apply launch merges with 256 / G threads a group
_gn_kernel = None  # the loaded ctypes entry point, kept off the per-call path


def _gn_forward(x, scale, bias, num_groups, eps, act):
    global _gn_kernel
    if x.device.type == "cpu":
        return _gn_plain(x, scale, bias, num_groups, eps, act)
    _check_input(x, "group_norm")
    _check_params(x, scale, bias, "group_norm")
    n, c = x.shape[0], x.shape[-1]
    if c % num_groups or num_groups > MAX_GROUPS:
        raise ValueError(f"group_norm kernel needs at most {MAX_GROUPS} groups dividing C = {c}, "
                         f"got {num_groups}")
    if c * x.element_size() > 16 * 1024:
        raise ValueError(f"group_norm kernel takes rows of at most 16 KB, got C = {c} "
                         f"{x.dtype}")
    if act not in (None, "silu"):
        raise ValueError(f"group_norm kernel fuses act None or 'silu', got {act!r}")
    hw = x.numel() // (n * c)
    chunks = gn_chunks(n, hw, c, x.element_size(), num_groups)
    if _gn_kernel is None:
        _gn_kernel = _build.load("group_norm")
    index = x.get_device()
    with span("cd360.op.group_norm"), _build.on_device(index):
        y = torch.empty_like(x)
        partial = torch.empty((n, chunks, num_groups, 2), dtype=torch.float32, device=x.device)
        rc = _gn_kernel(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                        partial.data_ptr(), n, hw, c, num_groups, chunks, float(eps),
                        int(act == "silu"), _DTYPES[x.dtype], _DTYPES[scale.dtype],
                        _build.current_stream(index))
    _build.check(rc, "group_norm_fused")
    group_norm_fused.launches_by_shape[
        (n, hw, c, num_groups, act or "none", _DTYPE_NAMES[x.dtype])] += 1
    return y


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _ln_forward(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        """Closed-form f32 backward (JAX: _ln_bwd)."""
        x, scale = ctx.saved_tensors
        xf, gf = x.float(), g.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        inv = torch.rsqrt(var + ctx.eps)
        xhat = (xf - mean) * inv
        lead = tuple(range(x.dim() - 1))
        dx = dscale = dbias = None
        if ctx.needs_input_grad[0]:
            dy = gf * scale.float()
            dx = inv * (dy - dy.mean(-1, keepdim=True)
                        - xhat * (dy * xhat).mean(-1, keepdim=True))
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            dscale = (gf * xhat).sum(lead).to(scale.dtype)
        if ctx.needs_input_grad[2]:
            dbias = gf.sum(lead).to(scale.dtype)
        return dx, dscale, dbias, None


class _GroupNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, act):
        ctx.save_for_backward(x, scale, bias)
        ctx.cfg = (num_groups, eps, act)
        return _gn_forward(x, scale, bias, num_groups, eps, act)

    @staticmethod
    def backward(ctx, g):
        """The VJP of ``_gn_plain``, recomputed in f32 (JAX: _gn_bwd)."""
        saved = ctx.saved_tensors
        wanted = [i for i in range(3) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(i in wanted) for i, t in enumerate(saved)]
            y = _gn_plain(*leaves, *ctx.cfg)
            grads = torch.autograd.grad(y, [leaves[i] for i in wanted], g)
        out = [None] * 6
        for i, gr in zip(wanted, grads):
            out[i] = gr
        return tuple(out)


@counted
def layer_norm_fused(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with f32 statistics. x: (..., C) bf16 or
    f32 (C % 8 == 0 on the card); scale, bias: (C,), both bf16 or both f32.
    Output in x.dtype. The autograd Function only when a gradient can flow."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, scale, bias, eps)
    return _ln_forward(x, scale, bias, eps)


@counted
def group_norm_fused(x, scale, bias, num_groups: int = 32, eps: float = 1e-6,
                     act: Optional[str] = None):
    """Per-sample GroupNorm of channels-last x (N, ..., C) over (spatial,
    group channels) with f32 statistics, fused with SiLU when act="silu".
    x bf16 or f32 (C % 8 == 0 on the card); scale, bias: (C,), both bf16 or
    both f32. Output in x.dtype. The autograd Function only when a gradient
    can flow."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _GroupNorm.apply(x, scale, bias, num_groups, eps, act)
    return _gn_forward(x, scale, bias, num_groups, eps, act)
