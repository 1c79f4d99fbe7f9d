"""Shared arithmetic of the per-layer metrics' readers (metrics/*.py)."""
from __future__ import annotations

from . import peaks, work

# device kernel names, lower case, by group (the port's kernels by their
# ``__global__`` names; cuBLAS, cuDNN and copies by the words in theirs)
NAMED_KERNELS = ("attn_sm90_kernel", "attn512_kernel", "attn512_merge_kernel", "conv3x3_kernel",
                 "bilinear_kernel", "bilinear_bwd_kernel", "bilinear_bwd_merge_kernel",
                 "layer_norm_kernel", "gn_stats_kernel", "gn_apply_kernel")
F32_GEMM = ("gemm_f32f32", "sgemm")  # float32 GEMMs on the CUDA cores (TF32 off)
GEMM = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "cublas")
CONV = ("fprop", "conv", "implicit", "cudnn", "dgrad", "wgrad")
COPY = ("copy", "cat", "memcpy", "memset", "transpose", "nchwtonhwc", "nhwctonchw")


def span(ctx, name):
    return ctx.spans.get(name)


def per_unit_ms(ctx, *names):
    s = ctx.trace.device_s(*names)
    return s * 1e3 / ctx.trace.units if s > 0 else None


def outside_ms(ctx, *groups):
    """Device ms a unit of the kernels in none of ``groups``."""
    if ctx.trace.busy_s <= 0.0:
        return None
    keys = [k for g in groups for k in g]
    s = sum(v[0] for name, v in ctx.trace.kernels.items()
            if not any(k in name.lower() for k in keys))
    return s * 1e3 / ctx.trace.units


def idle_share(ctx):
    """100 (1 - device busy a unit in the trace / the untraced unit's time)."""
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.units / ctx.unit_s)


def mfu(ctx):
    """Model operations a unit over (the untraced unit's time x the bf16 peak)."""
    return 100.0 * ctx.flops() / (ctx.unit_s * peaks.BF16_FLOPS)


def launches(ctx):
    return ctx.trace.launches() / ctx.trace.units


def roofline(ctx, groups, kernel_names):
    """Share of the roofline of the kernels ``kernel_names``: the least
    time of the launches the counters ``groups`` {counter: bound_fn}
    recorded in the traced window, over those kernels' device time."""
    least = sum(fn(*key) * count for counter, fn in groups.items()
                for key, count in ctx.launches.get(counter, {}).items())
    device_s = ctx.trace.device_s(*kernel_names)
    if least <= 0.0 or device_s <= 0.0:
        return None
    return 100.0 * least / device_s


ATTENTION = ({"attention": work.attention, "attention_bnhd": work.attention_bnhd},
             ("attn_sm90_kernel", "attn512_kernel", "attn512_merge_kernel"))
BILINEAR = ({"bilinear": work.bilinear, "bilinear_bwd": work.bilinear},
            ("bilinear_kernel", "bilinear_bwd_kernel", "bilinear_bwd_merge_kernel"))
GROUP_NORM = ({"group_norm": work.group_norm}, ("gn_stats_kernel", "gn_apply_kernel"))
