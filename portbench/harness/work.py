"""Operations and bytes of one kernel launch, from the shape its wrapper
counted (``launches_by_shape`` of the port's op wrappers), and the bound
each gives. The counts are what the inputs need, not what a kernel reads:
each input byte once, each output byte once."""
from __future__ import annotations

from .peaks import BF16_FLOPS, F32_FLOPS, bound_s

ITEMSIZE = {"bf16": 2, "f32": 4}


def needed_channels(c: int) -> int:
    """The FeatureNeRF maps carry dim + 1 channels padded to a multiple of
    8; the work counts the dim + 1 (320 -> 641 of 648, 640 -> 1281 of 1288,
    1280 -> 2561 of 2568)."""
    return {648: 641, 1288: 1281, 2568: 2561}.get(c, c)


def attention(b, h, n, m, d, kv_len, layout=None, itemsize=2):
    """``attention_fwd`` keys (b, h, n, m, d, kv_len, layout): QK^T and PV
    over the live keys; q, k, v read once, the output written once."""
    flops = 4.0 * b * h * n * kv_len * d
    nbytes = itemsize * (2 * b * h * n * d + 2 * b * h * kv_len * d)
    return bound_s(nbytes, flops, BF16_FLOPS)


def attention_bnhd(b, n, h, m, d, kv_len, itemsize=2):
    """``attention_bnhd_fwd`` keys (b, n, h, m, d, kv_len)."""
    return attention(b, h, n, m, d, kv_len, itemsize=itemsize)


def bilinear(m, h, w, c, p, dtype):
    """``bilinear_sample`` / ``bilinear_sample_bwd`` keys (M, H, W, C, P,
    dtype): the maps (or their gradient) once, the grid once, the samples
    (or their gradient) once; 8 operations a sampled channel (4 taps, a
    multiply and an add each) on the f32 CUDA cores."""
    c_need, isz = needed_channels(c), ITEMSIZE[dtype]
    nbytes = m * h * w * c_need * isz + m * p * 2 * 4 + m * p * c_need * isz
    return bound_s(nbytes, 8.0 * m * p * c_need, F32_FLOPS)


def group_norm(n, hw, c, groups, act, dtype, param_itemsize=2):
    """``group_norm_fused`` keys (N, HW, C, G, act, dtype): x read once, y
    written once, scale and bias once; 10 operations an element (14 with
    SiLU) on the f32 CUDA cores."""
    numel, isz = n * hw * c, ITEMSIZE[dtype]
    nbytes = 2 * numel * isz + 2 * c * param_itemsize
    return bound_s(nbytes, (14.0 if act == "silu" else 10.0) * numel, F32_FLOPS)


def layer_norm(rows, c, dtype, param_dtype):
    """``layer_norm_fused`` keys (rows, C, dtype, param dtype)."""
    numel = rows * c
    nbytes = 2 * numel * ITEMSIZE[dtype] + 2 * c * ITEMSIZE[param_dtype]
    return bound_s(nbytes, 8.0 * numel, F32_FLOPS)


def conv3x3(b, h, w, c, n, itemsize=2):
    """``conv3x3_fwd`` keys (B, H, W, C, N): an implicit GEMM, SAME padding."""
    nbytes = itemsize * (b * h * w * c + 9 * c * n + b * h * w * n)
    return bound_s(nbytes, 2.0 * b * h * w * n * 9 * c, BF16_FLOPS)
