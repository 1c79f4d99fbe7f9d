"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates) and the least time an operation could take on it."""
from __future__ import annotations

BF16_FLOPS = 989e12  # tensor cores, bf16 and fp16
F32_FLOPS = 67e12  # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, flops: float, peak: float = BF16_FLOPS) -> float:
    """The least seconds: each input byte read once and each output byte
    written once at the HBM rate, or the operations at ``peak``, whichever
    is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)
