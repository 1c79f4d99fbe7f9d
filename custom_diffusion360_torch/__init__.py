"""PyTorch/CUDA port of custom_diffusion360_tpu for one NVIDIA H100.

Mirrors the JAX package's layout (geometry/ ops/ models/ diffusion/ io/
engine.py) with the same module and function names. Parameters are nested
dicts of tensors keyed by the JAX tree paths (io/from_jax.py); linear weights
stay (in, out), conv kernels are OIHW. Activations keep the JAX layouts at
public functions: NHWC latents and images, (b, n, h, d) attention.

The hand-written Hopper kernels live in csrc/ and are built with nvcc at
first use (ops/_build.py). Entry points default to ``device="cuda"`` and
raise when no CUDA device is present; pass ``device="cpu"`` to run every
kernel's plain PyTorch version on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``; raises for CUDA when none is available
    (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' explicitly to run the plain versions on the CPU"
        )
    return dev
