"""Plain PyTorch reference of the Custom Diffusion 360 model: a frozen copy
of the port's model code with every kernel path cut out. Norms, attention,
bilinear sampling and convolutions are the plain PyTorch forms on every
device; the x3 render dedupe and the prefix dedupe are off, so every guider
copy is computed. It imports nothing of the port and nothing of JAX."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    return torch.device(device)
