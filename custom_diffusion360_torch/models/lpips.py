"""LPIPS perceptual distance on a VGG16 backbone (port of
custom_diffusion360_tpu/models/lpips.py).

Five VGG16 feature slices ending at relu1_2 / relu2_2 / relu3_3 / relu4_3 /
relu5_3; each slice's features are unit-normalized along channels, their
squared difference goes through a learned 1x1 head, and the spatial means
are summed. NHWC activations, OIHW kernels keyed by torchvision's
``features`` indices (``{"vgg": {"0": {"w", "b"}, ...}, "lins": [5 x (C,)]}``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import resolve_device
from .nn import Init, conv2d

# torchvision vgg16 .features conv indices per slice
VGG_SLICES = [(0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28)]
CHNS = [64, 128, 256, 512, 512]

# the ScalingLayer's shift and scale
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def init_lpips_params(init: Init):
    """Random parameters with the loader's structure: 3x3 kernels
    N(0, 0.05^2), zero biases, heads |N(0, 0.01^2)|."""
    params = {"vgg": {}, "lins": []}
    in_ch = 3
    for slice_ids, out_ch in zip(VGG_SLICES, CHNS):
        for idx in slice_ids:
            params["vgg"][str(idx)] = {"w": init.normal((out_ch, in_ch, 3, 3), 0.05),
                                       "b": init.zeros((out_ch,))}
            in_ch = out_ch
        params["lins"].append(init.normal((out_ch,), 0.01).abs())
    return params


def _maxpool2(x):
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def vgg_features(params, x):
    """x: (B, H, W, 3) -> the five relu feature maps (NHWC)."""
    feats = []
    for si, slice_ids in enumerate(VGG_SLICES):
        if si > 0:
            x = _maxpool2(x)
        for idx in slice_ids:
            x = F.relu(conv2d(params["vgg"][str(idx)], x))
        feats.append(x)
    return feats


def _unit_norm(t, eps=1e-10):
    n = torch.sqrt((t.float() ** 2).sum(-1, keepdim=True))
    return t / (n + eps).to(t.dtype)


def lpips_apply(params, x, y):
    """Learned perceptual distance of x and y, (B, H, W, 3) in [-1, 1] ->
    (B,), computed in x.dtype."""
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
    fx = vgg_features(params, (x - shift) / scale)
    fy = vgg_features(params, (y - shift) / scale)
    val = 0.0
    for si in range(len(CHNS)):
        d = (_unit_norm(fx[si]) - _unit_norm(fy[si])) ** 2
        val = val + (d @ params["lins"][si].to(d.dtype)).mean((1, 2))
    return val


def load_lpips_torch(lpips_ckpt: str, vgg_ckpt: str, device="cuda"):
    """Read the torch weights: ``vgg_ckpt`` a torchvision vgg16 state dict
    (``features.N.weight`` OIHW), ``lpips_ckpt`` the taming "vgg.pth" heads
    (``lin{k}.model.1.weight``, (1, C, 1, 1)). Kernels stay OIHW, f32."""
    dev = resolve_device(device)
    vgg_sd = torch.load(vgg_ckpt, map_location="cpu", weights_only=True)
    lp_sd = torch.load(lpips_ckpt, map_location="cpu", weights_only=True)

    def arr(t):
        return t.detach().to(dev, torch.float32).contiguous()

    params = {"vgg": {}, "lins": []}
    for slice_ids in VGG_SLICES:
        for idx in slice_ids:
            params["vgg"][str(idx)] = {"w": arr(vgg_sd[f"features.{idx}.weight"]),
                                       "b": arr(vgg_sd[f"features.{idx}.bias"])}
    for k in range(len(CHNS)):
        params["lins"].append(arr(lp_sd[f"lin{k}.model.1.weight"][0, :, 0, 0]))
    return params
