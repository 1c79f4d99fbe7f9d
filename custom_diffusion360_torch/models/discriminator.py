"""PatchGAN discriminator, ActNorm and the GAN losses of the autoencoder
trainer (port of custom_diffusion360_tpu/models/discriminator.py).

NHWC activations, OIHW kernels. BatchNorm takes per-batch f32 statistics
on every call (the discriminator trains; there is no running-statistics
path), so real and fake images go through separate calls. ActNorm's
data-dependent init is an explicit ``actnorm_init_from_batch`` that
returns the parameters.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import resolve_device
from .nn import Init, conv2d

# ---------------------------------------------------------------------------
# ActNorm
# ---------------------------------------------------------------------------


def actnorm_init(init: Init, num_features: int):
    return {"loc": init.zeros((num_features,)), "scale": init.ones((num_features,))}


def actnorm_init_from_batch(x):
    """loc = -mean, scale = 1 / (std + 1e-6) per channel over (N, H, W),
    std unbiased."""
    flat = x.reshape(-1, x.shape[-1]).float()
    return {"loc": -flat.mean(0), "scale": 1.0 / (flat.std(0, unbiased=True) + 1e-6)}


def actnorm_apply(p, x, logdet=False, reverse=False):
    """x: (..., C) -> h (and the per-sample log-determinant when asked)."""
    if reverse:
        return x / p["scale"] - p["loc"]
    h = p["scale"] * (x + p["loc"])
    if logdet:
        hw = math.prod(x.shape[1:-1]) if x.dim() > 2 else 1
        ld = hw * torch.log(p["scale"].abs()).sum()
        return h, ld.to(x.dtype).expand(x.shape[0])
    return h


# ---------------------------------------------------------------------------
# NLayerDiscriminator
# ---------------------------------------------------------------------------


def init_discriminator_params(init: Init, input_nc=3, ndf=64, n_layers=3, use_actnorm=False):
    """4x4 convs (stride 2, the last block and head stride 1), norm and
    LeakyReLU(0.2), a one-channel head. Convs N(0, 0.02); BatchNorm scales
    N(1, 0.02); a block's conv has a bias only under ActNorm."""

    def conv(cin, cout, bias):
        p = {"w": init.normal((cout, cin, 4, 4), 0.02)}
        if bias:
            p["b"] = init.zeros((cout,))
        return p

    def norm(c):
        if use_actnorm:
            return actnorm_init(init, c)
        return {"scale": init.normal((c,), 0.02) + 1.0, "bias": init.zeros((c,))}

    params = {"conv_in": conv(input_nc, ndf, True), "blocks": []}
    mult_prev = 1
    for n in range(1, n_layers + 1):
        mult = min(2 ** n, 8)
        params["blocks"].append({"conv": conv(ndf * mult_prev, ndf * mult, use_actnorm),
                                 "norm": norm(ndf * mult)})
        mult_prev = mult
    params["conv_out"] = conv(ndf * mult_prev, 1, True)
    return params


def _conv4(p, x, stride):
    return conv2d(p, x, stride=stride, padding=((1, 1), (1, 1)))


def _batch_norm(p, x, eps=1e-5):
    """Statistics of this batch over (N, H, W) in f32, as torch's BatchNorm2d
    in training."""
    xf = x.float()
    mean = xf.mean((0, 1, 2))
    var = xf.var((0, 1, 2), unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def _leaky_relu(x):
    return F.leaky_relu(x, 0.2)


def _logit_map_shape(x_shape, n_layers):
    """(B, H', W', 1) of the patch logits, each side through the 4x4 / pad-1
    convs' strides; a side reaches 0 below the receptive field."""
    sides = list(x_shape[1:3])
    for stride in [2] * n_layers + [1, 1]:
        sides = [max(0, (s - 2) // stride + 1) if s else 0 for s in sides]
    return (x_shape[0], *sides, 1)


def discriminator_apply(params, x, n_layers=3, use_actnorm=False):
    """x: (B, H, W, C) -> (B, H', W', 1) patch logits."""
    out_shape = _logit_map_shape(tuple(x.shape), n_layers)
    if 0 in out_shape:
        # below the receptive field the patch-logit map is empty, and a mean
        # over it is NaN
        raise ValueError(f"discriminator input {tuple(x.shape)} too small for n_layers="
                         f"{n_layers}: patch-logit map has shape {out_shape}")
    h = _leaky_relu(_conv4(params["conv_in"], x, 2))
    for i, blk in enumerate(params["blocks"]):
        h = _conv4(blk["conv"], h, 2 if i < n_layers - 1 else 1)
        h = actnorm_apply(blk["norm"], h) if use_actnorm else _batch_norm(blk["norm"], h)
        h = _leaky_relu(h)
    return _conv4(params["conv_out"], h, 1)


# ---------------------------------------------------------------------------
# GAN losses
# ---------------------------------------------------------------------------


def hinge_d_loss(logits_real, logits_fake):
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real, logits_fake):
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def load_discriminator_torch(state_dict, n_layers=3, use_actnorm=False, device="cuda"):
    """A torch NLayerDiscriminator's ``main.{i}`` state dict -> parameters,
    f32, kernels kept OIHW: conv_in at 0, block k's conv at 2 + 3k and its
    norm at 3 + 3k, the head at 2 + 3 n_layers."""
    dev = resolve_device(device)

    def arr(name):
        return torch.as_tensor(state_dict[name]).detach().to(dev, torch.float32).contiguous()

    def conv(idx):
        p = {"w": arr(f"main.{idx}.weight")}
        if f"main.{idx}.bias" in state_dict:
            p["b"] = arr(f"main.{idx}.bias")
        return p

    def norm(idx):
        if use_actnorm:
            return {"loc": arr(f"main.{idx}.loc").reshape(-1),
                    "scale": arr(f"main.{idx}.scale").reshape(-1)}
        return {"scale": arr(f"main.{idx}.weight"), "bias": arr(f"main.{idx}.bias")}

    return {"conv_in": conv(0),
            "blocks": [{"conv": conv(2 + 3 * k), "norm": norm(3 + 3 * k)}
                       for k in range(n_layers)],
            "conv_out": conv(2 + 3 * n_layers)}
