"""Functional InceptionV3 pool3 feature extractor, the FID variant (port of
custom_diffusion360_tpu/eval/inception.py).

pytorch_fid's InceptionV3: torchvision's Inception3 with the three patches
that keep the original TF-FID weights' arithmetic: the 3 x 3 average pools
leave the padding out of the count (``count_include_pad=False``) and
Mixed_7c's pool branch is a MAX pool. Parameters are keyed by the torch
module names, so pytorch_fid's ``pt_inception-2015-12-05`` checkpoint
loads through ``load_inception_torch``; a JAX tree carries across through
``io.from_jax`` (its HWIO conv kernels become OIHW ``"w"`` leaves). The
input contract is the JAX package's: NHWC images, resized to 299 x 299 by
the antialiased linear resize of ``jax.image.resize`` (ops/image_resize.py)
and, with ``normalize_input``, mapped from [0, 1] to [-1, 1].

The convolutions are ``lax.conv`` in the JAX package, with VALID or
asymmetric padding and strides, not its Pallas conv3x3, so they are
``F.conv2d`` here (cuDNN on the card). They run in float32 with cuDNN's
TF32 off (``inception_pool3_features``), whatever the caller's setting, so
the features on the card are float32 features.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.image_resize import resize_images

# (name, cin, cout, (kh, kw), stride, (ph, pw)) per conv of each block.
_STEM = [
    ("Conv2d_1a_3x3", 3, 32, (3, 3), 2, (0, 0)),
    ("Conv2d_2a_3x3", 32, 32, (3, 3), 1, (0, 0)),
    ("Conv2d_2b_3x3", 32, 64, (3, 3), 1, (1, 1)),
    # maxpool1 3x3 s2 sits here
    ("Conv2d_3b_1x1", 64, 80, (1, 1), 1, (0, 0)),
    ("Conv2d_4a_3x3", 80, 192, (3, 3), 1, (0, 0)),
    # maxpool2 3x3 s2 sits here
]


def _inception_a(cin, pool_features):
    return {
        "branch1x1": [(cin, 64, (1, 1), 1, (0, 0))],
        "branch5x5": [(cin, 48, (1, 1), 1, (0, 0)),
                      (48, 64, (5, 5), 1, (2, 2))],
        "branch3x3dbl": [(cin, 64, (1, 1), 1, (0, 0)),
                         (64, 96, (3, 3), 1, (1, 1)),
                         (96, 96, (3, 3), 1, (1, 1))],
        "branch_pool": [(cin, pool_features, (1, 1), 1, (0, 0))],
    }


def _inception_b(cin):
    return {
        "branch3x3": [(cin, 384, (3, 3), 2, (0, 0))],
        "branch3x3dbl": [(cin, 64, (1, 1), 1, (0, 0)),
                         (64, 96, (3, 3), 1, (1, 1)),
                         (96, 96, (3, 3), 2, (0, 0))],
    }


def _inception_c(cin, c7):
    return {
        "branch1x1": [(cin, 192, (1, 1), 1, (0, 0))],
        "branch7x7": [(cin, c7, (1, 1), 1, (0, 0)),
                      (c7, c7, (1, 7), 1, (0, 3)),
                      (c7, 192, (7, 1), 1, (3, 0))],
        "branch7x7dbl": [(cin, c7, (1, 1), 1, (0, 0)),
                         (c7, c7, (7, 1), 1, (3, 0)),
                         (c7, c7, (1, 7), 1, (0, 3)),
                         (c7, c7, (7, 1), 1, (3, 0)),
                         (c7, 192, (1, 7), 1, (0, 3))],
        "branch_pool": [(cin, 192, (1, 1), 1, (0, 0))],
    }


def _inception_d(cin):
    return {
        "branch3x3": [(cin, 192, (1, 1), 1, (0, 0)),
                      (192, 320, (3, 3), 2, (0, 0))],
        "branch7x7x3": [(cin, 192, (1, 1), 1, (0, 0)),
                        (192, 192, (1, 7), 1, (0, 3)),
                        (192, 192, (7, 1), 1, (3, 0)),
                        (192, 192, (3, 3), 2, (0, 0))],
    }


def _inception_e(cin):
    return {
        "branch1x1": [(cin, 320, (1, 1), 1, (0, 0))],
        "branch3x3": [(cin, 384, (1, 1), 1, (0, 0))],
        "branch3x3_a": [(384, 384, (1, 3), 1, (0, 1))],
        "branch3x3_b": [(384, 384, (3, 1), 1, (1, 0))],
        "branch3x3dbl": [(cin, 448, (1, 1), 1, (0, 0)),
                         (448, 384, (3, 3), 1, (1, 1))],
        "branch3x3dbl_a": [(384, 384, (1, 3), 1, (0, 1))],
        "branch3x3dbl_b": [(384, 384, (3, 1), 1, (1, 0))],
        "branch_pool": [(cin, 192, (1, 1), 1, (0, 0))],
    }


# block name -> (kind, spec)
BLOCKS = [
    ("Mixed_5b", "A", _inception_a(192, 32)),
    ("Mixed_5c", "A", _inception_a(256, 64)),
    ("Mixed_5d", "A", _inception_a(288, 64)),
    ("Mixed_6a", "B", _inception_b(288)),
    ("Mixed_6b", "C", _inception_c(768, 128)),
    ("Mixed_6c", "C", _inception_c(768, 160)),
    ("Mixed_6d", "C", _inception_c(768, 160)),
    ("Mixed_6e", "C", _inception_c(768, 192)),
    ("Mixed_7a", "D", _inception_d(768)),
    ("Mixed_7b", "E", _inception_e(1280)),
    ("Mixed_7c", "E2", _inception_e(2048)),
]

# torch child-module names per conv in each branch list (for the importer)
_TORCH_NAMES = {
    "A": {"branch1x1": ["branch1x1"],
          "branch5x5": ["branch5x5_1", "branch5x5_2"],
          "branch3x3dbl": ["branch3x3dbl_1", "branch3x3dbl_2",
                           "branch3x3dbl_3"],
          "branch_pool": ["branch_pool"]},
    "B": {"branch3x3": ["branch3x3"],
          "branch3x3dbl": ["branch3x3dbl_1", "branch3x3dbl_2",
                           "branch3x3dbl_3"]},
    "C": {"branch1x1": ["branch1x1"],
          "branch7x7": ["branch7x7_1", "branch7x7_2", "branch7x7_3"],
          "branch7x7dbl": ["branch7x7dbl_1", "branch7x7dbl_2",
                           "branch7x7dbl_3", "branch7x7dbl_4",
                           "branch7x7dbl_5"],
          "branch_pool": ["branch_pool"]},
    "D": {"branch3x3": ["branch3x3_1", "branch3x3_2"],
          "branch7x7x3": ["branch7x7x3_1", "branch7x7x3_2", "branch7x7x3_3",
                          "branch7x7x3_4"]},
    "E": {"branch1x1": ["branch1x1"],
          "branch3x3": ["branch3x3_1"],
          "branch3x3_a": ["branch3x3_2a"],
          "branch3x3_b": ["branch3x3_2b"],
          "branch3x3dbl": ["branch3x3dbl_1", "branch3x3dbl_2"],
          "branch3x3dbl_a": ["branch3x3dbl_3a"],
          "branch3x3dbl_b": ["branch3x3dbl_3b"],
          "branch_pool": ["branch_pool"]},
}
_TORCH_NAMES["E2"] = _TORCH_NAMES["E"]

BN_EPS = 1e-3  # torchvision BasicConv2d BatchNorm eps


def _bc_init(gen, spec, device):
    _, cin, cout, (kh, kw), _, _ = spec
    w = torch.randn((cout, cin, kh, kw), generator=gen, device=device) * (kh * kw * cin) ** -0.5
    return {"w": w,
            "bn_scale": torch.ones((cout,), device=device),
            "bn_bias": torch.zeros((cout,), device=device),
            "bn_mean": torch.zeros((cout,), device=device),
            "bn_var": torch.ones((cout,), device=device)}


def _bc_apply(p, x, spec):
    """BasicConv2d on NCHW x: conv (no bias) + inference BN (eps 1e-3) +
    relu."""
    _, _, _, _, stride, (ph, pw) = spec
    y = F.conv2d(x, p["w"].to(x.dtype), stride=stride, padding=(ph, pw))
    inv = torch.rsqrt(p["bn_var"] + BN_EPS) * p["bn_scale"]
    shift = p["bn_bias"] - p["bn_mean"] * inv
    return F.relu(y * inv.to(y.dtype)[:, None, None] + shift.to(y.dtype)[:, None, None])


def _chain(bp, names, x, specs):
    for name, spec in zip(names, specs):
        x = _bc_apply(bp[name], x, spec)
    return x


def _avg_pool3_excl(x):
    """3 x 3 stride-1 pad-1 average pool, the padding left out of the count
    (the FIDInception patch)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool3_s2(x):
    return F.max_pool2d(x, 3, stride=2)


def init_inception_params(seed: int = 0, device="cuda"):
    """Seeded random parameters with the JAX tree's structure (conv kernels
    N(0, 1/fan_in) in OIHW, identity batch norms); the draws differ from
    JAX's."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    params = {spec[0]: _bc_init(gen, spec, device) for spec in _STEM}
    for bname, kind, spec in BLOCKS:
        bp = {}
        for branch, convs in spec.items():
            for tname, cspec in zip(_TORCH_NAMES[kind][branch], convs):
                bp[tname] = _bc_init(gen, (tname,) + cspec, device)
        params[bname] = bp
    return params


def _apply_block(bp, kind, spec, x):
    names = _TORCH_NAMES[kind]

    def run(branch, inp=x):
        return _chain(bp, names[branch], inp,
                      [(n,) + c for n, c in zip(names[branch], spec[branch])])

    if kind in ("A", "C"):
        pool = run("branch_pool", _avg_pool3_excl(x))
        mid = ("branch5x5", "branch3x3dbl") if kind == "A" else ("branch7x7", "branch7x7dbl")
        return torch.cat([run("branch1x1"), run(mid[0]), run(mid[1]), pool], dim=1)
    if kind == "B":
        return torch.cat([run("branch3x3"), run("branch3x3dbl"), _max_pool3_s2(x)], dim=1)
    if kind == "D":
        return torch.cat([run("branch3x3"), run("branch7x7x3"), _max_pool3_s2(x)], dim=1)
    # E / E2
    b3 = run("branch3x3")
    b3 = torch.cat([run("branch3x3_a", b3), run("branch3x3_b", b3)], dim=1)
    bd = run("branch3x3dbl")
    bd = torch.cat([run("branch3x3dbl_a", bd), run("branch3x3dbl_b", bd)], dim=1)
    # FIDInceptionE_2 (Mixed_7c) pools by MAX, E_1 (Mixed_7b) by the
    # exclusive average
    pooled = F.max_pool2d(x, 3, stride=1, padding=1) if kind == "E2" else _avg_pool3_excl(x)
    return torch.cat([run("branch1x1"), b3, bd, run("branch_pool", pooled)], dim=1)


def inception_pool3_features(params, images, resize_input: bool = True,
                             normalize_input: bool = False):
    """images: (B, H, W, 3) NHWC -> (B, 2048) f32 pool3 features.
    resize_input: the antialiased linear resize to 299 x 299 (pytorch_fid's
    InceptionV3.forward resizes); normalize_input: [0, 1] -> [-1, 1]."""
    x = images.float()
    if resize_input:
        x = resize_images(x, 299, "linear")
    if normalize_input:
        x = 2.0 * x - 1.0
    x = x.permute(0, 3, 1, 2).contiguous()
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        for i, spec in enumerate(_STEM):
            x = _bc_apply(params[spec[0]], x, spec)
            if i in (2, 4):  # after Conv2d_2b and Conv2d_4a
                x = _max_pool3_s2(x)
        for bname, kind, spec in BLOCKS:
            x = _apply_block(params[bname], kind, spec, x)
    return x.mean(dim=(2, 3))  # adaptive average pool to 1 x 1


def load_inception_torch(state_dict):
    """pytorch_fid / torchvision Inception3 state dict -> parameters (f32
    CPU tensors; conv kernels stay OIHW, the batch norms' running
    statistics come along)."""

    def arr(name):
        v = state_dict[name]
        return torch.as_tensor(v.detach().cpu() if hasattr(v, "detach") else v).float()

    def bc(prefix):
        return {"w": arr(f"{prefix}.conv.weight"), "bn_scale": arr(f"{prefix}.bn.weight"),
                "bn_bias": arr(f"{prefix}.bn.bias"), "bn_mean": arr(f"{prefix}.bn.running_mean"),
                "bn_var": arr(f"{prefix}.bn.running_var")}

    params = {spec[0]: bc(spec[0]) for spec in _STEM}
    for bname, kind, spec in BLOCKS:
        params[bname] = {tname: bc(f"{bname}.{tname}")
                         for branch in spec for tname in _TORCH_NAMES[kind][branch]}
    return params
