"""The port's VideoUNet (Stable Video Diffusion) against the plain reference
``tests/reference/svd_reference.py`` at a tiny size on the CPU, on seeded
random weights in the published checkpoint's layout, converted by the
port's own ``convert_svd_state_dict``; and its structure: with every frame
marked image-only it is its spatial network frame by frame, without it
the order of the frames matters.

Tolerances: both sides compute in float32 on the CPU, with different
layouts (NHWC against NCHW convolutions, the kernel's layout of attention
against blocked matmuls) and so different reduction orders, which leave
about 1e-6 of relative gap through a tiny network (measured); 1e-4 leaves
room for other BLAS builds and still fails any wrong term, which moves the
output by percents.
"""
import dataclasses

import pytest
import torch

from custom_diffusion360_torch.diffusion.guiders import linear_prediction_guider
from custom_diffusion360_torch.engine import Engine
from custom_diffusion360_torch.io import torch_convert as tc
from custom_diffusion360_torch.io.torch_convert import convert_svd_state_dict
from custom_diffusion360_torch.models import nn as tnn
from custom_diffusion360_torch.models import transformer as ttr
from custom_diffusion360_torch.models import unet as tunet
from custom_diffusion360_torch.models import unet_graphs
from custom_diffusion360_torch.models.clip import ClipVisionConfig
from custom_diffusion360_torch.models.vae import VAEConfig
from tests.reference import svd_reference as R
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

REL = 1e-4  # see the module's docstring
UNET = dict(in_channels=8, model_channels=32, out_channels=4, num_res_blocks=1,
            attention_resolutions=(1, 2), channel_mult=(1, 2), num_head_channels=16,
            transformer_depth=1, context_dim=32, adm_in_channels=24, merge_factor=0.5,
            video_kernel_size=(3, 1, 1))
VAE = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=4, in_channels=3, out_ch=3)
VISION = dict(image_size=28, patch_size=14, width=64, layers=2, heads=4, mlp_ratio=4,
              output_dim=32)
OUTDIM = 8  # 3 x 8 = adm_in_channels
UNET_CFG = tunet.VideoUNetConfig(
    in_channels=8, model_channels=32, out_channels=4, num_res_blocks=1,
    attention_resolutions=(1, 2), channel_mult=(1, 2), transformer_depth=(1, 1), context_dim=32,
    adm_in_channels=24, num_head_channels=16)
VAE_CFG = VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, scale_factor=0.18215)
VISION_CFG = ClipVisionConfig(image_size=28, patch_size=14, width=64, layers=2, heads=4,
                              embed_dim=32)


def rel(got, want):
    return float((got - want).norm() / want.norm())


def seeded_state_dict(module, seed=0, mix_factor=0.5):
    """The module's state dict with every leaf drawn from ``seed``: weights
    N(0, 1 / fan_in), biases N(0, 0.1^2), norm scales 1 + N(0, 0.1^2) (so
    that no leaf is zero: a zero-initialised output layer matches anything),
    every blend's mix_factor at ``mix_factor``."""
    g = torch.Generator().manual_seed(seed)
    norms = {f"{m}.weight" for m, mod in module.named_modules()
             if isinstance(mod, (torch.nn.GroupNorm, torch.nn.LayerNorm))}
    sd = {}
    for k, v in module.state_dict().items():
        x = torch.randn(v.shape, generator=g)
        if k.endswith("mix_factor"):
            sd[k] = torch.full(v.shape, float(mix_factor))
        elif k in norms:
            sd[k] = 1.0 + 0.1 * x
        elif v.dim() == 1:
            sd[k] = 0.1 * x
        else:
            sd[k] = x / v[0].numel() ** 0.5
    return sd


def tiny_svd(seed=0, mix_factor=0.5):
    """(reference module with seeded weights, the port's params of the same
    leaves)."""
    ref = R.SVDReference(UNET, VAE, VISION, outdim=OUTDIM)
    sd = seeded_state_dict(ref, seed, mix_factor)
    ref.load_state_dict(sd)
    return ref.eval(), convert_svd_state_dict(sd, UNET_CFG, VAE_CFG, VISION_CFG)


def unet_inputs(clips=2, frames=3, h=8, w=12, seed=1):
    g = torch.Generator().manual_seed(seed)
    n = clips * frames
    return (torch.randn(n, 8, h, w, generator=g), torch.randn(n, generator=g),
            torch.randn(n, 1, 32, generator=g), torch.randn(n, 24, generator=g))


@pytest.fixture(scope="module")
def svd():
    return tiny_svd()


def test_conv_time_is_a_zero_padded_conv3d_over_the_frames():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2 * 5, 3, 4, 8, generator=g)  # (B T, H, W, C)
    p = {"w": torch.randn(6, 8, 3, 1, 1, generator=g), "b": torch.randn(6, generator=g)}
    want = torch.nn.functional.conv3d(x.reshape(2, 5, 3, 4, 8).permute(0, 4, 1, 2, 3), p["w"],
                                      p["b"], padding=(1, 0, 0))
    got = tnn.conv_time(p, x, 5)
    assert rel(got, want.permute(0, 2, 3, 4, 1).reshape(10, 3, 4, 6)) < REL


@pytest.mark.parametrize("out_channels", [32, 64])  # identity skip / 1x1 conv skip
def test_video_resblock_matches_reference(out_channels):
    ref = R.VideoResBlock(32, 128, out_channels, (3, 1, 1), 0.5)
    sd = seeded_state_dict(ref, 3)
    ref.load_state_dict(sd)
    params = tc._video_resblock({"b." + k: v for k, v in sd.items()}, "b")
    g = torch.Generator().manual_seed(4)
    x, emb = torch.randn(6, 32, 4, 5, generator=g), torch.randn(6, 128, generator=g)
    ind = torch.tensor([[0.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    with torch.no_grad():
        want = ref(x, emb, 3, ind)
    got = tunet._video_resblock_apply(params, x.permute(0, 2, 3, 1), emb, 3,
                                      ind.reshape(-1).bool())
    assert rel(got.permute(0, 3, 1, 2), want) < REL


@pytest.mark.parametrize("depth", [1, 2])
def test_spatial_video_transformer_matches_reference(depth):
    ref = R.SpatialVideoTransformer(32, 2, 16, depth, 24, 0.5)
    sd = seeded_state_dict(ref, 5)
    ref.load_state_dict(sd)
    cfg = tunet.VideoUNetConfig(model_channels=32, context_dim=24, num_head_channels=16)
    params = tc._video_transformer({"t." + k: v for k, v in sd.items()}, "t", cfg, 32, depth, 0)
    g = torch.Generator().manual_seed(6)
    x, ctx = torch.randn(6, 32, 4, 5, generator=g), torch.randn(6, 2, 24, generator=g)
    ind = torch.zeros(2, 3)
    with torch.no_grad():
        want = ref(x, ctx, 3, ind)
    got = ttr.spatial_video_transformer_apply(
        params, x.permute(0, 2, 3, 1), ctx, cfg.transformer_config(32, depth, 0), 3,
        ind.reshape(-1).bool())
    assert rel(got.permute(0, 3, 1, 2), want) < REL


@pytest.mark.parametrize("indicator", ["video", "mixed"])
def test_video_unet_matches_reference(svd, indicator):
    ref, params = svd
    x, t, ctx, y = unet_inputs()
    ind = torch.zeros(2, 3) if indicator == "video" else torch.tensor([[0.0, 1, 0], [1, 1, 0]])
    with torch.no_grad():
        want = ref.model.diffusion_model(x, t, ctx, y, 3, ind)
    got, _ = tunet.unet_apply(params["unet"], UNET_CFG, x.permute(0, 2, 3, 1), t, ctx, y,
                              num_video_frames=3, image_only_indicator=ind)
    assert rel(got.permute(0, 3, 1, 2), want) < REL


def test_image_only_is_the_spatial_network_frame_by_frame(svd):
    """Every frame image-only: each alpha is 1 and each blend returns its
    spatial branch exactly (1 x a + 0 x b), so the output is the spatial
    network's (the same leaves under a non-video config, which reads only
    the spatial ones) to the bit; and that network treats each frame alone
    (frame by frame within REL: one-frame batches change the GEMMs'
    blocking, not the sums)."""
    _, params = svd
    x, t, ctx, y = unet_inputs()
    x = x.permute(0, 2, 3, 1)
    video, _ = tunet.unet_apply(params["unet"], UNET_CFG, x, t, ctx, y, num_video_frames=3,
                                image_only_indicator=torch.ones(2, 3))
    spatial_cfg = tunet.UNetConfig(**dataclasses.asdict(UNET_CFG))
    spatial, _ = tunet.unet_apply(params["unet"], spatial_cfg, x, t, ctx, y)
    assert torch.equal(video, spatial)
    frames = [tunet.unet_apply(params["unet"], spatial_cfg, x[i:i + 1], t[i:i + 1],
                               ctx[i:i + 1], y[i:i + 1])[0] for i in range(6)]
    assert rel(torch.cat(frames), spatial) < REL


def test_frame_order_matters_only_through_the_temporal_layers(svd):
    """Reversing the frames of each clip: without the image-only marks the
    output is not the reversed output (the frame-position embedding and
    the temporal convolutions see the order); with them it is, exactly."""
    _, params = svd
    x, t, ctx, y = unet_inputs()
    x = x.permute(0, 2, 3, 1)
    order = torch.tensor([2, 1, 0, 5, 4, 3])

    def run(ind, perm):
        out, _ = tunet.unet_apply(params["unet"], UNET_CFG, x[perm], t[perm], ctx[perm], y[perm],
                                  num_video_frames=3, image_only_indicator=ind)
        return out

    same = torch.arange(6)
    video = run(torch.zeros(2, 3), same)
    assert rel(run(torch.zeros(2, 3), order), video[order]) > 1e-3
    image = run(torch.ones(2, 3), same)
    assert torch.equal(run(torch.ones(2, 3), order), image[order])


def test_the_converter_reads_every_leaf_of_the_checkpoint(svd):
    ref, _ = svd

    class Seen(dict):
        used = set()

        def __getitem__(self, k):
            self.used.add(k)
            return super().__getitem__(k)

    sd = Seen(ref.state_dict())
    convert_svd_state_dict(sd, UNET_CFG, VAE_CFG, VISION_CFG)
    assert set(sd) - Seen.used == set()


def test_the_graphs_do_not_engage_on_the_video_network(svd, monkeypatch):
    """The video path runs no cached phase, so ``Engine.sample`` never asks
    ``unet_graphs`` for a graph, and the engagement rule says no without
    render caches on any device."""
    assert not unet_graphs.engages("cuda", None)
    assert not unet_graphs.engages("cpu", None)

    def refuse(*args, **kwargs):
        raise AssertionError("the video network asked for CUDA graphs")

    monkeypatch.setattr(unet_graphs.CachedUNetGraphs, "network", refuse)
    from tests.test_torch_svd_engine import engine_config, sample_inputs

    _, params = svd
    eng = Engine(engine_config(), device="cpu")
    c, uc, noise = sample_inputs(params)
    z = eng.sample(params, c, uc, linear_prediction_guider(2.5, 3), noise=noise, num_steps=2,
                   num_frames=3)
    assert torch.isfinite(z).all()
