"""Stable Video Diffusion through the port's normal path against the plain
reference ``tests/reference/svd_reference.py``, at a tiny size on the CPU:
``VScalingWithEDMNoise`` and the denoiser that hands its c_noise to the
network, the EDM schedule at sigma_max 700, sgm's CLIP image preprocess,
the video conditioner (crossattn, vector, concat, with the unconditional
rows zeroed), and ``Engine.sample`` under ``linear_prediction_guider``
with ``Engine.decode_first_stage``.

Tolerances: float32 on both sides, as ``test_torch_video_unet.py`` says
(about 1e-6 relative measured, bound 1e-4); the schedule to float32
rounding (the port computes it in float64 and rounds once, the source in
float32).
"""
import pytest
import torch

from custom_diffusion360_torch.diffusion.denoiser import Denoiser, DenoiserConfig
from custom_diffusion360_torch.diffusion.guiders import linear_prediction_guider
from custom_diffusion360_torch.diffusion.scaling import get_scaling
from custom_diffusion360_torch.engine import Engine, EngineConfig
from custom_diffusion360_torch.models import embedders as temb
from custom_diffusion360_torch.models import general_conditioner as gc
from tests.reference import svd_reference as R
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)
from tests.test_torch_video_unet import (OUTDIM, REL, UNET_CFG, VAE_CFG, VISION_CFG, rel,
                                         tiny_svd)

pytestmark = pytest.mark.usefixtures("torch_threads")

FRAMES = 3
COND_CFG = gc.VideoConditionerConfig(vision=VISION_CFG, vae=VAE_CFG, outdim=OUTDIM)


def engine_config(steps=3):
    return EngineConfig(
        unet=UNET_CFG, vae=VAE_CFG, conditioner=COND_CFG,
        denoiser=DenoiserConfig(scaling="VScalingWithEDMNoise", discrete=False),
        discretization_name="edm", sigma_max=700.0, num_sample_steps=steps)


def images(seed=2, h=16, w=24):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(1, h, w, 3, generator=g) * 2 - 1, torch.randn(1, h, w, 3, generator=g)


def sample_inputs(params, seed=2):
    """The port's (c, uc) of a seeded clip and its initial noise."""
    image, cond_noise = images(seed)
    batch = gc.video_batch(image, cond_noise, FRAMES, 6, 127, 0.02)
    c, uc = gc.video_conditioning(params["conditioner"], COND_CFG, batch, FRAMES)
    noise = torch.randn(FRAMES, 8, 12, 4, generator=torch.Generator().manual_seed(seed + 1))
    return c, uc, noise


def nchw(t):
    return t.permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def svd():
    return tiny_svd()


@pytest.mark.parametrize("sigma", [0.002, 0.7, 30.0, 700.0])
def test_v_scaling_with_edm_noise(sigma):
    s = torch.tensor([sigma])
    for got, want in zip(get_scaling("VScalingWithEDMNoise")(s), R.v_scaling_with_edm_noise(s)):
        assert torch.allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("scaling,scaled", [("VScalingWithEDMNoise", True), ("v_edm_noise", True),
                                            ("v", False), ("edm", False), ("eps", False)])
def test_the_denoiser_hands_the_network_its_c_noise(scaling, scaled):
    """Under ``VScalingWithEDMNoise`` the network gets its c_noise, 0.25 ln
    sigma (sgm's Denoiser), from the scaling's name alone; under every other
    scaling sigma, as in every existing configuration."""
    seen = []

    def network(x, t, cond):
        seen.append(t)
        return torch.zeros_like(x), {}

    d = Denoiser(DenoiserConfig(scaling=scaling, discrete=False))
    sigma = torch.tensor([0.5, 700.0])
    d(network, torch.ones(2, 2, 2, 4), sigma, {})
    assert torch.allclose(seen[0], 0.25 * sigma.log() if scaled else sigma)


def test_edm_schedule_at_sigma_max_700():
    got = Engine(engine_config(25), device="cpu").sigmas(25)
    want = R.edm_sigmas(25, sigma_max=700.0)
    assert float(got[0]) == pytest.approx(700.0, rel=1e-6)
    assert torch.allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("size", [(576, 1024), (120, 300), (224, 224)])
def test_clip_preprocess_is_sgms(size):
    """kornia's antialiased bicubic resize (both axes shrinking, one
    growing, none), then the CLIP normalisation."""
    g = torch.Generator().manual_seed(3)
    x = torch.rand(2, 3, *size, generator=g) * 2 - 1
    want = R.kornia_resize(x, (224, 224))
    want = ((want + 1) / 2 - torch.tensor(R.CLIP_MEAN)[:, None, None]) / torch.tensor(
        R.CLIP_STD)[:, None, None]
    got = temb.sgm_clip_image_preprocess(x.permute(0, 2, 3, 1), 224)
    assert rel(nchw(got), want) < REL


def test_conditioner_matches_reference(svd):
    ref, params = svd
    image, cond_noise = images()
    c, uc = gc.video_conditioning(params["conditioner"], COND_CFG,
                                  gc.video_batch(image, cond_noise, FRAMES, 6, 127, 0.02), FRAMES)
    with torch.no_grad():
        rc, ruc = R.conditioning(ref, R.video_batch(nchw(image), nchw(cond_noise), FRAMES, 6, 127,
                                                    0.02), FRAMES)
    assert set(c) == set(rc) == {"crossattn", "vector", "concat"}
    assert c["crossattn"].shape == (FRAMES, 1, 32) and c["vector"].shape == (FRAMES, 24)
    for k in rc:
        got = nchw(c[k]) if c[k].dim() == 4 else c[k]
        assert rel(got, rc[k]) < REL, k
    assert torch.equal(uc["vector"], c["vector"])
    assert not uc["crossattn"].any() and not uc["concat"].any()


@pytest.mark.parametrize("frames", [2, 3])
def test_engine_sample_matches_reference(svd, frames):
    """A 3-step ``Engine.sample`` of one clip under the per-frame guider,
    then ``decode_first_stage`` of all its frames, against the reference's
    Euler EDM sampler and decode."""
    ref, params = svd
    image, cond_noise = images()
    c, uc = gc.video_conditioning(params["conditioner"], COND_CFG,
                                  gc.video_batch(image, cond_noise, frames, 6, 127, 0.02), frames)
    noise = torch.randn(frames, 8, 12, 4, generator=torch.Generator().manual_seed(4))
    eng = Engine(engine_config(), device="cpu")
    z = eng.sample(params, c, uc, linear_prediction_guider(2.5, frames), noise=noise,
                   num_frames=frames)
    img = eng.decode_first_stage(params, z)
    with torch.no_grad():
        rc, ruc = R.conditioning(ref, R.video_batch(nchw(image), nchw(cond_noise), frames, 6, 127,
                                                    0.02), frames)
        rz = ref.sample(rc, ruc, nchw(noise), 3, R.LinearPredictionGuider(2.5, frames), frames)
        rimg = ref.decode_first_stage(rz, decoding_t=frames)
    assert rel(nchw(z), rz) < REL
    assert img.shape == (frames, 16, 24, 3)
    assert rel(nchw(img), rimg) < REL


def test_init_params_has_the_checkpoints_tree(svd):
    """``Engine.init_params`` of the video config makes the tree the
    checkpoint converter makes: the same leaves, shapes and blends' start."""
    _, params = svd
    init = Engine(engine_config(), device="cpu").init_params(seed=0)

    def shapes(tree, path=""):
        if isinstance(tree, dict):
            return {k: v for n, t in tree.items() for k, v in shapes(t, f"{path}/{n}").items()}
        if isinstance(tree, list):
            return {k: v for i, t in enumerate(tree) for k, v in shapes(t, f"{path}/{i}").items()}
        return {path: tuple(tree.shape)}

    assert shapes(init) == shapes(params)
    mix = [v for k, v in init["unet"]["input_blocks"][1][0].items() if k == "mix_factor"]
    assert float(mix[0]) == 0.5
