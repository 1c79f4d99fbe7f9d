"""The slice end to end: a 3-step pose-conditioned Engine.sample (CFG x2
vanilla_cfg_img_ref, 2 reference views from delta-style buffers, NeRF
rendered at step 0 and cached) followed by decode_first_stage, port vs a
live JAX Engine.sample on the same parameters, noise, cameras, buffers and
conditioning. f32; tolerance 1e-5 relative to the output scale."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.diffusion import vanilla_cfg_img_ref as j_guider
from custom_diffusion360_tpu.diffusion.denoiser import Denoiser as JDenoiser
from custom_diffusion360_tpu.diffusion.discretization import legacy_ddpm_sigmas as j_sigmas
from custom_diffusion360_tpu.engine import Engine as JEngine, EngineConfig as JEngineConfig
from custom_diffusion360_tpu.geometry.cameras import Cameras as JCams
from custom_diffusion360_tpu.io.delta import iter_pose_blocks
from custom_diffusion360_tpu.models.unet import UNetConfig as JUNetConfig, attn_block_meta
from custom_diffusion360_tpu.models.unet import init_unet_params
from custom_diffusion360_tpu.models.vae import VAEConfig as JVAEConfig, init_vae_params
from custom_diffusion360_torch.diffusion.denoiser import Denoiser
from custom_diffusion360_torch.diffusion.discretization import legacy_ddpm_sigmas
from custom_diffusion360_torch.diffusion.guiders import vanilla_cfg_img_ref
from custom_diffusion360_torch.engine import Engine, EngineConfig
from custom_diffusion360_torch.geometry.cameras import Cameras
from custom_diffusion360_torch.models.unet import UNetConfig
from custom_diffusion360_torch.models.vae import VAEConfig
from tests.test_cameras import random_cameras
from tests.test_torch_common import TINY_UNET, TINY_VAE, max_err, random_params, t, to_torch

B, NREF, LAT, STEPS = 1, 2, 8, 3


@pytest.fixture(scope="module")
def inputs():
    params = random_params(lambda k: {
        "unet": init_unet_params(k, JUNetConfig(**TINY_UNET)),
        "vae": init_vae_params(k, JVAEConfig(**TINY_VAE)),
    }, seed=11)
    rng = np.random.default_rng(12)
    meta = attn_block_meta(JUNetConfig(**TINY_UNET))
    refs = {}
    for _, _, attn_id, d in iter_pose_blocks(JUNetConfig(**TINY_UNET)):
        ds, ch, _ = meta[attn_id]
        refs.setdefault(attn_id, {})[d] = rng.normal(
            size=(NREF + 1, (LAT // ds) ** 2, ch)).astype(np.float32) * 0.5
    one = random_cameras(1 + NREF, seed=13)
    cams = [np.broadcast_to(np.asarray(f)[None], (2 * B,) + np.asarray(f).shape).copy()
            for f in one]  # one target pose tiled over the CFG copies
    cond = {"crossattn": rng.normal(size=(B, 16, 64)).astype(np.float32),
            "vector": rng.normal(size=(B, 32)).astype(np.float32)}
    uc = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in cond.items()}
    noise = rng.normal(size=(B, LAT, LAT, 4)).astype(np.float32)
    return params, refs, cams, cond, uc, noise


def test_sample_and_decode_match_jax(inputs):
    params, refs, cams, cond, uc, noise = inputs
    choices = np.arange(NREF)

    je = JEngine(JEngineConfig(unet=JUNetConfig(**TINY_UNET), vae=JVAEConfig(**TINY_VAE)))
    jp = jax.tree.map(jnp.asarray, params)
    z_j = je.sample(
        jp, jax.tree.map(jnp.asarray, cond), jax.tree.map(jnp.asarray, uc),
        j_guider(scale=7.5), jax.random.PRNGKey(0), shape=noise.shape,
        cams=JCams(*(jnp.asarray(c) for c in cams)),
        references=jax.tree.map(jnp.asarray, refs), choices=choices,
        num_steps=STEPS, noise=jnp.asarray(noise),
    )
    img_j = np.asarray(je.decode_first_stage(jp, z_j))
    z_j = np.asarray(z_j)

    te = Engine(EngineConfig(unet=UNetConfig(**TINY_UNET), vae=VAEConfig(**TINY_VAE)),
                device="cpu")
    tp = to_torch(params)
    steps = []
    z_t = te.sample(
        tp, {k: t(v) for k, v in cond.items()}, {k: t(v) for k, v in uc.items()},
        vanilla_cfg_img_ref(scale=7.5), noise=t(noise),
        cams=Cameras(*(t(c) for c in cams)),
        references={a: {d: t(v) for d, v in dd.items()} for a, dd in refs.items()},
        choices=choices, num_steps=STEPS, callback=steps.append,
    )
    img_t = te.decode_first_stage(tp, z_t)

    assert steps == list(range(STEPS))
    assert z_t.shape == noise.shape and img_t.shape == (B, 2 * LAT, 2 * LAT, 3)
    assert float(np.abs(z_j - noise * np.sqrt(1 + 14.6**2)).max()) > 1.0  # it moved
    assert max_err(z_t, z_j) < 1e-5 * max(1.0, float(np.abs(z_j).max()))
    assert max_err(img_t, img_j) < 1e-5 * max(1.0, float(np.abs(img_j).max()))


def test_sigmas_and_quantization_match_jax():
    np.testing.assert_array_equal(legacy_ddpm_sigmas(50).numpy(), np.asarray(j_sigmas(50)))
    np.testing.assert_array_equal(
        legacy_ddpm_sigmas(1000, append_zero=False, flip=True).numpy(),
        np.asarray(j_sigmas(1000, append_zero=False, flip=True)))
    jd, td = JDenoiser(), Denoiser()
    grid = np.asarray(jd.sigmas)
    # grid points, midpoints (ties) and off-grid values
    sig = np.concatenate([grid[::97], (grid[:-1:131] + grid[1::131]) / 2,
                          np.array([0.0, 0.5, 3.3, 14.6, 20.0], np.float32)]).astype(np.float32)
    np.testing.assert_array_equal(td.sigma_to_idx(t(sig)).numpy(),
                                  np.asarray(jd.sigma_to_idx(jnp.asarray(sig))))
    np.testing.assert_array_equal(td.quantize_sigma(t(sig)).numpy(),
                                  np.asarray(jd.quantize_sigma(jnp.asarray(sig))))


def test_dense_reference_features_match_compact(inputs):
    """build_ref_features: the JAX engine's dense (copies*B, n, hw, C)
    tokens equal the port's compact tokens, expanded row by row."""
    _, refs, _, _, _, _ = inputs
    je = JEngine(JEngineConfig(unet=JUNetConfig(**TINY_UNET), vae=JVAEConfig(**TINY_VAE)))
    te = Engine(EngineConfig(unet=UNetConfig(**TINY_UNET), vae=VAEConfig(**TINY_VAE)),
                device="cpu")
    dense = je.build_ref_features(jax.tree.map(jnp.asarray, refs), np.array([1, 0]), B, 2,
                                  compact=False)
    compact = te.build_ref_features(
        {a: {d: t(v) for d, v in dd.items()} for a, dd in refs.items()}, [1, 0], B, 2)
    assert dense.keys() == compact.keys()
    for a in compact:
        assert dense[a].keys() == compact[a].keys()
        for d, tok in compact[a].items():
            assert tok.shape == dense[a][d].shape
            assert max_err(tok.expand_rows(tok.zero[None].expand(tok.chosen.shape), tok.chosen),
                           dense[a][d]) == 0.0
