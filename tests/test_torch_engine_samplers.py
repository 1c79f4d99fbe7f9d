"""Every sampler through ``Engine.sample``, port vs a live JAX
``Engine.sample``: TINY UNet + VAE, 3 steps, 2 reference views from
delta-style buffers, the render cached after step 0, under the x2 guider
(vanilla_cfg_img_ref) and the x3 one (scheduled_cfg_img_text_ref, shared
target cameras, so both dedupes run on both sides), with the same
parameters, initial noise, cameras, buffers and conditioning. The ancestral
samplers get the per-step draws of the JAX engine's key split
(``k_noise, k_samp = split(key)``, then ``split(k_samp, n)``) as the draw
"step_noise". Also the EDM schedule through the uncached route
(``cache_nerf=False``), and that route against the cached one. f32; tolerance 1e-5 relative to the output scale (the slice-1
standard), 2e-4 between the cached and uncached routes (JAX's own
test_euler_fast_path_equals_generic_route bound)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.diffusion import scheduled_cfg_img_text_ref as JGuider3
from custom_diffusion360_tpu.diffusion import vanilla_cfg_img_ref as JGuider2
from custom_diffusion360_tpu.engine import Engine as JEngine, EngineConfig as JEngineConfig
from custom_diffusion360_tpu.geometry.cameras import Cameras as JCams
from custom_diffusion360_tpu.io.delta import iter_pose_blocks
from custom_diffusion360_tpu.models.unet import UNetConfig as JUNetConfig, attn_block_meta
from custom_diffusion360_tpu.models.unet import init_unet_params
from custom_diffusion360_tpu.models.vae import VAEConfig as JVAEConfig, init_vae_params
from custom_diffusion360_torch.diffusion.guiders import (
    scheduled_cfg_img_text_ref,
    vanilla_cfg_img_ref,
)
from custom_diffusion360_torch.draws import Draws
from custom_diffusion360_torch.engine import Engine, EngineConfig
from custom_diffusion360_torch.geometry.cameras import Cameras
from custom_diffusion360_torch.models.unet import UNetConfig
from custom_diffusion360_torch.models.vae import VAEConfig
from tests.test_cameras import random_cameras
from tests.test_torch_common import TINY_UNET, TINY_VAE, max_err, random_params, t, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

B, NREF, LAT, STEPS = 1, 2, 8, 3
KEY = jax.random.PRNGKey(7)
GUIDERS = {2: (JGuider2(scale=7.5), vanilla_cfg_img_ref(scale=7.5)),
           3: (JGuider3(scale=7.5, scale_im=3.5), scheduled_cfg_img_text_ref(scale=7.5,
                                                                              scale_im=3.5))}


def _rel(got, want, tol=1e-5):
    return max_err(got, want) < tol * max(1.0, float(np.abs(np.asarray(want)).max()))


def jax_step_noise(key, n, shape):
    """Engine.sample's per-step draws: split(k_samp, n) of split(key)[1]."""
    _, k_samp = jax.random.split(key)
    return np.stack([np.asarray(jax.random.normal(k, shape))
                     for k in jax.random.split(k_samp, n)])


@pytest.fixture(scope="module")
def setup():
    params = random_params(lambda k: {
        "unet": init_unet_params(k, JUNetConfig(**TINY_UNET)),
        "vae": init_vae_params(k, JVAEConfig(**TINY_VAE)),
    }, seed=31)
    rng = np.random.default_rng(32)
    meta = attn_block_meta(JUNetConfig(**TINY_UNET))
    refs = {}
    for _, _, attn_id, d in iter_pose_blocks(JUNetConfig(**TINY_UNET)):
        ds, ch, _ = meta[attn_id]
        refs.setdefault(attn_id, {})[d] = rng.normal(
            size=(NREF + 1, (LAT // ds) ** 2, ch)).astype(np.float32) * 0.5
    one = random_cameras(1 + NREF, seed=33)
    cams = {k: [np.broadcast_to(np.asarray(f)[None], (k * B,) + np.asarray(f).shape).copy()
                for f in one] for k in GUIDERS}  # one target pose tiled over the copies
    cond = {"crossattn": rng.normal(size=(B, 16, 64)).astype(np.float32),
            "vector": rng.normal(size=(B, 32)).astype(np.float32)}
    uc = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in cond.items()}
    noise = rng.normal(size=(B, LAT, LAT, 4)).astype(np.float32)
    return params, refs, cams, cond, uc, noise


def _cfgs(**kw):
    return (JEngineConfig(unet=JUNetConfig(**TINY_UNET), vae=JVAEConfig(**TINY_VAE), **kw),
            EngineConfig(unet=UNetConfig(**TINY_UNET), vae=VAEConfig(**TINY_VAE), **kw))


def run_jax(setup, copies, sampler="euler_edm", cache_nerf=True, **cfg_kw):
    params, refs, cams, cond, uc, noise = setup
    jcfg, _ = _cfgs(**cfg_kw)
    return np.asarray(JEngine(jcfg).sample(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, cond),
        jax.tree.map(jnp.asarray, uc), GUIDERS[copies][0], KEY, shape=noise.shape,
        cams=JCams(*(jnp.asarray(c) for c in cams[copies])),
        references=jax.tree.map(jnp.asarray, refs), choices=np.arange(NREF),
        num_steps=STEPS, noise=jnp.asarray(noise), sampler=sampler, cache_nerf=cache_nerf,
        shared_target_cams=True))


def run_port(setup, copies, sampler=None, cache_nerf=True, draws=None, callback=None,
             **cfg_kw):
    params, refs, cams, cond, uc, noise = setup
    _, tcfg = _cfgs(**cfg_kw)
    return Engine(tcfg, device="cpu").sample(
        to_torch(params), {k: t(v) for k, v in cond.items()}, {k: t(v) for k, v in uc.items()},
        GUIDERS[copies][1], noise=t(noise), cams=Cameras(*(t(c) for c in cams[copies])),
        references={a: {d: t(v) for d, v in dd.items()} for a, dd in refs.items()},
        choices=np.arange(NREF), num_steps=STEPS, sampler=sampler, cache_nerf=cache_nerf,
        draws=draws, callback=callback, shared_target_cams=True)


CASES = [("heun_edm", 2), ("heun_edm", 3), ("dpmpp2m", 2), ("dpmpp2m", 3), ("lms", 2),
         ("lms", 3), ("euler_ancestral", 2), ("dpmpp2s_ancestral", 3)]


@pytest.mark.parametrize("sampler,copies", CASES, ids=[f"{s}-x{c}" for s, c in CASES])
def test_engine_sampler_matches_jax(setup, sampler, copies):
    noise = setup[5]
    want = run_jax(setup, copies, sampler)
    draws = Draws(given={"step_noise": t(jax_step_noise(KEY, STEPS, noise.shape))})
    steps = []
    got = run_port(setup, copies, sampler, draws=draws, callback=steps.append)
    assert steps == list(range(STEPS))
    assert float(np.abs(want - noise * np.sqrt(1 + 14.6**2)).max()) > 1.0  # it moved
    assert _rel(got, want), (sampler, copies, max_err(got, want))


def test_engine_config_sampler_and_edm_schedule_match_jax(setup):
    """sampler_name and discretization_name from the config (Euler on the
    EDM schedule, x3), through the uncached route (cache_nerf=False: every
    step renders)."""
    kw = dict(cache_nerf=False, discretization_name="edm", sampler_name="euler_edm")
    want = run_jax(setup, 3, **kw)
    got = run_port(setup, 3, **kw)
    assert _rel(got, want), max_err(got, want)
    with pytest.raises(ValueError, match="unknown sampler"):
        run_port(setup, 2, sampler="ddim")


@pytest.mark.parametrize("sampler", ["euler_edm", "dpmpp2m"])
def test_uncached_route_equals_cached(setup, sampler):
    """cache_nerf=False renders every step; the render is
    sigma-independent, so the result equals the cached route's."""
    cached = run_port(setup, 3, sampler)
    uncached = run_port(setup, 3, sampler, cache_nerf=False)
    scale = max(1.0, float(cached.abs().max()))
    assert max_err(uncached, cached) < 2e-4 * scale


def test_churn_differs_between_the_cached_and_uncached_euler_routes(setup):
    """States a case that both packages share (ROADMAP.md Queue 3), as
    tests/test_torch_tokenizer.py states the tokenizer's: with the render
    cached, Euler's step 0 is the render pass's own evaluation, without
    churn, and its loop runs on sigmas[1:], so each later step churns by
    min(s_churn / (n - 1), sqrt(2) - 1); without the cache every one of the
    n steps churns by min(s_churn / n, sqrt(2) - 1) (JAX engine.py:415-422,
    port engine.py). At s_churn = 2.5 and 8 steps that is 0.357 against
    0.3125: the packages agree on each route, the routes differ; at
    s_churn = 0 the port's routes agree (the JAX package's, in its
    test_euler_fast_path_equals_generic_route)."""
    from custom_diffusion360_tpu.diffusion import sampling as jsampling
    from custom_diffusion360_tpu.diffusion.discretization import legacy_ddpm_sigmas as jsig
    from custom_diffusion360_torch.diffusion import sampling as tsampling
    from custom_diffusion360_torch.diffusion.discretization import legacy_ddpm_sigmas

    steps, noise = 8, setup[5]
    params, refs, cams, cond, uc, _ = setup
    jcfg, tcfg = _cfgs()
    for churn in (2.5, 0.0):
        jc = dataclasses.replace(jcfg, sampler=jsampling.SamplerConfig(s_churn=churn))
        tc = dataclasses.replace(tcfg, sampler=tsampling.SamplerConfig(s_churn=churn))
        routes = {}
        for cache in (True, False):
            rows = steps - 1 if cache else steps  # Euler's loop steps on this route
            z_t = Engine(tc, device="cpu").sample(
                to_torch(params), {k: t(v) for k, v in cond.items()},
                {k: t(v) for k, v in uc.items()}, GUIDERS[2][1], noise=t(noise),
                cams=Cameras(*(t(c) for c in cams[2])),
                references={a: {d: t(v) for d, v in dd.items()} for a, dd in refs.items()},
                choices=np.arange(NREF), num_steps=steps, cache_nerf=cache,
                draws=Draws(given={"step_noise": t(jax_step_noise(KEY, rows, noise.shape))}))
            routes[cache] = z_t.numpy()
            if not churn:
                continue
            z_j = np.asarray(JEngine(jc).sample(
                jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, cond),
                jax.tree.map(jnp.asarray, uc), GUIDERS[2][0], KEY, shape=noise.shape,
                cams=JCams(*(jnp.asarray(c) for c in cams[2])),
                references=jax.tree.map(jnp.asarray, refs), choices=np.arange(NREF),
                num_steps=steps, noise=jnp.asarray(noise), cache_nerf=cache))
            assert _rel(z_t, z_j), (cache, max_err(z_t, z_j))
        scale = max(1.0, float(np.abs(routes[True]).max()))
        gap = max_err(routes[True], routes[False])
        if churn:
            assert gap > 1e-2 * scale, gap
        else:
            assert gap < 2e-4 * scale, gap
    cfg = tsampling.SamplerConfig(s_churn=2.5)
    sig = legacy_ddpm_sigmas(steps)
    g_cached, g_full = tsampling._gammas(sig[1:], cfg), tsampling._gammas(sig, cfg)
    assert torch.allclose(g_cached, torch.full((steps - 1,), 2.5 / (steps - 1)))
    assert torch.allclose(g_full, torch.full((steps,), 2.5 / steps))
    jcfg_s = jsampling.SamplerConfig(s_churn=2.5)
    np.testing.assert_allclose(np.asarray(jsampling._gammas(jsig(steps)[1:], jcfg_s)),
                               g_cached.numpy(), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jsampling._gammas(jsig(steps), jcfg_s)),
                               g_full.numpy(), rtol=1e-6)
