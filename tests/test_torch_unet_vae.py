"""UNet (pose-block render and render-cache paths) and VAE decoder of the
port vs the JAX package, tiny configs, perturbed random parameters, f32.
Tolerance 2e-4 relative to the output scale (a few thousand chained f32
ops through GroupNorm/LayerNorm/softmax)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import custom_diffusion360_tpu.models.vae as jvae
from custom_diffusion360_tpu.geometry.cameras import Cameras as JCams
from custom_diffusion360_tpu.io.delta import iter_pose_blocks
from custom_diffusion360_tpu.models import unet as junet
from custom_diffusion360_tpu.models.nerf import CompactRefTokens as JCompact
from custom_diffusion360_tpu.models.transformer import fuse_attention_params as jfuse
import custom_diffusion360_torch.models.vae as tvae
from custom_diffusion360_torch.geometry.cameras import Cameras
from custom_diffusion360_torch.io.delta import iter_pose_blocks as t_iter_pose_blocks
from custom_diffusion360_torch.models import unet as tunet
from custom_diffusion360_torch.models.nerf import CompactRefTokens
from custom_diffusion360_torch.models.transformer import fuse_attention_params as tfuse
from tests.test_cameras import random_cameras
from tests.test_torch_common import TINY_UNET, TINY_VAE, max_err, random_params, t, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

B, NREF, LAT = 2, 2, 8


def _rel(got, want, tol):
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    return max_err(got, want) < tol * scale


@pytest.fixture(scope="module")
def unet_setup():
    jcfg = junet.UNetConfig(**TINY_UNET)
    tcfg = tunet.UNetConfig(**TINY_UNET)
    params = random_params(lambda k: junet.init_unet_params(k, jcfg), seed=3)
    rng = np.random.default_rng(4)
    meta = junet.attn_block_meta(jcfg)
    refs = {}
    for _, _, attn_id, d in iter_pose_blocks(jcfg):
        ds, ch, _ = meta[attn_id]
        refs.setdefault(attn_id, {})[d] = rng.normal(
            size=(NREF + 1, (LAT // ds) ** 2, ch)).astype(np.float32)
    jc = random_cameras(B * (1 + NREF), seed=5).reshape(B, 1 + NREF)
    inputs = dict(
        x=rng.normal(size=(B, LAT, LAT, 4)).astype(np.float32),
        t=np.array([3.0, 700.0], np.float32),
        ctx=rng.normal(size=(B, 16, 64)).astype(np.float32),
        y=rng.normal(size=(B, 32)).astype(np.float32),
    )
    return jcfg, tcfg, params, refs, jc, inputs


def test_pose_block_spec_matches(unet_setup):
    jcfg, tcfg = unet_setup[:2]
    assert list(t_iter_pose_blocks(tcfg)) == list(iter_pose_blocks(jcfg))
    assert tunet.attn_block_meta(tcfg) == junet.attn_block_meta(jcfg)


def test_unet_render_then_cache_matches_jax(unet_setup):
    """unet_apply rendering from compact reference tokens, then again from
    the render cache with precomputed text K/V (fused params), as
    Engine.sample runs them."""
    jcfg, tcfg, params, refs, jc, inp = unet_setup
    jp = jfuse(jax.tree.map(jnp.asarray, params))
    tp = tfuse(to_torch(params))
    tc = Cameras(*(t(np.asarray(f)) for f in jc))
    j_refs = {a: {d: JCompact(jnp.asarray(v[-1]), jnp.asarray(v[:-1]), 1, 2)
                  for d, v in dd.items()} for a, dd in refs.items()}
    t_refs = {a: {d: CompactRefTokens(t(v[-1]), t(v[:-1]), 1, 2)
                  for d, v in dd.items()} for a, dd in refs.items()}
    args_j = (jnp.asarray(inp["x"]), jnp.asarray(inp["t"]), jnp.asarray(inp["ctx"]),
              jnp.asarray(inp["y"]))
    args_t = (t(inp["x"]), t(inp["t"]), t(inp["ctx"]), t(inp["y"]))

    eps_j, aux_j = junet.unet_apply(jp, jcfg, *args_j, cams=jc, ref_features=j_refs)
    eps_t, aux_t = tunet.unet_apply(tp, tcfg, *args_t, cams=tc, ref_features=t_refs)
    assert float(np.abs(np.asarray(eps_j)).max()) > 1e-2  # not a trivial zero output
    assert _rel(eps_t, eps_j, 2e-4)
    assert sorted(aux_t["rendered"]) == sorted(aux_j["rendered"])
    for a in aux_j["rendered"]:
        for d in aux_j["rendered"][a]:
            assert _rel(aux_t["rendered"][a][d], aux_j["rendered"][a][d], 2e-4)
    for got, want in zip(aux_t["fg_mask_list"], aux_j["fg_mask_list"]):
        assert _rel(got, want, 2e-4)

    kv_j = junet.precompute_context_kv(jp, jcfg, args_j[2])
    kv_t = tunet.precompute_context_kv(tp, tcfg, args_t[2])
    eps_j2, _ = junet.unet_apply(jp, jcfg, *args_j, cams=jc, nerf_caches=aux_j["rendered"],
                                 ctx_kv=kv_j)
    eps_t2, _ = tunet.unet_apply(tp, tcfg, *args_t, cams=tc, nerf_caches=aux_t["rendered"],
                                 ctx_kv=kv_t)
    assert _rel(eps_t2, eps_j2, 2e-4)
    assert _rel(eps_t2, eps_t, 1e-5)  # the cache reproduces the render exactly


def test_unet_plain_path_unfused(unet_setup):
    """Unfused params, no pose source: the canonical to_q/to_k/to_v path."""
    jcfg, tcfg, params, _, _, inp = unet_setup
    eps_j, _ = junet.unet_apply(jax.tree.map(jnp.asarray, params), jcfg,
                                *(jnp.asarray(inp[k]) for k in ("x", "t", "ctx", "y")))
    eps_t, _ = tunet.unet_apply(to_torch(params), tcfg,
                                *(t(inp[k]) for k in ("x", "t", "ctx", "y")))
    assert _rel(eps_t, eps_j, 2e-4)


@pytest.mark.parametrize("per_row", [False, True])
def test_vae_decode_matches_jax(per_row, monkeypatch):
    jcfg, tcfg = jvae.VAEConfig(**TINY_VAE), tvae.VAEConfig(**TINY_VAE)
    params = random_params(lambda k: jvae.init_vae_params(k, jcfg), seed=6)
    z = np.random.default_rng(7).normal(size=(2, 6, 6, 4)).astype(np.float32)
    if per_row:  # the 1024^2 row-by-row decode, exercised at a tiny latent
        monkeypatch.setattr(jvae, "_PER_ROW_DECODE_MIN_LATENT", 4)
        monkeypatch.setattr(tvae, "_PER_ROW_DECODE_MIN_LATENT", 4)
    want = jvae.decode_first_stage(jax.tree.map(jnp.asarray, params), jnp.asarray(z), jcfg)
    got = tvae.decode_first_stage(to_torch(params), t(z), tcfg)
    assert got.shape == (2, 12, 12, 3)  # two levels: one 2x upsample
    assert _rel(got, want, 2e-4)
