"""The port's EncoderUNet classifier and its attention pieces
(models/encoder_unet.py) against the JAX package, on the CPU in float32:
``qkv_attention`` in both channel orders, ``attention_block_apply`` (legacy
and new order, head count or head width), ``attention_pool2d_apply``, and
``encoder_unet_apply`` with every pool (adaptive, attention, spatial,
spatial_v2) and both attention orders; ``init_encoder_unet_params`` gives
the JAX tree's structure.

Parameters are the JAX initializers' structures filled with seeded numpy
draws (``random_params``), carried by ``from_jax_params``. Tolerance:
max-abs error within 1e-5 of max|want| (1e-4 for the whole model, a dozen
convolutions in other summation orders).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from custom_diffusion360_tpu.models import encoder_unet as jeu
from custom_diffusion360_torch.models import encoder_unet as teu
from tests.test_torch_common import max_err, random_params, t, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

# tests/test_encoder_unet.py's CFG
TINY = dict(image_size=8, in_channels=3, model_channels=32, out_channels=5, num_res_blocks=1,
            attention_resolutions=(2,), channel_mult=(1, 2), num_heads=2, num_head_channels=16)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return max_err(got.detach().numpy(), want) / max(float(np.abs(want).max()), 1e-12)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("legacy", [True, False])
def test_qkv_attention(legacy):
    qkv = _normal(0, 2, 7, 3 * 4 * 8)
    want = jeu.qkv_attention(jnp.asarray(qkv), 4, legacy=legacy)
    assert _rel(teu.qkv_attention(t(qkv), 4, legacy=legacy), want) < 1e-5


@pytest.mark.parametrize("heads,head_channels,new_order", [(2, -1, False), (1, 16, True),
                                                           (4, -1, True)])
def test_attention_block(heads, head_channels, new_order):
    p = random_params(lambda k: jeu.attention_block_init(k, 64), seed=1)
    x = _normal(2, 2, 4, 4, 64)
    want = jeu.attention_block_apply(p, jnp.asarray(x), heads, head_channels, new_order)
    got = teu.attention_block_apply(to_torch(p), t(x), heads, head_channels, new_order)
    assert _rel(got, want) < 1e-5


def test_attention_pool2d():
    p = random_params(lambda k: jeu.attention_pool2d_init(k, 4, 64, 10), seed=3)
    x = _normal(4, 2, 4, 4, 64)
    want = jeu.attention_pool2d_apply(p, jnp.asarray(x), 16)
    got = teu.attention_pool2d_apply(to_torch(p), t(x), 16)
    assert tuple(got.shape) == (2, 10) and _rel(got, want) < 1e-5


@pytest.mark.parametrize("pool,new_order", [("adaptive", False), ("attention", True),
                                            ("spatial", False), ("spatial_v2", True)])
def test_encoder_unet(pool, new_order):
    kw = dict(TINY, pool=pool, use_new_attention_order=new_order)
    jcfg, tcfg = jeu.EncoderUNetConfig(**kw), teu.EncoderUNetConfig(**kw)
    p = random_params(lambda k: jeu.init_encoder_unet_params(k, jcfg), seed=5)
    x = _normal(6, 2, 8, 8, 3)
    steps = np.asarray([3.0, 500.0], np.float32)
    want = jax.jit(functools.partial(jeu.encoder_unet_apply, cfg=jcfg))(
        p, jnp.asarray(x), jnp.asarray(steps))
    got = teu.encoder_unet_apply(to_torch(p), t(x), t(steps), tcfg)
    assert tuple(got.shape) == want.shape == (2, 5)
    assert _rel(got, want) < 1e-4


@pytest.mark.parametrize("pool", ["adaptive", "attention", "spatial", "spatial_v2"])
def test_init_encoder_unet_params_has_the_jax_structure(pool):
    kw = dict(TINY, pool=pool)
    got = teu.init_encoder_unet_params(teu.EncoderUNetConfig(**kw), seed=0, device="cpu")
    want = jax.eval_shape(lambda k: jeu.init_encoder_unet_params(k, jeu.EncoderUNetConfig(**kw)),
                          jax.random.PRNGKey(0))
    carried = to_torch(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), want))
    mine, theirs = (jax.tree.map(np.asarray, tree) for tree in (got, carried))
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    assert [a.shape for a in jax.tree.leaves(mine)] == [b.shape for b in jax.tree.leaves(theirs)]


def test_init_refuses_what_jax_refuses():
    cfg = teu.EncoderUNetConfig(**dict(TINY, pool="attention", num_head_channels=-1))
    with pytest.raises(ValueError, match="num_head_channels"):
        teu.init_encoder_unet_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="max"):
        teu.init_encoder_unet_params(dataclasses.replace(cfg, pool="max"), device="cpu")
