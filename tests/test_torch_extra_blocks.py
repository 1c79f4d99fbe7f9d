"""The remaining sgm blocks of the port (models/extra_blocks.py) and the
``nn.conv2d`` padding forms against the JAX package, on the CPU in float32:
conv2d at stride 1 and 2 with "SAME", "VALID" and explicit (asymmetric)
pads; the DDPM timestep embedding; linear attention and LinAttnBlock;
SpatialSelfAttention; the single-layer transformer block with and without
a context; the transposed upsample (its JAX kernel carried by
``from_jax_params`` is ``conv_transpose2d``'s weight); the DDPM model with
vanilla, linear and no attention; dirac_sample and normal_kl.

Parameters are the JAX initializers' structures filled with seeded numpy
draws (``random_params``), carried across by ``from_jax_params``.
Tolerance: max-abs error within 1e-5 of max|want| (1e-4 for the whole DDPM
model, twenty convolutions in other summation orders, and for the timestep
embedding at t = 999, where one ulp of an f32 exp moves the sine).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.models import extra_blocks as jeb
from custom_diffusion360_tpu.models import nn as jnn
from custom_diffusion360_torch.models import extra_blocks as teb
from custom_diffusion360_torch.models import nn as tnn
from tests.test_torch_common import max_err, random_params, t, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

TINY_DDPM = dict(ch=32, out_ch=3, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                 in_channels=3, resolution=16)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    return max_err(got, want) / max(float(np.abs(want).max()), 1e-12)


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("stride,padding", [
    (1, "SAME"), (2, "SAME"), (1, "VALID"), (2, "VALID"), (2, ((0, 1), (0, 1))),
    (2, ((1, 1), (1, 1))), (1, ((2, 0), (1, 0))), (1, ((0, 2), (1, 1)))])
@pytest.mark.parametrize("kernel", [3, 4])
def test_conv2d_padding_matches_jax(stride, padding, kernel):
    p = random_params(lambda k: jnn.conv2d_init(k, 5, 6, kernel), seed=kernel)
    x = _normal(1, 2, 9, 8, 5)  # an odd and an even axis
    want = jnn.conv2d(p, jnp.asarray(x), stride=stride, padding=padding)
    got = tnn.conv2d(to_torch(p), t(x), stride=stride, padding=padding)
    assert tuple(got.shape) == want.shape
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("dim", [64, 33])
def test_ddpm_timestep_embedding(dim):
    steps = np.asarray([0.0, 5.0, 999.0, 0.25], np.float32)
    want = jeb.ddpm_timestep_embedding(jnp.asarray(steps), dim)
    # one ulp of a frequency moves sin(999 f) by up to 999 * 2^-24 * f: the
    # two libraries' f32 exp round differently (the JAX test's 1e-4 too)
    assert _rel(teb.ddpm_timestep_embedding(t(steps), dim), want) < 1e-4


@pytest.mark.parametrize("heads", [1, 4])
def test_linear_attention(heads):
    p = random_params(lambda k: jeb.init_linear_attention(k, 16, heads=heads, dim_head=8))
    x = _normal(2, 2, 4, 4, 16)
    want = jeb.linear_attention_apply(p, jnp.asarray(x), heads=heads)
    assert _rel(teb.linear_attention_apply(to_torch(p), t(x), heads=heads), want) < 1e-5
    if heads == 1:
        p1 = random_params(lambda k: jeb.init_lin_attn_block(k, 16))
        want = jeb.lin_attn_block_apply(p1, jnp.asarray(x))
        assert _rel(teb.lin_attn_block_apply(to_torch(p1), t(x)), want) < 1e-5


def test_spatial_self_attention():
    p = random_params(lambda k: jeb.init_spatial_self_attention(k, 64))
    x = _normal(3, 2, 4, 4, 64)
    want = jeb.spatial_self_attention_apply(p, jnp.asarray(x))
    assert _rel(teb.spatial_self_attention_apply(to_torch(p), t(x)), want) < 1e-5


@pytest.mark.parametrize("context_dim", [None, 24])
def test_single_layer_block(context_dim):
    p = random_params(lambda k: jeb.init_single_layer_block(k, 32, 2, 16, context_dim))
    x = _normal(4, 2, 6, 32)
    ctx = None if context_dim is None else _normal(5, 2, 5, context_dim)
    want = jeb.single_layer_block_apply(p, jnp.asarray(x),
                                        None if ctx is None else jnp.asarray(ctx), n_heads=2)
    got = teb.single_layer_block_apply(to_torch(p), t(x), None if ctx is None else t(ctx),
                                       n_heads=2)
    assert _rel(got, want) < 1e-5


@pytest.mark.parametrize("channels,out_channels,ks", [(4, 6, 5), (3, None, 3)])
def test_transposed_upsample_kernel_layout(channels, out_channels, ks):
    """The JAX (ks, ks, OUT, IN) kernel through from_jax_params is
    conv_transpose2d's (IN, OUT, ks, ks): outputs agree at 2 in + ks - 2."""
    p = random_params(lambda k: jeb.init_transposed_upsample(k, channels, out_channels, ks))
    tp = to_torch(p)
    assert tuple(tp["w"].shape) == (channels, out_channels or channels, ks, ks)
    x = _normal(6, 2, 5, 7, channels)
    want = jeb.transposed_upsample_apply(p, jnp.asarray(x))
    got = teb.transposed_upsample_apply(tp, t(x))
    assert want.shape == (2, 2 * 5 + ks - 2, 2 * 7 + ks - 2, out_channels or channels)
    assert tuple(got.shape) == want.shape and _rel(got, want) < 1e-5


@pytest.mark.parametrize("attn_type", ["vanilla", "linear", "none"])
def test_ddpm_model(attn_type):
    jcfg = jeb.DDPMModelConfig(**TINY_DDPM, attn_type=attn_type)
    tcfg = teb.DDPMModelConfig(**TINY_DDPM, attn_type=attn_type)
    p = random_params(lambda k: jeb.init_ddpm_model_params(k, jcfg), seed=7)
    x = _normal(8, 2, 16, 16, 3)
    steps = np.asarray([3.0, 77.0], np.float32)
    want = jax.jit(functools.partial(jeb.ddpm_model_apply, cfg=jcfg))(
        p, jnp.asarray(x), jnp.asarray(steps))
    got = teb.ddpm_model_apply(to_torch(p), t(x), t(steps), cfg=tcfg)
    assert tuple(got.shape) == want.shape == (2, 16, 16, 3)
    assert _rel(got, want) < 1e-4


def test_ddpm_model_with_context_and_no_timestep():
    kw = dict(TINY_DDPM, in_channels=5, use_timestep=False)
    jcfg, tcfg = jeb.DDPMModelConfig(**kw), teb.DDPMModelConfig(**kw)
    p = random_params(lambda k: jeb.init_ddpm_model_params(k, jcfg), seed=9)
    x, ctx = _normal(10, 1, 16, 16, 3), _normal(11, 1, 16, 16, 2)
    want = jax.jit(functools.partial(jeb.ddpm_model_apply, cfg=jcfg))(
        p, jnp.asarray(x), context=jnp.asarray(ctx))
    got = teb.ddpm_model_apply(to_torch(p), t(x), context=t(ctx), cfg=tcfg)
    assert _rel(got, want) < 1e-4


def test_init_ddpm_model_params_has_the_jax_structure():
    cfg = teb.DDPMModelConfig(**TINY_DDPM, attn_type="linear")
    got = teb.init_ddpm_model_params(cfg, seed=0, device="cpu")
    want = jax.eval_shape(lambda k: jeb.init_ddpm_model_params(
        k, jeb.DDPMModelConfig(**TINY_DDPM, attn_type="linear")), jax.random.PRNGKey(0))
    carried = to_torch(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), want))
    assert jax.tree.structure(jax.tree.map(np.asarray, got)) == jax.tree.structure(
        jax.tree.map(np.asarray, carried))
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, got)),
                    jax.tree.leaves(jax.tree.map(np.asarray, carried))):
        assert a.shape == b.shape


def test_dirac_and_normal_kl():
    x = _normal(12, 4)
    assert teb.dirac_sample(x) is x
    m1, lv1, m2, lv2 = (_normal(13 + i, 3, 4) for i in range(4))
    want = jeb.normal_kl(*(jnp.asarray(a) for a in (m1, lv1, m2, lv2)))
    assert _rel(teb.normal_kl(t(m1), t(lv1), t(m2), t(lv2)), want) < 1e-5
    z = torch.zeros(3)
    assert float(teb.normal_kl(z, z, z, z).abs().max()) == 0.0
