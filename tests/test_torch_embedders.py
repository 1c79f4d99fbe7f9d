"""The port's auxiliary embedders (models/embedders.py) against the JAX
package, on the CPU in float32: the identity and class embedders (with the
unconditional id and the multi-cond form), ``open_clip_embedder2`` at both
layers, legacy or not, pooled; ``open_clip_image_embedder`` in every mode,
its UCG row dropout replayed from JAX's bernoulli uniforms as the draw
"ucg"; ``clip_t5_encode``; ``spatial_rescaler`` with every method, stage
count and the channel mapper; ``make_linear_beta_schedule``;
``low_scale_encode`` / ``low_scale_decode`` with JAX's three key splits
replayed as the draws "vae_eps", "noise_level" and "noise" (the final
nearest resize down and up); ``gaussian_encoder``.

Parameters are the JAX initializers' structures filled with seeded numpy
draws (``random_params``), carried by ``from_jax_params``. Tolerance:
max-abs error within 1e-5 of max|want| (1e-4 through the VAE encoder and
decoder); embeddings, indices and the schedule exactly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.models import clip as jclip
from custom_diffusion360_tpu.models import embedders as jemb
from custom_diffusion360_tpu.models import t5 as jt5
from custom_diffusion360_tpu.models import vae as jvae
from custom_diffusion360_torch.draws import Draws
from custom_diffusion360_torch.models import clip as tclip
from custom_diffusion360_torch.models import embedders as temb
from custom_diffusion360_torch.models import t5 as tt5
from custom_diffusion360_torch.models import vae as tvae
from tests.test_torch_common import TINY_VAE, max_err, random_params, t, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

# tests/test_embedders.py's tiny towers
TEXT = dict(vocab_size=64, width=32, layers=3, heads=4, context_length=16, text_projection=True)
VISION = dict(image_size=16, patch_size=8, width=32, layers=2, heads=4, embed_dim=12,
              act="quick_gelu")
T5 = dict(vocab_size=60, d_model=16, d_kv=4, d_ff=32, num_layers=2, num_heads=4)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _rel(got, want):
    want = _np(want)
    return max_err(_np(got), want) / max(float(np.abs(want).max()), 1e-12)


def _uniform(seed, *shape, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def test_identity_and_class_embedders():
    x = torch.arange(6.0)
    assert temb.identity_encoder(x) is x
    p = random_params(lambda k: jemb.class_embedder_init(k, embed_dim=8, n_classes=10))
    tp = to_torch(p)
    c = np.asarray([1, 3, 9], np.int32)
    for seq in (False, True):
        want = jemb.class_embedder_apply(p, jnp.asarray(c), add_sequence_dim=seq)
        got = temb.class_embedder_apply(tp, t(c), add_sequence_dim=seq)
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    uc = temb.class_embedder_uc(10, 3, device="cpu")
    np.testing.assert_array_equal(uc.numpy(), np.asarray(jemb.class_embedder_uc(10, 3)))
    for listed in (False, True):
        batch = {"cls": [t(c)] if listed else t(c), "other": "keep"}
        out = temb.class_embedder_multi_cond_apply(tp, batch, "cls", add_sequence_dim=True)
        want = jemb.class_embedder_multi_cond_apply(
            p, {"cls": [jnp.asarray(c)] if listed else jnp.asarray(c)}, "cls",
            add_sequence_dim=True)["cls"]
        got = out["cls"][0] if listed else out["cls"]
        assert isinstance(out["cls"], list) == listed and out["other"] == "keep"
        np.testing.assert_array_equal(_np(got), np.asarray(want[0] if listed else want))
        assert batch["cls"] is not out["cls"]


@pytest.fixture(scope="module")
def text_tower():
    p = random_params(lambda k: jclip.init_clip_text_params(k, jclip.ClipTextConfig(**TEXT)), 1)
    tokens = np.random.default_rng(0).integers(0, 60, (2, 16)).astype(np.int32)
    return p, to_torch(p), tokens


@pytest.mark.parametrize("layer", ["last", "penultimate"])
@pytest.mark.parametrize("legacy,pooled", [(True, False), (False, False), (False, True)])
def test_open_clip_embedder2(text_tower, layer, legacy, pooled):
    p, tp, tokens = text_tower
    want = jemb.open_clip_embedder2(p, jnp.asarray(tokens), jclip.ClipTextConfig(**TEXT),
                                    layer=layer, legacy=legacy, return_pooled=pooled)
    got = temb.open_clip_embedder2(tp, t(tokens), tclip.ClipTextConfig(**TEXT), layer=layer,
                                   legacy=legacy, return_pooled=pooled)
    if pooled:
        assert _rel(got[0], want[0]) < 1e-5 and _rel(got[1], want[1]) < 1e-5
    else:
        assert _rel(got, want) < 1e-5


def test_open_clip_embedder2_refuses_what_jax_refuses(text_tower):
    _, tp, tokens = text_tower
    cfg = tclip.ClipTextConfig(**TEXT)
    with pytest.raises(ValueError):
        temb.open_clip_embedder2(tp, t(tokens), cfg, layer="first")
    with pytest.raises(ValueError):
        temb.open_clip_embedder2(tp, t(tokens), cfg, legacy=True, return_pooled=True)


@pytest.fixture(scope="module")
def vision_tower():
    p = random_params(lambda k: jclip.init_clip_vision_params(
        k, jclip.ClipVisionConfig(**VISION)), 2)
    return p, to_torch(p), _uniform(3, 3, 20, 20, 3)


@pytest.mark.parametrize("mode", [{}, {"unsqueeze_dim": True},
                                  {"repeat_to_max_len": True, "max_length": 7},
                                  {"output_tokens": True},
                                  {"output_tokens": True, "unsqueeze_dim": True}])
@pytest.mark.parametrize("ucg_rate", [0.0, 0.5])
def test_open_clip_image_embedder(vision_tower, mode, ucg_rate):
    p, tp, img = vision_tower
    key = jax.random.PRNGKey(4)
    want = jemb.open_clip_image_embedder(p, jnp.asarray(img), jclip.ClipVisionConfig(**VISION),
                                         key=key, ucg_rate=ucg_rate, **mode)
    # jax.random.bernoulli(key, 1 - rate, (B,)) is uniform(key, (B,), f32) < 1 - rate
    u = np.asarray(jax.random.uniform(key, (3,), jnp.float32))
    got = temb.open_clip_image_embedder(tp, t(img), tclip.ClipVisionConfig(**VISION),
                                        draws=Draws(given={"ucg": t(u)}), ucg_rate=ucg_rate,
                                        **mode)
    if isinstance(want, tuple):
        assert len(got) == 2
        for g, w in zip(got, want):
            assert tuple(g.shape) == w.shape and _rel(g, w) < 1e-5
    else:
        assert tuple(got.shape) == want.shape and _rel(got, want) < 1e-5
    if ucg_rate:
        pooled = _np(got[1] if isinstance(want, tuple) else got)
        dropped = (u >= 1.0 - ucg_rate)
        assert dropped.any() and not dropped.all()
        assert (pooled.reshape(3, -1)[dropped] == 0).all()


def test_image_embedder_ucg_needs_draws(vision_tower):
    _, tp, img = vision_tower
    with pytest.raises(ValueError, match="ucg"):
        temb.open_clip_image_embedder(tp, t(img), tclip.ClipVisionConfig(**VISION), ucg_rate=0.1)


def test_clip_t5_encode(text_tower):
    p, tp, tokens = text_tower
    t5p = random_params(lambda k: jt5.init_t5_params(k, jt5.T5Config(**T5)), 5)
    t5_tokens = np.random.default_rng(6).integers(0, 60, (2, 9)).astype(np.int32)
    want = jemb.clip_t5_encode(p, t5p, jnp.asarray(tokens), jnp.asarray(t5_tokens),
                               jclip.ClipTextConfig(**TEXT), jt5.T5Config(**T5))
    got = temb.clip_t5_encode(tp, to_torch(t5p), t(tokens), t(t5_tokens),
                              tclip.ClipTextConfig(**TEXT), tt5.T5Config(**T5))
    assert [tuple(g.shape) for g in got] == [(2, 16, 32), (2, 9, 16)]
    assert _rel(got[0], want[0]) < 1e-5 and _rel(got[1], want[1]) < 1e-5


@pytest.mark.parametrize("method,multiplier,size", [
    ("nearest", 0.5, 8), ("nearest", 0.3, 10), ("nearest", 0.75, 8), ("nearest", 2.0, 5),
    ("area", 0.5, 8), ("bilinear", 0.5, 8), ("bilinear", 2.0, 8), ("bicubic", 0.5, 8),
    ("bicubic", 1.5, 6)])
def test_spatial_rescaler(method, multiplier, size):
    x = np.random.default_rng(7).normal(size=(2, size, size, 5)).astype(np.float32)
    want = jemb.spatial_rescaler(jnp.asarray(x), method=method, multiplier=multiplier)
    got = temb.spatial_rescaler(t(x), method=method, multiplier=multiplier)
    assert tuple(got.shape) == want.shape
    assert _rel(got, want) < 1e-5
    if method == "nearest":
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_spatial_rescaler_stages_and_mapper():
    x = np.random.default_rng(8).normal(size=(2, 8, 8, 5)).astype(np.float32)
    for bias, kernel in ((False, 1), (True, 3)):
        p = random_params(lambda k: jemb.spatial_rescaler_init(k, 5, 3, kernel, bias), 9)
        want = jemb.spatial_rescaler(jnp.asarray(x), n_stages=2, method="bilinear", params=p)
        got = temb.spatial_rescaler(t(x), n_stages=2, method="bilinear", params=to_torch(p))
        assert tuple(got.shape) == want.shape == (2, 2, 2, 3) and _rel(got, want) < 1e-5


def test_linear_beta_schedule():
    for args in ((100, 1e-4, 2e-2), (1000, 1e-4, 2e-2), (7, 0.0015, 0.0195)):
        np.testing.assert_array_equal(temb.make_linear_beta_schedule(*args).numpy(),
                                      np.asarray(jemb.make_linear_beta_schedule(*args)))


@pytest.fixture(scope="module")
def vae():
    p = random_params(lambda k: jvae.init_vae_params(k, jvae.VAEConfig(**TINY_VAE)), 10)
    return p, to_torch(p), _uniform(11, 2, 16, 16, 3)


@pytest.mark.parametrize("output_size,scale_factor", [(4, 1.0), (12, 0.5), (None, 1.0)])
def test_low_scale_encode_and_decode(vae, output_size, scale_factor):
    p, tp, x = vae
    jcfg = jemb.LowScaleConfig(output_size=output_size, max_noise_level=50,
                               scale_factor=scale_factor)
    tcfg = temb.LowScaleConfig(output_size=output_size, max_noise_level=50,
                               scale_factor=scale_factor)
    key = jax.random.PRNGKey(12)
    encode = jax.jit(functools.partial(jemb.low_scale_encode, cfg=jcfg,
                                       vae_cfg=jvae.VAEConfig(**TINY_VAE)))
    z_want, level_want = encode(p, jnp.asarray(x), key)
    k_post, k_level, k_noise = jax.random.split(key, 3)
    draws = Draws(given={
        "vae_eps": t(jax.random.normal(k_post, (2, 8, 8, 4), jnp.float32)),
        "noise_level": t(jax.random.randint(k_level, (2,), 0, 50)),
        "noise": t(jax.random.normal(k_noise, (2, 8, 8, 4), jnp.float32))})
    z, level = temb.low_scale_encode(tp, t(x), draws, tcfg, tvae.VAEConfig(**TINY_VAE))
    np.testing.assert_array_equal(level.numpy(), np.asarray(level_want))
    assert tuple(z.shape) == z_want.shape and _rel(z, z_want) < 1e-4
    want = jax.jit(functools.partial(jemb.low_scale_decode, cfg=jcfg,
                                     vae_cfg=jvae.VAEConfig(**TINY_VAE)))(p, z_want)
    got = temb.low_scale_decode(tp, t(np.asarray(z_want)), tcfg, tvae.VAEConfig(**TINY_VAE))
    assert tuple(got.shape) == want.shape and _rel(got, want) < 1e-4


@pytest.mark.parametrize("flatten", [True, False])
def test_gaussian_encoder(vae, flatten):
    p, tp, x = vae
    key = jax.random.PRNGKey(13)
    log_want, z_want = jax.jit(functools.partial(
        jemb.gaussian_encoder, weight=0.5, flatten_output=flatten,
        vae_cfg=jvae.VAEConfig(**TINY_VAE)))(p, jnp.asarray(x), key)
    eps = t(jax.random.normal(key, (2, 8, 8, 4), jnp.float32))
    log, z = temb.gaussian_encoder(tp, t(x), Draws(given={"vae_eps": eps}), weight=0.5,
                                   flatten_output=flatten, vae_cfg=tvae.VAEConfig(**TINY_VAE))
    assert tuple(z.shape) == z_want.shape and _rel(z, z_want) < 1e-4
    assert set(log) == set(log_want) and log["weight"] == 0.5 and log["loss"] is log["kl_loss"]
    assert float(log_want["weight"]) == 0.5
    assert abs(float(log["kl_loss"]) - float(log_want["kl_loss"])) <= 1e-4 * abs(
        float(log_want["kl_loss"]))
