"""The autoencoder-trainer slice of the port against the JAX package, on the
CPU in float32: the latent regularizers (with the JAX draws handed over as
``Draws(given=)``), ``autoencoding_engine_encode`` and the identity first
stage, the PatchGAN discriminator and ActNorm, LPIPS and both torch
loaders, the l1 / lpips loss types, and ``AEEngine.train_step`` /
``validation_step`` against a jitted JAX ``AEEngine``.

Tolerances (max-abs error over max|want|, with a floor of 1 where the
values are O(1)): 1e-5 for the regularizers, the discriminator, the
d-losses and the loaders (exact copies: 0); 1e-4 for the VAE encode, LPIPS
(thirteen 3x3 convs), the loss branches and the AE step's logs, gradients
and updated parameters (the step's Adam moves are held to 1e-3 of lr where
the gradient is not within rounding of 0).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.diffusion import loss as jloss
from custom_diffusion360_tpu.models import discriminator as jdisc
from custom_diffusion360_tpu.models import lpips as jlpips
from custom_diffusion360_tpu.models import regularizers as jreg
from custom_diffusion360_tpu.models import vae as jvae
from custom_diffusion360_tpu.train import ae_engine as jae
from custom_diffusion360_torch.diffusion import loss as tloss
from custom_diffusion360_torch.draws import Draws
from custom_diffusion360_torch.engine import Engine, EngineConfig
from custom_diffusion360_torch.models import discriminator as tdisc
from custom_diffusion360_torch.models import lpips as tlpips
from custom_diffusion360_torch.models import regularizers as treg
from custom_diffusion360_torch.models import vae as tvae
from custom_diffusion360_torch.models.nn import Init
from custom_diffusion360_torch.train import ae_engine as tae
from custom_diffusion360_torch.train.trainer import tree_leaves, tree_map
from tests.test_torch_common import TINY_VAE, max_err, random_params, t, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

# tests/test_ae_engine.py's TINY (the ae1 golden's configuration)
TINY_AE = dict(disc_ndf=8, lr=1e-3)
TINY_AE_VAE = dict(ch=32, ch_mult=(1,), num_res_blocks=1, z_channels=4)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _rel(got, want):
    want = _np(want)
    return max_err(_np(got), want) / max(float(np.abs(want).max()), 1e-12)


def _close(got, want, tol):
    """max-abs error within tol of max(1, max|want|)."""
    want = _np(want)
    return max_err(_np(got), want) <= tol * max(1.0, float(np.abs(want).max()))


def _given(**arrays):
    return Draws(given={k: t(np.asarray(v)) for k, v in arrays.items()})


# ---------------------------------------------------------------------------
# regularizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sample", [False, True])
def test_diagonal_gaussian_regularizer(sample):
    moments = np.random.default_rng(0).normal(size=(2, 4, 4, 8)).astype(np.float32)
    moments[0, 0, 0, 4] = -40.0  # clamped logvar
    key = jax.random.PRNGKey(1)
    z_j, log_j = jreg.diagonal_gaussian_regularizer(jnp.asarray(moments),
                                                    key=key if sample else None, sample=sample)
    draws = _given(vae_eps=jax.random.normal(key, (2, 4, 4, 4))) if sample else None
    z_t, log_t = treg.diagonal_gaussian_regularizer(t(moments), draws, sample=sample)
    assert _close(z_t, z_j, 1e-5)
    assert _rel(log_t["kl_loss"], log_j["kl_loss"]) <= 1e-5
    if sample:
        with pytest.raises(ValueError, match="draws"):
            treg.diagonal_gaussian_regularizer(t(moments))


def test_identity_regularizer_and_perplexity():
    z = torch.arange(12.0).reshape(3, 4)
    out, log = treg.identity_regularizer(z)
    assert out is z and log == {}
    idx = np.random.default_rng(1).integers(0, 6, size=(40,))
    for n in (6, 9):
        pj, uj = jreg.measure_perplexity(jnp.asarray(idx), n)
        pt, ut = treg.measure_perplexity(t(idx), n)
        assert _rel(pt, pj) <= 1e-5 and int(ut) == int(uj)


@pytest.mark.parametrize("unknown", ["random", 0, 3])
def test_remap_to_used_and_back(unknown):
    rng = np.random.default_rng(2)
    used = np.array([1, 4, 5, 7, 9], np.int32)
    idx = rng.integers(0, 10, size=(3, 8)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    want = jreg.remap_to_used(jnp.asarray(idx), jnp.asarray(used), unknown, key=key)
    draws = _given(remap_idx=jax.random.randint(key, idx.shape, 0, len(used)))
    got = treg.remap_to_used(t(idx), t(used), unknown, draws=draws)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(treg.unmap_to_all(got, t(used)).numpy(),
                                  np.asarray(jreg.unmap_to_all(want, jnp.asarray(used))))
    if unknown == "random":
        with pytest.raises(ValueError, match="draws"):
            treg.remap_to_used(t(idx), t(used), unknown)


@pytest.mark.parametrize("remap", [False, True])
def test_vq_apply_and_its_gradient(remap):
    """Codes, commitment loss, perplexity, remapped indices and the
    straight-through gradient of (loss + sum z_q * c) with respect to z."""
    params = jreg.vq_init(jax.random.PRNGKey(4), n_e=10, e_dim=6)
    rng = np.random.default_rng(5)
    z = (rng.normal(size=(2, 3, 4, 6)) * 0.1).astype(np.float32)
    c = rng.normal(size=z.shape).astype(np.float32)
    used = np.array([0, 2, 3, 5, 8], np.int32) if remap else None
    key = jax.random.PRNGKey(6)
    kw = dict(beta=0.25, log_perplexity=True, sane_index_shape=not remap)

    def jfn(zz):
        zq, log = jreg.vq_apply(params, zz, used=None if used is None else jnp.asarray(used),
                                key=key, **kw)
        return log["loss/vq"] + jnp.sum(zq * c), (zq, log)

    (_, (zq_j, log_j)), g_j = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(z))
    zt = t(z).requires_grad_(True)
    draws = _given(remap_idx=jax.random.randint(key, (2, 12), 0, 5)) if remap else None
    zq_t, log_t = treg.vq_apply(to_torch(params), zt, used=None if used is None else t(used),
                                draws=draws, **kw)
    (log_t["loss/vq"] + (zq_t * t(c)).sum()).backward()
    assert _close(zq_t.detach(), zq_j, 1e-5)
    assert _close(zt.grad, g_j, 1e-5)
    for k in ("loss/vq", "perplexity", "cluster_usage"):
        assert _rel(log_t[k], log_j[k]) <= 1e-5, k
    np.testing.assert_array_equal(log_t["min_encoding_indices"].numpy(),
                                  np.asarray(log_j["min_encoding_indices"]))
    shape = (2, 3, 4, 6)
    assert _close(treg.vq_codebook_entry(to_torch(params), log_t["min_encoding_indices"], shape,
                                         None if used is None else t(used)),
                  jreg.vq_codebook_entry(params, log_j["min_encoding_indices"], shape,
                                         None if used is None else jnp.asarray(used)), 1e-6)


@pytest.mark.parametrize("hard", [True, False])
def test_gumbel_vq_apply(hard):
    params = jreg.gumbel_vq_init(jax.random.PRNGKey(7), num_hiddens=6, embedding_dim=5,
                                 n_embed=9)
    z = np.random.default_rng(8).normal(size=(2, 4, 4, 6)).astype(np.float32)
    noise = jax.random.gumbel(jax.random.PRNGKey(9), (2, 4, 4, 9), jnp.float32)
    zq_j, out_j = jreg.gumbel_vq_apply(params, jnp.asarray(z), temp=0.7, hard=hard, noise=noise,
                                       return_logits=True)
    zq_t, out_t = treg.gumbel_vq_apply(to_torch(params), t(z), _given(gumbel=noise), temp=0.7,
                                       hard=hard, return_logits=True)
    assert _close(zq_t, zq_j, 1e-5)
    assert _close(out_t["logits"], out_j["logits"], 1e-5)
    assert _rel(out_t["loss/vq"], out_j["loss/vq"]) <= 1e-5
    np.testing.assert_array_equal(out_t["indices"].numpy(), np.asarray(out_j["indices"]))
    assert _close(treg.gumbel_vq_codebook_entry(to_torch(params), out_t["indices"]),
                  jreg.gumbel_vq_codebook_entry(params, out_j["indices"]), 1e-6)
    with pytest.raises(ValueError, match="draws"):
        treg.gumbel_vq_apply(to_torch(params), t(z))


def test_ema_vq_apply_carries_its_state():
    """Two updating calls and a frozen one; the codebook statistics come
    back as state."""
    state_j = jreg.ema_vq_init(jax.random.PRNGKey(10), n_embed=8, embedding_dim=4)
    state_t = to_torch(state_j)
    rng = np.random.default_rng(11)
    for update in (True, True, False):
        z = rng.normal(size=(2, 5, 4)).astype(np.float32)
        zq_j, out_j, state_j = jreg.ema_vq_apply(state_j, jnp.asarray(z), 0.25, decay=0.9,
                                                 update=update)
        zq_t, out_t, state_t = treg.ema_vq_apply(state_t, t(z), 0.25, decay=0.9, update=update)
        assert _close(zq_t, zq_j, 1e-5)
        for k in ("loss/vq", "perplexity"):
            assert _rel(out_t[k], out_j[k]) <= 1e-5, k
        np.testing.assert_array_equal(out_t["encoding_indices"].numpy(),
                                      np.asarray(out_j["encoding_indices"]))
        assert _close(out_t["encodings"], out_j["encodings"], 0.0)
        for k in ("weight", "cluster_size", "embed_avg"):
            assert _close(state_t[k], state_j[k], 1e-5), k


def test_vq_with_input_projection():
    params = jreg.vq_proj_init(jax.random.PRNGKey(12), input_dim=9, n_codes=8, codebook_dim=4,
                               output_dim=6)
    z = np.random.default_rng(13).normal(size=(2, 5, 9)).astype(np.float32)
    zq_j, log_j = jreg.vq_proj_apply(params, jnp.asarray(z))
    zq_t, log_t = treg.vq_proj_apply(to_torch(params), t(z))
    assert zq_t.shape == (2, 5, 6) and _close(zq_t, zq_j, 1e-5)
    assert _rel(log_t["loss/vq"], log_j["loss/vq"]) <= 1e-5


def test_port_initializers_have_the_jax_structure():
    """The port's seeded initializers give the JAX trees' keys and shapes
    (kernels OIHW)."""
    def shapes(tree, conv):
        out = []
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            s = tuple(leaf.shape)
            if conv and len(s) == 4:
                s = (s[3], s[2], s[0], s[1])
            out.append((jax.tree_util.keystr(path), s))
        return out

    def jshapes(init_fn):
        return shapes(jax.eval_shape(init_fn, jax.random.PRNGKey(0)), True)

    init = Init(0, "cpu")
    pairs = [
        (lambda k: jreg.vq_init(k, 8, 4), treg.vq_init(init, 8, 4)),
        (lambda k: jreg.gumbel_vq_init(k, 6, 5, 9), treg.gumbel_vq_init(init, 6, 5, 9)),
        (lambda k: jreg.ema_vq_init(k, 8, 4), treg.ema_vq_init(init, 8, 4)),
        (lambda k: jreg.vq_proj_init(k, 9, 8, 4, 6), treg.vq_proj_init(init, 9, 8, 4, 6)),
        (lambda k: jdisc.init_discriminator_params(k, ndf=8, use_actnorm=True),
         tdisc.init_discriminator_params(init, ndf=8, use_actnorm=True)),
        (lambda k: jdisc.init_discriminator_params(k, ndf=8),
         tdisc.init_discriminator_params(init, ndf=8)),
        (jlpips.init_lpips_params, tlpips.init_lpips_params(init)),
    ]
    for init_fn, ttree in pairs:
        assert shapes(tree_map(lambda x: x.numpy(), ttree), False) == jshapes(init_fn)


# ---------------------------------------------------------------------------
# the VAE's encode with a regularizer, and the identity first stage
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reg", ["kl_sample", "kl_mean", "identity", "vq"])
def test_autoencoding_engine_encode(reg):
    jcfg, tcfg = jvae.VAEConfig(**TINY_VAE), tvae.VAEConfig(**TINY_VAE)
    params = random_params(lambda k: jvae.init_vae_params(k, jcfg), seed=14)
    jp, tp = jax.tree.map(jnp.asarray, params), to_torch(params)
    x = np.random.default_rng(15).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(16)
    vq = jreg.vq_init(jax.random.PRNGKey(17), n_e=8, e_dim=8)
    jr = {"identity": jreg.identity_regularizer, "vq": lambda m: jreg.vq_apply(vq, m)}.get(reg)
    tr = {"identity": treg.identity_regularizer,
          "vq": lambda m: treg.vq_apply(to_torch(vq), m)}.get(reg)
    z_j, log_j = jvae.autoencoding_engine_encode(jp, jnp.asarray(x), jr,
                                                 key if reg == "kl_sample" else None, jcfg,
                                                 return_reg_log=True)
    draws = _given(vae_eps=jax.random.normal(key, (2, 8, 8, 4))) if reg == "kl_sample" else None
    z_t, log_t = tvae.autoencoding_engine_encode(tp, t(x), tr, draws, tcfg, return_reg_log=True)
    assert z_t.shape == z_j.shape and _close(z_t, z_j, 1e-4)
    assert sorted(log_t) == sorted(log_j)
    for k in ("kl_loss", "loss/vq"):
        if k in log_j:
            assert _rel(log_t[k], log_j[k]) <= 1e-4, k
    z_only = tvae.autoencoding_engine_encode(tp, t(x), tr, draws, tcfg)
    assert torch.equal(z_only, z_t)
    assert tvae.identity_first_stage_encode(None, z_t) is z_t
    assert tvae.identity_first_stage_decode(None, z_t) is z_t


def test_vae_carries_gradients_to_f32_leaves_in_bf16():
    """A bf16 encode + decode gives each f32 leaf that requires grad a f32
    gradient (the casts are differentiable), within 5 % of the largest f32
    gradient of the f32 pass."""
    cfg = tvae.VAEConfig(**TINY_VAE)
    params = tree_map(lambda x: x.requires_grad_(True),
                      tvae.init_vae_params(cfg, seed=3, device="cpu"))
    x = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (1, 16, 16, 3))
                         .astype(np.float32))
    grads = {}
    for dt in (torch.float32, torch.bfloat16):
        out = tvae.vae_decode(params, tvae.vae_encode(params, x.to(dt), cfg)[..., :4], cfg)
        assert out.dtype == dt
        grads[dt] = torch.autograd.grad(out.float().square().mean(), list(tree_leaves(params)))
    scale = max(float(g.abs().max()) for g in grads[torch.float32])
    for g32, g16 in zip(grads[torch.float32], grads[torch.bfloat16]):
        assert g16.dtype == torch.float32
        assert max_err(g16, g32) <= 5e-2 * scale  # the card-vs-CPU checks' 5 %


# ---------------------------------------------------------------------------
# discriminator, LPIPS, loaders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("actnorm", [False, True])
def test_discriminator_and_d_losses(actnorm):
    params = random_params(lambda k: jdisc.init_discriminator_params(
        k, ndf=8, n_layers=3, use_actnorm=actnorm), seed=18)
    x = np.random.default_rng(19).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    tp = to_torch(params)
    want = jdisc.discriminator_apply(jp, jnp.asarray(x), 3, actnorm)
    got = tdisc.discriminator_apply(tp, t(x), 3, actnorm)
    assert got.shape == want.shape == (2, 2, 2, 1)
    assert _close(got, want, 1e-5)
    fake = jdisc.discriminator_apply(jp, -jnp.asarray(x), 3, actnorm)
    for jfn, tfn in ((jdisc.hinge_d_loss, tdisc.hinge_d_loss),
                     (jdisc.vanilla_d_loss, tdisc.vanilla_d_loss)):
        assert _rel(tfn(got, t(np.asarray(fake))), jfn(want, fake)) <= 1e-5
    with pytest.raises(ValueError, match="too small"):
        tdisc.discriminator_apply(tp, t(x[:, :8, :8]), 3, actnorm)


def test_actnorm():
    h = (np.random.default_rng(20).normal(size=(3, 5, 5, 6)) * 2 + 1).astype(np.float32)
    pj = jdisc.actnorm_init_from_batch(jnp.asarray(h))
    pt = tdisc.actnorm_init_from_batch(t(h))
    for k in ("loc", "scale"):
        assert _close(pt[k], pj[k], 1e-5), k
    yj, ldj = jdisc.actnorm_apply(pj, jnp.asarray(h), logdet=True)
    yt, ldt = tdisc.actnorm_apply(pt, t(h), logdet=True)
    assert _close(yt, yj, 1e-5) and _close(ldt, ldj, 1e-5)
    assert _close(tdisc.actnorm_apply(pt, yt, reverse=True), h, 1e-5)


def test_lpips_at_full_vgg_width():
    """Five VGG16 slices at their real widths on 32^2 inputs."""
    params = random_params(jlpips.init_lpips_params, seed=21)
    rng = np.random.default_rng(22)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = jlpips.lpips_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(y))
    got = tlpips.lpips_apply(to_torch(params), t(x), t(y))
    assert got.shape == (2,) and _rel(got, want) <= 1e-4
    assert float(tlpips.lpips_apply(to_torch(params), t(x), t(x)).abs().max()) < 1e-6


def _vgg_state_dicts(path, seed=0):
    """torchvision vgg16 ``features`` and taming LPIPS-head state dicts of
    random values, saved with torch.save."""
    gen = torch.Generator().manual_seed(seed)
    vgg, heads = {}, {}
    cin = 3
    for slice_ids, c in zip(tlpips.VGG_SLICES, tlpips.CHNS):
        for idx in slice_ids:
            vgg[f"features.{idx}.weight"] = torch.randn((c, cin, 3, 3), generator=gen) * 0.05
            vgg[f"features.{idx}.bias"] = torch.randn((c,), generator=gen) * 0.1
            cin = c
    for k, c in enumerate(tlpips.CHNS):
        heads[f"lin{k}.model.1.weight"] = torch.rand((1, c, 1, 1), generator=gen) * 0.01
    torch.save(vgg, path / "vgg16.pth")
    torch.save(heads, path / "vgg.pth")
    return str(path / "vgg.pth"), str(path / "vgg16.pth")


def test_load_lpips_torch(tmp_path):
    lp, vgg = _vgg_state_dicts(tmp_path)
    got = tlpips.load_lpips_torch(lp, vgg, device="cpu")
    want = to_torch(jlpips.load_lpips_torch(lp, vgg))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert len(got["lins"]) == 5 and got["vgg"]["0"]["w"].shape == (64, 3, 3, 3)


@pytest.mark.parametrize("actnorm", [False, True])
def test_load_discriminator_torch(tmp_path, actnorm):
    """A torch NLayerDiscriminator ``main.{i}`` state dict through torch.save
    and back: the port's parameters equal the JAX loader's carried across,
    and the loaded network's logits agree."""
    gen = torch.Generator().manual_seed(1)
    sd, cin, ndf, n_layers = {}, 3, 8, 3
    chans = [ndf * min(2 ** n, 8) for n in range(n_layers + 1)]

    def conv(i, cin, cout, bias=True):
        sd[f"main.{i}.weight"] = torch.randn((cout, cin, 4, 4), generator=gen) * 0.05
        if bias:
            sd[f"main.{i}.bias"] = torch.randn((cout,), generator=gen) * 0.1

    conv(0, cin, chans[0])
    for k in range(n_layers):
        conv(2 + 3 * k, chans[k], chans[k + 1], bias=actnorm)
        c = chans[k + 1]
        if actnorm:
            sd[f"main.{3 + 3 * k}.loc"] = torch.randn((1, c, 1, 1), generator=gen) * 0.1
            sd[f"main.{3 + 3 * k}.scale"] = 1 + torch.rand((1, c, 1, 1), generator=gen)
        else:
            sd[f"main.{3 + 3 * k}.weight"] = 1 + torch.randn((c,), generator=gen) * 0.1
            sd[f"main.{3 + 3 * k}.bias"] = torch.randn((c,), generator=gen) * 0.1
            sd[f"main.{3 + 3 * k}.running_mean"] = torch.zeros(c)
    conv(2 + 3 * n_layers, chans[-1], 1)
    torch.save(sd, tmp_path / "disc.pth")
    loaded = torch.load(tmp_path / "disc.pth", weights_only=True)
    got = tdisc.load_discriminator_torch(loaded, n_layers, actnorm, device="cpu")
    jp = jdisc.load_discriminator_torch(loaded, n_layers, actnorm)
    for a, b in zip(tree_leaves(got), tree_leaves(to_torch(jp))):
        assert torch.equal(a, b)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    assert _close(tdisc.discriminator_apply(got, t(x), n_layers, actnorm),
                  jdisc.discriminator_apply(jp, jnp.asarray(x), n_layers, actnorm), 1e-5)


# ---------------------------------------------------------------------------
# the l1 and lpips loss types
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("loss_type", ["l1", "lpips"])
def test_loss_types(loss_type):
    rng = np.random.default_rng(23)
    out = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    tgt = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    w = rng.uniform(0.5, 2, (2, 1, 1, 1)).astype(np.float32)
    mask = (rng.uniform(size=(2, 32, 32, 1)) > 0.5).astype(np.float32)
    op = np.ones((2, 32, 32, 1), np.float32)
    params = random_params(jlpips.init_lpips_params, seed=24)
    lp = params if loss_type == "lpips" else None
    want = jloss.compute_loss_terms(jnp.asarray(out), [], [], [], jnp.asarray(tgt),
                                    jnp.asarray(tgt), jnp.asarray(w), jnp.asarray(mask),
                                    jnp.asarray(op), cfg=jloss.DiffusionLossConfig(loss_type),
                                    lpips_params=lp)
    got = tloss.compute_loss_terms(t(out), [], [], [], t(tgt), t(tgt), t(w), t(mask), t(op),
                                   cfg=tloss.DiffusionLossConfig(loss_type),
                                   lpips_params=None if lp is None else to_torch(lp))
    assert got["l2"].shape == (2,) and _rel(got["l2"], want["l2"]) <= 1e-4
    assert got["fg"] is got["bg"] is got["rgb"] is None


def test_lpips_loss_errors():
    cfg = tloss.DiffusionLossConfig("lpips")
    x, w, op = torch.zeros(2, 8, 8, 3), torch.ones(2, 1, 1, 1), torch.ones(2, 8, 8, 1)
    with pytest.raises(ValueError, match="lpips params"):
        tloss.compute_loss_terms(x, [], [], [], x, x, w, None, op, cfg=cfg)
    x4 = torch.zeros(2, 8, 8, 4)
    with pytest.raises(ValueError, match="3-channel"):
        tloss.compute_loss_terms(x4, [], [], [], x4, x, w, None, op, cfg=cfg,
                                 lpips_params=tlpips.init_lpips_params(Init(0, "cpu")))
    with pytest.raises(NotImplementedError, match="l3"):
        tloss.compute_loss_terms(x, [], [], [], x, x, w, None, op,
                                 cfg=tloss.DiffusionLossConfig("l3"))


def test_engine_reads_lpips_once(tmp_path):
    lp, vgg = _vgg_state_dicts(tmp_path, seed=2)
    cfg = EngineConfig(loss=tloss.DiffusionLossConfig("lpips", lpips_ckpt=lp, vgg_ckpt=vgg))
    eng = Engine(cfg, device="cpu")
    want = tlpips.load_lpips_torch(lp, vgg, device="cpu")
    for a, b in zip(tree_leaves(eng.lpips_params), tree_leaves(want)):
        assert torch.equal(a, b)
    assert Engine(EngineConfig(), device="cpu").lpips_params is None


# ---------------------------------------------------------------------------
# the AE trainer
# ---------------------------------------------------------------------------


def _ae_configs(**kw):
    jcfg = jae.AEEngineConfig(vae=jvae.VAEConfig(**TINY_AE_VAE), **{**TINY_AE, **kw})
    tcfg = tae.AEEngineConfig(vae=tvae.VAEConfig(**TINY_AE_VAE), **{**TINY_AE, **kw})
    assert [f.name for f in dataclasses.fields(tcfg)] == [f.name for f in
                                                           dataclasses.fields(jcfg)]
    return jcfg, tcfg


def _adam_grad(mu, b1=0.9):
    """The gradient of a first Adam step, from its first moment."""
    return np.asarray(mu) / (1.0 - b1)


def test_ae_engine_config_defaults_match_jax():
    assert tae.AEEngineConfig() == tae.AEEngineConfig(**{
        f.name: getattr(jae.AEEngineConfig(), f.name)
        for f in dataclasses.fields(jae.AEEngineConfig) if f.name != "vae"})


@pytest.mark.parametrize("use_lpips,disc_start", [(True, 0), (False, 1)])
def test_ae_train_step_matches_jax(use_lpips, disc_start):
    """One TINY step (with LPIPS on; or off with the GAN terms gated off by
    disc_start 1), then a validation step: every log value, every gradient
    of both optimizers and every updated leaf against the jitted JAX step
    (the leaves where the gradient is above rounding noise; every move is at
    most lr on both sides)."""
    jcfg, tcfg = _ae_configs(use_lpips=use_lpips, disc_start=disc_start)
    params = random_params(lambda k: jae.init_ae_engine(k, jcfg), seed=25)
    x = np.random.default_rng(26).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(27)

    jeng = jae.AEEngine(jcfg)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jae.AEEngineState(jp, jeng.tx_ae.init(jp["ae"]), jeng.tx_disc.init(jp["disc"]),
                               jnp.zeros((), jnp.int32))
    jnew, jlogs = jax.jit(jeng.train_step)(jstate, jnp.asarray(x), key)
    jval = jax.jit(functools.partial(jeng.validation_step, postfix="_ema"))(
        jnew, jnp.asarray(x), key)

    teng = tae.AEEngine(tcfg, device="cpu")
    tstate = teng.init_state(to_torch(params))
    old = tree_map(lambda v: v.detach().clone(), {k: tstate.params[k] for k in ("ae", "disc")})
    eps = jax.random.normal(key, (2, 32, 32, 4))
    tnew, tlogs = teng.train_step(tstate, t(x), _given(vae_eps=eps))
    assert tnew.step == 1
    assert sorted(tlogs) == sorted(jlogs)
    for k, want in jlogs.items():
        assert _rel(tlogs[k], want) <= 1e-4, (k, float(tlogs[k]), float(want))
    if disc_start:
        assert float(tlogs["train/disc_loss"]) == 0.0

    opts = {"ae": (tnew.opt_ae, jnew.opt_ae[0].mu), "disc": (tnew.opt_disc, jnew.opt_disc[0].mu)}
    for side, (opt, mu) in opts.items():
        leaves = list(tree_leaves(tnew.params[side]))
        # the JAX side carried across (kernels HWIO -> OIHW)
        jleaves = list(tree_leaves(to_torch(jax.tree.map(np.asarray, jnew.params[side]))))
        jmu = list(tree_leaves(to_torch(jax.tree.map(np.asarray, mu))))
        assert len(leaves) == len(jleaves) == len(jmu)
        # a leaf whose gradient is rounding noise (a bias that a GroupNorm of
        # one channel a group cancels) is held to 1e-3 of the side's largest
        # gradient, test_torch_train.py's floor
        side_floor = 1e-3 * max(float(m.abs().max()) for m in jmu) / 0.1
        for leaf, p0, jleaf, m in zip(leaves, tree_leaves(old[side]), jleaves, jmu):
            g_j = _adam_grad(m.numpy())
            g_t = _adam_grad(opt.state[leaf]["exp_avg"].numpy())
            floor = max(float(np.abs(g_j).max()), side_floor)
            assert max_err(g_t, g_j) <= 1e-4 * floor, side
            # Adam's first move is lr * g / (|g| + eps): where g is above
            # rounding noise the updated leaves agree within 1e-4 of
            # max|leaf|; elsewhere each side moves by at most lr
            new_t, new_j, p0 = leaf.detach().numpy(), jleaf.numpy(), p0.numpy()
            sure = np.abs(g_j) > 1e-3 * floor
            assert np.abs(new_t - new_j)[sure].max(initial=0.0) <= 1e-4 * np.abs(new_j).max()
            assert np.abs((new_t - p0) - (new_j - p0))[sure].max(initial=0.0) <= 1e-3 * tcfg.lr
            assert max(np.abs(new_t - p0).max(), np.abs(new_j - p0).max()) <= tcfg.lr * 1.001

    tval = teng.validation_step(tnew, t(x), _given(vae_eps=eps), postfix="_ema")
    assert sorted(tval) == sorted(jval) and "val_ema/disc_loss" in tval
    for k, want in jval.items():
        assert _rel(tval[k], want) <= 1e-4, k


def test_adaptive_weight_matches_jax():
    """The two-gradient shortcut on the step's graph against JAX's two vjp
    pullbacks through a second decode."""
    jcfg, tcfg = _ae_configs(use_lpips=False)
    params = random_params(lambda k: jae.init_ae_engine(k, jcfg), seed=1)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)

    @jax.jit
    def jfn(p, xx):
        z, _, _ = jae.ae_forward(p["ae"], xx, key, jcfg)
        return jae._adaptive_weight(p["ae"], None, z, xx, None, jcfg, p["disc"])

    want = jfn(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = tree_map(lambda v: v.requires_grad_(True), to_torch({k: params[k]
                                                              for k in ("ae", "disc")}))
    _, (_, logs) = tae.ae_loss(tp["ae"], tp["disc"], None, t(x),
                               _given(vae_eps=jax.random.normal(key, (2, 32, 32, 4))), 0, tcfg)
    assert _rel(logs["train/d_weight"], want) <= 1e-4


def test_disc_loss_falls_over_steps():
    """Six port steps on one batch: the discriminator learns it."""
    _, tcfg = _ae_configs(use_lpips=False)
    eng = tae.AEEngine(tcfg, device="cpu")
    state = eng.init_state(tae.init_ae_engine(tcfg, seed=0, device="cpu"))
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(1)) * 2 - 1
    losses = []
    for i in range(6):
        state, logs = eng.train_step(state, x, Draws(torch.Generator().manual_seed(10 + i)))
        assert all(np.isfinite(float(v)) for v in logs.values())
        losses.append(float(logs["train/disc_loss"]))
    assert losses[-1] < losses[0] and state.step == 6
