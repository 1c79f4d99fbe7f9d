"""The training slice of the port against the JAX package, on the CPU in
float32: the VAE encoder, the loss terms, the stochastic FeatureNeRF
branches with injected draws, the parameter labels, and one whole
``Trainer.train_step``.

The whole step is made deterministic on both sides with
``UNetConfig(stratified=False, imp_sampling_percent=1.0)`` (no ray or
length jitter, and the coin never takes the stratified branch); the draws
of the step's top-level key splits (engine, loss, denoiser, VAE) are
replayed in JAX and handed to the port as tensors. The JAX step is jitted
once; its per-leaf gradients are read back from AdamW's first moment after
the step (mu = (1 - b1) g from zero). Tolerances: 1e-4 relative for the
loss, every metric and the gradient norm; each trainable leaf's gradient
within 1e-4 of its max|g|, floored at 1e-3 of the step's largest leaf
gradient (a leaf whose exact gradient is zero, such as the per-view logit
bias under the softmax over views, carries rounding noise only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from custom_diffusion360_tpu.diffusion import loss as jloss
from custom_diffusion360_tpu.engine import Engine as JEngine
from custom_diffusion360_tpu.engine import EngineConfig as JEngineConfig
from custom_diffusion360_tpu.models import nerf as jnerf
from custom_diffusion360_tpu.models import vae as jvae
from custom_diffusion360_tpu.models.clip import ClipTextConfig as JClipCfg
from custom_diffusion360_tpu.models.conditioner import ConditionerConfig as JCondCfg
from custom_diffusion360_tpu.models.unet import UNetConfig as JUNetConfig
from custom_diffusion360_tpu.train import trainer as jtrainer
from custom_diffusion360_torch.diffusion import loss as tloss
from custom_diffusion360_torch.draws import Draws
from custom_diffusion360_torch.engine import Engine, EngineConfig
from custom_diffusion360_torch.geometry.cameras import Cameras
from custom_diffusion360_torch.models import nerf as tnerf
from custom_diffusion360_torch.models import vae as tvae
from custom_diffusion360_torch.models.clip import ClipTextConfig
from custom_diffusion360_torch.models.conditioner import ConditionerConfig
from custom_diffusion360_torch.models.unet import UNetConfig
from custom_diffusion360_torch.train import trainer as ttrainer
from tests.test_cameras import random_cameras
from tests.test_torch_common import max_err, random_params, t, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

B, N, RES = 1, 2, 64  # image 64^2 -> latent 8^2
VOCAB = 64
# two pose blocks in one transformer (poscontrol_interval 1) so the second
# samples by importance from the first; ray chunk 8 < 16 tokens so the
# chunked, rematerialized encode runs
UNET = dict(
    model_channels=32, channel_mult=(1, 2), transformer_depth=(1, 2),
    attention_resolutions=(2,), context_dim=96, adm_in_channels=72,
    num_head_channels=16, image_cross_blocks=(1,), poscontrol_interval=1,
    num_samples=4, num_freqs=2, nerf_chunk_size=8,
    stratified=False, imp_sampling_percent=1.0,
)
VAE = dict(ch=16, ch_mult=(1, 2, 4, 4), num_res_blocks=1)
CLIP_L = dict(vocab_size=VOCAB, width=48, layers=1, heads=4, context_length=16)
OPEN = dict(vocab_size=VOCAB, width=48, layers=2, heads=4, context_length=16, act="gelu",
            text_projection=True)
REL_TOL = 1e-4


def _cfgs():
    jcfg = JEngineConfig(
        unet=JUNetConfig(**UNET), vae=jvae.VAEConfig(**VAE),
        conditioner=JCondCfg(clip_l=JClipCfg(**CLIP_L), open_clip=JClipCfg(**OPEN),
                             size_outdim=4),
    )
    tcfg = EngineConfig(
        unet=UNetConfig(**UNET), vae=tvae.VAEConfig(**VAE),
        conditioner=ConditionerConfig(clip_l=ClipTextConfig(**CLIP_L),
                                      open_clip=ClipTextConfig(**OPEN), size_outdim=4),
    )
    return jcfg, tcfg


def _tokens(m, rng):
    """Ids below the vocab, with the V* id (= vocab_size) at position 2 and
    the highest id (the eot) after it."""
    toks = rng.integers(1, VOCAB - 1, size=(m, 16)).astype(np.int32)
    toks[:, 2] = VOCAB
    toks[:, 5] = VOCAB - 1
    toks[:, 6:] = 0
    return toks


def _tcams(jc):
    return Cameras(*(t(np.asarray(f)) for f in jc))


def _batch(B=B, seed=0):
    """(JAX batch, port batch) of B rows from rng(seed)."""
    rng = np.random.default_rng(seed)
    jc = random_cameras((1 + N) * B, seed=2 + seed).reshape(B, 1 + N)
    opacity = (rng.uniform(size=(B, RES, RES, 1)) > 0.5).astype(np.float32)
    batch = {
        "image": rng.normal(size=(B, RES, RES, 3)).astype(np.float32) * 0.2,
        "image_ref": rng.normal(size=(B, N, RES, RES, 3)).astype(np.float32) * 0.2,
        "mask": (rng.uniform(size=(B, RES // 8, RES // 8, 1)) > 0.3).astype(np.float32),
        "mask_ref": (rng.uniform(size=(B, N, RES, RES, 1)) > 0.2).astype(np.float32),
        "opacity": opacity,
        "drop_im": np.ones((B,), np.float32),
        "tokens_clip": _tokens(B, rng), "tokens_open": _tokens(B, rng),
        "original_size": np.full((B, 2), 64.0, np.float32),
        "crop_coords": np.zeros((B, 2), np.float32),
        "target_size": np.full((B, 2), 64.0, np.float32),
        "tokens_clip_ref": _tokens(B * N, rng), "tokens_open_ref": _tokens(B * N, rng),
        "original_size_ref": np.full((B * N, 2), 64.0, np.float32),
        "crop_coords_ref": np.zeros((B * N, 2), np.float32),
        "target_size_ref": np.full((B * N, 2), 64.0, np.float32),
    }
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jbatch["cams"] = jc
    tbatch = {k: t(v) for k, v in batch.items()}
    tbatch["cams"] = _tcams(jc)
    return jbatch, tbatch


def replay_draws(key, lat=RES // 8, b=B):
    """The draws of Engine.training_loss's key splits (engine.py:151,
    loss.py:84-95, denoiser.py:98-104, vae.py:253) for a batch of ``b``
    rows, as numpy arrays under the port's draw names."""
    k_enc, k_encr, k_loss = jax.random.split(key, 3)
    k_sig, k_noise, k_sigref, k_noiseref, k_noiseref2, _ = jax.random.split(k_loss, 6)
    z, zr = (b, lat, lat, 4), (b, N, lat, lat, 4)
    u = jax.random.uniform(k_sig, (b,))
    return {
        "vae_eps": jax.random.normal(k_enc, z),
        "vae_eps_ref": jax.random.normal(k_encr, (b * N, lat, lat, 4)),
        "sigma_idx": ((1.0 - u**3) * 999).astype(jnp.int32),
        "noise": jax.random.normal(k_noise, z),
        "sigma_ref_idx": jax.random.randint(k_sigref, (b,), 0, 50),
        "noise_ref": jax.random.normal(k_noiseref, zr),
        "noise_ref2": jax.random.normal(k_noiseref2, zr),
    }


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    jeng = JEngine(jcfg)
    params = random_params(jeng.init_params, seed=3)
    return jeng, Engine(tcfg, device="cpu"), params


def _scale(x):
    return max(float(np.abs(np.asarray(x)).max()), 1e-12)


def _adam_grads(opt_state, b1):
    """Per-leaf gradients of the first AdamW step, mu / (1 - b1), in the
    order of the params' leaves (None for leaves outside the train and
    lowlr groups)."""
    is_masked = lambda x: isinstance(x, optax.MaskedNode)  # noqa: E731
    out = None
    for label in ("train", "lowlr"):
        (adam, *_) = opt_state.inner_states[label].inner_state
        mus = jax.tree.leaves(adam.mu, is_leaf=is_masked)
        if out is None:
            out = [None] * len(mus)
        for i, mu in enumerate(mus):
            if not is_masked(mu):
                out[i] = np.asarray(mu) / (1.0 - b1)
    return out


def test_train_step_matches_jax(setup):
    jeng, teng, params = setup
    jbatch, tbatch = _batch()
    key = jax.random.PRNGKey(1)

    jcfg = jtrainer.TrainConfig()
    jtr = jtrainer.Trainer(jeng, jcfg)
    jstate = jtr.init_state(jax.tree.map(jnp.asarray, params))
    jstate = jstate._replace(step=jnp.ones((), jnp.int32))  # fg/bg count from step 1
    jnew, jmetrics = jax.jit(jtr.train_step)(jstate, jbatch, key)
    jgrads = _adam_grads(jnew.opt_state, jcfg.b1)

    ttr = ttrainer.Trainer(teng, ttrainer.TrainConfig())
    tstate = ttr.init_state(to_torch(params))
    tstate = tstate._replace(step=1)
    old = ttrainer.tree_map(lambda x: x.detach().clone(), tstate.params)
    given = {k: t(np.asarray(v)) for k, v in replay_draws(key).items()}
    draws = Draws(torch.Generator().manual_seed(0), given)  # the never-taken coin
    tnew, tmetrics = ttr.train_step(tstate, tbatch, draws)

    assert set(tmetrics) == set(jmetrics)
    for name, want in jmetrics.items():
        got = float(tmetrics[name])
        assert abs(got - float(want)) <= REL_TOL * abs(float(want)), (name, got, float(want))

    floor = 1e-3 * max(_scale(g) for g in jgrads if g is not None)
    n_train = 0
    for lab, m, leaf, jg, jp, tp0 in zip(
        ttrainer.tree_leaves(ttr.labels), jax.tree.leaves(jtr.mask),
        ttrainer.tree_leaves(tnew.params), jgrads,
        jax.tree.leaves(jnew.params), ttrainer.tree_leaves(old),
    ):
        assert (lab != "frozen") == bool(m) == (jg is not None)
        if lab == "frozen":
            assert leaf.grad is None and not leaf.requires_grad
            assert leaf not in tnew.optimizer.state
            continue
        n_train += 1
        assert max_err(leaf.grad, jg) <= REL_TOL * max(_scale(jg), floor)
        # AdamW's first step moves each entry by about lr * sign(g); the
        # update agrees where the gradient is not within rounding of 0
        step_t = (leaf.detach() - tp0).numpy()
        step_j = np.asarray(jp) - tp0.numpy()
        sure = np.abs(jg) > 1e-3 * max(_scale(jg), floor)
        assert np.abs(step_t - step_j)[sure].max(initial=0.0) <= 1e-6
    assert n_train > 0


def test_vae_encode_and_sample_match_jax(setup):
    jeng, teng, params = setup
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    jcfg, tcfg = jeng.cfg.vae, teng.cfg.vae
    want = jvae.vae_encode(jax.tree.map(jnp.asarray, params["vae"]), jnp.asarray(x), jcfg)
    tp = to_torch(params["vae"])
    got = tvae.vae_encode(tp, t(x), tcfg)
    assert got.shape == (2, 4, 4, 8)
    assert max_err(got, want) <= 2e-4 * _scale(want)
    key = jax.random.PRNGKey(3)
    z_j = jvae.encode_first_stage(jax.tree.map(jnp.asarray, params["vae"]), jnp.asarray(x),
                                  key, jcfg)
    eps = jax.random.normal(key, (2, 4, 4, 4))
    z_t = tvae.encode_first_stage(tp, t(x), tcfg, eps=t(np.asarray(eps)))
    assert not z_t.requires_grad
    assert max_err(z_t, z_j) <= 2e-4 * _scale(z_j)
    # no draws: the posterior mean, as JAX without a key
    mean_j = jvae.encode_first_stage(jax.tree.map(jnp.asarray, params["vae"]),
                                     jnp.asarray(x), None, jcfg)
    assert max_err(tvae.encode_first_stage(tp, t(x), tcfg), mean_j) <= 2e-4 * _scale(mean_j)


@pytest.mark.parametrize("global_step", [0, 1])
def test_loss_terms_and_combination_match_jax(global_step):
    rng = np.random.default_rng(6)
    b, s = 2, 4
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    u = lambda *shape: rng.uniform(size=shape).astype(np.float32)  # noqa: E731
    args = dict(
        model_output=f(b, 8, 8, 4), target=f(b, 8, 8, 4), target_rgb=f(b, 32, 32, 3) * 0.5,
        w=u(b, 1, 1, 1) + 0.5, mask=(u(b, 8, 8, 1) > 0.3).astype(np.float32),
        opacity=(u(b, 32, 32, 1) > 0.6).astype(np.float32),
    )
    fg = [u(b, 16), u(b, 4)]  # pose blocks at 4^2 and 2^2 tokens
    alphas = [u(b, 16, s, 1), u(b, 4, s, 1)]
    rgb = [u(b, 16, 3), u(b, 4, 3)]
    want = jloss.compute_loss_terms(
        jnp.asarray(args["model_output"]), [jnp.asarray(a) for a in fg],
        [jnp.asarray(a) for a in alphas], [jnp.asarray(a) for a in rgb],
        *(jnp.asarray(args[k]) for k in ("target", "target_rgb", "w", "mask", "opacity")))
    got = tloss.compute_loss_terms(
        t(args["model_output"]), [t(a) for a in fg], [t(a) for a in alphas],
        [t(a) for a in rgb], *(t(args[k]) for k in ("target", "target_rgb", "w", "mask",
                                                    "opacity")))
    for name in ("l2", "fg", "bg", "rgb"):
        assert got[name].shape == want[name].shape
        assert max_err(got[name], want[name]) <= 1e-5 * _scale(want[name]), name
    drop = np.array([1.0, 0.0], np.float32)
    loss_j, m_j = jloss.combine_losses(want, jnp.asarray(drop), global_step)
    loss_t, m_t = tloss.combine_losses(got, t(drop), global_step)
    assert set(m_t) == set(m_j)
    assert abs(float(loss_t) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    for name in m_j:
        assert abs(float(m_t[name]) - float(m_j[name])) <= 1e-5 * abs(float(m_j[name])) + 1e-9


def _raymarch_draws(key, b, res, s):
    """JAX raymarch's key splits (nerf.py:217-236, rays.py:44-48) as the
    port's named draws."""
    k_rays, k_len, k_coin = jax.random.split(key, 3)
    kx, ky = jax.random.split(k_rays)
    k_strat, k_imp = jax.random.split(k_len)
    hw = res * res
    draws = {
        "ray_x": jax.random.uniform(kx, (res + 1,)),
        "ray_y": jax.random.uniform(ky, (res + 1,)),
        "strat": jax.random.uniform(k_strat, (b, hw, s + 1)),
        "imp": jax.random.uniform(k_imp, (b, hw, s)),
        "coin": jax.random.uniform(k_coin, ()),
    }
    return {k: t(np.asarray(v)) for k, v in draws.items()}


@pytest.mark.parametrize("prev", [False, True], ids=["stratified", "coin"])
def test_stochastic_raymarch_matches_jax(prev):
    """Stratified rays and lengths without a previous block; with one, the
    coin picks stratified or importance lengths (jittered): keys are taken
    until both outcomes of the coin have been compared."""
    b, n, res, s = 2, 2, 4, 6
    kw = dict(dim=16, num_samples=s, num_freqs=2, imp_sampling_percent=0.5)
    jcfg, tcfg = jnerf.NerfConfig(**kw), tnerf.NerfConfig(**kw)
    jc = random_cameras(b * (1 + n), seed=4).reshape(b, 1 + n)
    tc = _tcams(jc)
    rng = np.random.default_rng(7)
    pw = rng.uniform(size=(b, 64, s, 1)).astype(np.float32) if prev else None  # 8^2 -> 4^2
    seen = set()
    for seed in range(40):
        key = jax.random.PRNGKey(seed)
        given = _raymarch_draws(key, b, res, s)
        want = jnerf.raymarch(jc, res, jcfg, key, True,
                              prev_weights=None if pw is None else jnp.asarray(pw),
                              imp_sample_next_step=True)
        got = tnerf.raymarch(tc, res, tcfg, prev_weights=None if pw is None else t(pw),
                             imp_sample_next_step=True, draws=Draws(given=given))
        for name in ("rays", "ray_points", "dists", "ray_points_uniform", "dists_uniform"):
            assert max_err(got[name], want[name]) <= 1e-5 * _scale(want[name]), (seed, name)
        seen.add(bool(float(given["coin"]) < 0.5) if prev else True)
        if len(seen) == (2 if prev else 1):
            break
    assert len(seen) == (2 if prev else 1)


def test_dense_reference_mask_matches_jax():
    rng = np.random.default_rng(8)
    xref = rng.normal(size=(2, 3, 16, 5)).astype(np.float32)
    mask = (rng.uniform(size=(2, 3, 8, 8)) > 0.4).astype(np.float32)
    want = jnerf.apply_ref_mask(jnp.asarray(xref), jnp.asarray(mask))
    assert max_err(tnerf.apply_ref_mask(t(xref), t(mask)), want) == 0.0


@pytest.mark.parametrize("trainkeys", ["pose", "poseattn", "all"])
def test_labels_and_optimizer_groups_match_jax(setup, trainkeys):
    _, teng, params = setup
    want = jax.tree.leaves(jtrainer.label_params(params, trainkeys))
    got = list(ttrainer.tree_leaves(ttrainer.label_params(to_torch(params), trainkeys)))
    assert got == want
    assert {"train", "frozen"} <= set(got)
    assert ("lowlr" in got) == (trainkeys != "pose")
    mask = list(ttrainer.tree_leaves(ttrainer.trainable_mask(to_torch(params), trainkeys)))
    assert mask == [bool(m) for m in jax.tree.leaves(jtrainer.trainable_mask(params, trainkeys))]
    tr = ttrainer.Trainer(teng, ttrainer.TrainConfig(trainkeys=trainkeys))
    state = tr.init_state(to_torch(params))
    lrs = sorted(g["lr"] for g in state.optimizer.param_groups)
    assert lrs == ([1e-4] if trainkeys == "pose" else [pytest.approx(5e-6), 1e-4])
    n_opt = sum(len(g["params"]) for g in state.optimizer.param_groups)
    assert n_opt == sum(lab != "frozen" for lab in got)
    for lab, leaf in zip(got, ttrainer.tree_leaves(state.params)):
        assert leaf.requires_grad == (lab != "frozen")
        assert leaf.dtype == torch.float32


def test_label_params_rejects_unknown_trainkeys():
    with pytest.raises(ValueError, match="trainkeys"):
        ttrainer.label_params({"unet": {}}, "everything")
