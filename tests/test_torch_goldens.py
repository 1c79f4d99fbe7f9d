"""The port held to the committed goldens (tests/goldens/goldens.npz), on
the CPU in float32. Each key's inputs are built as
tools/goldens_lib.py::compute_goldens builds them: the JAX initializers at
the same keys give the parameters (carried across with ``io/from_jax``),
and the JAX draws of PRNGKey(0) (the sample's initial noise) and
PRNGKey(1) (the training step's key splits) are made here with ``jax``
and handed to the port as tensors.

Tolerances, those of the parity tests of the same functions: the
guiders, the schedule and the compact projection 1e-6 of max|golden|; the
text towers 2e-5 (tests/test_torch_clip.py); the VAE and the conditioner
2e-4 (tests/test_torch_train.py, test_torch_unet_vae.py); the 3-step
``Engine.sample`` 1e-5 (tests/test_torch_engine.py); ``train1_*`` 1e-4
(tests/test_torch_train.py).

Not held here: ``unet_plain_eps`` and ``unet_pose_eps`` are all zeros (the
UNet's out conv is zero-initialized), so they match anything;
``sample3_latent_tp`` is held by tests/test_torch_parallel.py's
tensor-parallel sample; ``capture_ref_tokens`` by
tests/test_torch_train_cli.py.

``ae1_*``: one ``AEEngine.train_step`` from the JAX ``init_ae_engine``
parameters at PRNGKey(22), images from PRNGKey(23) and the posterior draws
of PRNGKey(24), within 1e-4 relative (each log value; the update norm).
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.engine import Engine as JEngine
from custom_diffusion360_tpu.models import clip as jclip
from custom_diffusion360_tpu.models import nerf as jnerf
from custom_diffusion360_tpu.models import vae as jvae
from custom_diffusion360_torch.diffusion.discretization import legacy_ddpm_sigmas
from custom_diffusion360_torch.diffusion.guiders import (
    scheduled_cfg_img_text_ref,
    vanilla_cfg_img_ref,
)
from custom_diffusion360_torch.draws import Draws
from custom_diffusion360_torch.engine import Engine, EngineConfig
from custom_diffusion360_torch.geometry.cameras import Cameras
from custom_diffusion360_torch.models import clip as tclip
from custom_diffusion360_torch.models import nerf as tnerf
from custom_diffusion360_torch.models import vae as tvae
from custom_diffusion360_torch.models.clip import ClipTextConfig
from custom_diffusion360_torch.models.conditioner import (
    ConditionerConfig,
    get_unconditional_conditioning,
)
from custom_diffusion360_torch.models.unet import UNetConfig, attn_block_meta, build_unet_spec
from custom_diffusion360_torch.models.vae import VAEConfig
from custom_diffusion360_torch.train.trainer import TrainConfig, Trainer, tree_leaves
from tests.test_torch_common import t, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)
from tests.test_torch_train import _raymarch_draws, replay_draws

pytestmark = pytest.mark.usefixtures("torch_threads")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2  # reference views of tests/test_engine.py


@pytest.fixture(scope="module")
def golden():
    with np.load(os.path.join(REPO, "tests", "goldens", "goldens.npz")) as z:
        return {k: z[k] for k in z.files}


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)


def _fields(cls, cfg):
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cls)})


def port_config(jcfg):
    """The port's EngineConfig of a JAX EngineConfig (the fields both have)."""
    jc = jcfg.conditioner
    return EngineConfig(
        unet=_fields(UNetConfig, jcfg.unet), vae=_fields(VAEConfig, jcfg.vae),
        conditioner=ConditionerConfig(clip_l=ClipTextConfig(**dataclasses.asdict(jc.clip_l)),
                                      open_clip=ClipTextConfig(**dataclasses.asdict(jc.open_clip)),
                                      size_outdim=jc.size_outdim))


@functools.lru_cache(maxsize=1)
def tiny_engine_params():
    """(JAX TINY_CFG, its params at PRNGKey(0) as numpy) (goldens_lib.py)."""
    from tests.test_engine import TINY_CFG

    with jax.default_matmul_precision("float32"):
        params = JEngine(TINY_CFG).init_params(jax.random.PRNGKey(0))
    return TINY_CFG, jax.tree.map(np.asarray, params)


def rot_cams(n, seed):
    """goldens_lib.py's ring cameras (a yaw from rng(seed) each)."""
    th = np.random.default_rng(seed).uniform(0, 2 * np.pi, n)
    R = np.stack([np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                           np.float32) for a in th])
    T = np.tile(np.array([0, 0, 2.7], np.float32), (n, 1))
    return Cameras.create(R, T, 2.0, 0.0)


def sample3_inputs():
    """The port's inputs of the golden 3-step sample (sample3_latent and,
    tensor-parallel, sample3_latent_tp): TINY_CFG engine and params,
    reference buffers from rng(3), rot_cams(2 (1 + N), 105), zero
    conditioning, vanilla_cfg_img_ref(7.5), and the initial noise of
    jax.random.split(PRNGKey(0))[0]."""
    jcfg, params = tiny_engine_params()
    cfg = port_config(jcfg)
    from custom_diffusion360_torch.io.delta import iter_pose_blocks

    refs = {}
    rng = np.random.default_rng(3)
    for _, _, attn_id, d in iter_pose_blocks(cfg.unet):
        refs.setdefault(attn_id, {})[d] = t(rng.normal(size=(N + 1, 16, 128))
                                            .astype(np.float32) * 0.1)
    k_noise, _ = jax.random.split(jax.random.PRNGKey(0))
    noise = t(np.asarray(jax.random.normal(k_noise, (1, 8, 8, 4), jnp.float32)))
    cond = {"crossattn": torch.zeros((1, 16, cfg.unet.context_dim)),
            "vector": torch.zeros((1, cfg.unet.adm_in_channels))}
    return dict(engine_cfg=cfg, params=to_torch(params), references=refs, cond=cond,
                guider=vanilla_cfg_img_ref(scale=7.5), noise=noise,
                cams=rot_cams(2 * (1 + N), 105).reshape(2, 1 + N), choices=np.arange(N),
                steps=3)


def test_schedule_and_guiders(golden):
    assert _rel(legacy_ddpm_sigmas(50), golden["sigmas_legacy_ddpm_50"]) <= 1e-6
    rng = np.random.default_rng(106)
    xg = t(rng.normal(size=(4, 4, 4, 2)).astype(np.float32))
    xg3 = t(rng.normal(size=(6, 4, 4, 2)).astype(np.float32))
    one = torch.ones(())
    assert _rel(vanilla_cfg_img_ref(scale=5.0).combine(xg, one),
                golden["guider_vanilla_combine"]) <= 1e-6
    assert _rel(scheduled_cfg_img_text_ref(scale=5.0, scale_im=3.0).combine(xg3, one),
                golden["guider_scheduled_combine"]) <= 1e-6


@pytest.mark.parametrize("tower", ["clip", "open_clip"])
def test_text_towers(golden, tower):
    kw = dict(vocab_size=32, width=16, heads=2, context_length=8)
    if tower == "clip":
        kw.update(layers=2)
        key, names = 11, {"final": "clip_final", "penultimate": "clip_penultimate"}
    else:
        kw.update(layers=3, act="gelu", text_projection=True)
        key, names = 12, {"penultimate": "open_clip_penultimate", "pooled": "open_clip_pooled"}
    params = jclip.init_clip_text_params(jax.random.PRNGKey(key), jclip.ClipTextConfig(**kw))
    toks = np.random.default_rng(101).integers(0, 33, (2, 8)).astype(np.int32)
    rep = tclip.clip_text_apply(to_torch(jax.tree.map(np.asarray, params)),
                                torch.from_numpy(toks).long(), ClipTextConfig(**kw))
    for name, key_name in names.items():
        assert _rel(rep[name], golden[key_name]) <= 2e-5, key_name


def test_vae(golden):
    from tests.test_io import TINY_VAE

    params = to_torch(jax.tree.map(np.asarray, jvae.init_vae_params(jax.random.PRNGKey(10),
                                                                   TINY_VAE)))
    cfg = _fields(VAEConfig, TINY_VAE)
    rng = np.random.default_rng(100)
    x = t(rng.normal(size=(1, 32, 32, 3)).astype(np.float32) * 0.5)
    z = t(rng.normal(size=(1, 16, 16, TINY_VAE.z_channels)).astype(np.float32))
    assert _rel(tvae.vae_encode(params, x, cfg), golden["vae_moments"]) <= 2e-4
    assert _rel(tvae.vae_decode(params, z, cfg), golden["vae_decode"]) <= 2e-4


def test_conditioner(golden):
    from tests.test_engine import _train_batch

    jcfg, params = tiny_engine_params()
    batch = {k: (t(np.asarray(v)) if k != "cams" and v is not None else v)
             for k, v in _train_batch().items() if k != "cams"}
    c, uc = get_unconditional_conditioning(to_torch(params)["conditioner"], batch, batch,
                                           port_config(jcfg).conditioner,
                                           force_uc_zero_txt=True, ref=False)
    assert _rel(c["crossattn"], golden["cond_c_crossattn"]) <= 2e-4
    assert _rel(c["vector"], golden["cond_c_vector"]) <= 2e-4
    assert _rel(uc["crossattn"], golden["cond_uc_crossattn"]) <= 2e-4


def test_compact_ref_projection(golden):
    kw = dict(dim=32, num_freqs=4)
    params = jnerf.init_nerf_params(jax.random.PRNGKey(21), jnerf.NerfConfig(**kw))
    rng = np.random.default_rng(109)
    zero = t(rng.normal(size=(16, 32)).astype(np.float32))
    chosen = t(rng.normal(size=(2, 16, 32)).astype(np.float32))
    got = tnerf.project_ref_maps(to_torch(jax.tree.map(np.asarray, params)),
                                 tnerf.CompactRefTokens(zero, chosen, 1, 2),
                                 tnerf.NerfConfig(**kw))
    want = golden["compact_ref_projection"]
    width = want.shape[-1]  # the port pads the channels to CHANNEL_ALIGN with zeros
    assert _rel(got[..., :width], want) <= 1e-6
    assert not got[..., width:].any()


def test_sample3_latent(golden):
    inp = sample3_inputs()
    eng = Engine(inp["engine_cfg"], device="cpu")
    z = eng.sample(inp["params"], inp["cond"], inp["cond"], inp["guider"], noise=inp["noise"],
                   cams=inp["cams"], references=inp["references"], choices=inp["choices"],
                   num_steps=inp["steps"])
    assert _rel(z, golden["sample3_latent"]) <= 1e-5


def train1_draws(key, cfg: UNetConfig):
    """The draws of JAX Trainer.train_step(state, batch, key) on
    tests/test_engine.py's batch: Engine.training_loss's top-level splits
    (tests/test_torch_train.py::replay_draws) and, for each pose block, the
    ray-march key that the UNet's per-layer splits (unet.py:481-486) and
    the spatial transformer's per-pose-block splits (transformer.py:589)
    hand it, replayed as the port's ``nerf/<attn_id>/<d>/`` draws."""
    given = {k: t(np.asarray(v)) for k, v in replay_draws(key).items()}
    k_loss = jax.random.split(key, 3)[2]
    k_model = jax.random.split(k_loss, 6)[5]
    inb, mid, outb, _ = build_unet_spec(cfg)
    layers = [s for blk in inb for s in blk] + list(mid) + [s for blk in outb for s in blk]
    k = k_model
    for spec in layers:
        k, sub = jax.random.split(k)
        if spec[0] != "attn":
            continue
        _, ch, depth, attn_id = spec
        tcfg = cfg.transformer_config(ch, depth, attn_id)
        res = 8 // attn_block_meta(cfg)[attn_id][0]  # the 8^2 latent over the block's ds
        for d in range(depth):
            if not tcfg.block_has_nerf(d):
                continue
            sub, bkey = jax.random.split(sub)
            for name, v in _raymarch_draws(bkey, 1, res, cfg.num_samples).items():
                given[f"nerf/{attn_id}/{d}/{name}"] = v
    return given


def test_train1_loss_and_update_norm(golden):
    from tests.test_engine import _train_batch

    jcfg, params = tiny_engine_params()
    cfg = port_config(jcfg)
    jb = _train_batch()
    batch = {k: t(np.asarray(v)) for k, v in jb.items() if k != "cams" and v is not None}
    batch["cams"] = Cameras(*(t(np.asarray(f)) for f in jb["cams"]))
    eng = Engine(cfg, device="cpu")
    tr = Trainer(eng, TrainConfig())
    state = tr.init_state(to_torch(params))
    old = [leaf.detach().clone() for leaf in tr.trainable(state)]
    draws = Draws(given=train1_draws(jax.random.PRNGKey(1), cfg.unet))
    state, metrics = tr.train_step(state, batch, draws)
    loss = torch.stack([metrics[k] for k in ("loss_total", "loss", "loss_fg", "loss_bg",
                                             "loss_rgb")])
    assert _rel(loss, golden["train1_loss"]) <= 1e-4
    update = torch.sqrt(sum(((leaf.detach() - o) ** 2).sum()
                            for leaf, o in zip(tr.trainable(state), old)))
    assert _rel(update, golden["train1_update_norm"]) <= 1e-4
    assert len(list(tree_leaves(state.params))) > len(old)


def test_ae1_losses_and_update_norm(golden):
    from custom_diffusion360_tpu.models.vae import VAEConfig as JVAEConfig
    from custom_diffusion360_tpu.train import ae_engine as jae
    from custom_diffusion360_torch.train import ae_engine as tae

    kw = dict(disc_ndf=8, use_lpips=False, lr=1e-3)
    vae = dict(ch=32, ch_mult=(1,), num_res_blocks=1, z_channels=4)
    jcfg = jae.AEEngineConfig(vae=JVAEConfig(**vae), **kw)
    params = jax.tree.map(np.asarray, jae.init_ae_engine(jax.random.PRNGKey(22), jcfg))
    x = jax.random.uniform(jax.random.PRNGKey(23), (2, 32, 32, 3), jnp.float32, -1.0, 1.0)
    eps = jax.random.normal(jax.random.PRNGKey(24), (2, 32, 32, 4), jnp.float32)
    eng = tae.AEEngine(tae.AEEngineConfig(vae=VAEConfig(**vae), **kw), device="cpu")
    state = eng.init_state(to_torch(params))
    old = [leaf.detach().clone() for side in ("ae", "disc")
           for leaf in tree_leaves(state.params[side])]
    state, logs = eng.train_step(state, t(np.asarray(x)),
                                 Draws(given={"vae_eps": t(np.asarray(eps))}))
    want = golden["ae1_losses"]
    got = np.array([float(logs[k]) for k in sorted(logs)], np.float32)
    assert got.shape == want.shape
    assert (np.abs(got - want) <= 1e-4 * np.abs(want)).all(), (got, want)
    new = [leaf.detach() for side in ("ae", "disc") for leaf in tree_leaves(state.params[side])]
    update = torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(new, old)))
    assert _rel(update, golden["ae1_update_norm"]) <= 1e-4
