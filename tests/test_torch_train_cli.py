"""The training CLI slice of the port vs the JAX package, on the CPU in
float32: the config parser, the learning-rate schedules, the trainer's
accumulation / per-group clipping / schedule against the optax chain, the
EMA, the reference capture (and the golden ``capture_ref_tokens``), the
delta export, checkpoints, the metrics file, and ``cli.train.main`` end to
end on a synthetic CO3D tree feeding ``cli.sample.main``.

Tolerances: config values equal; schedules within 1e-6; trainer params
(as the change from the start), EMA shadow (likewise), the loss terms and
the gradient norm within 1e-4 relative (a leaf's max over its max|JAX|,
the change plus four float32 roundings of the leaf's largest entry);
capture within 1e-4 of max|JAX|; the golden within test_goldens.py's
limits (1e-5 absolute or 1e-4 relative), but for its zero-image row (see
test_capture_golden); delta values equal.

The trainer runs with eps = 1 (AdamW's denominator then never divides a
gradient of rounding size by itself, so the update is smooth in the
gradient and a 1e-4 gradient error stays a 1e-4 update error) and with a
gradient-norm limit between the two groups' norms (the 'train' group
clips, the 'lowlr' one does not), so one global clip would differ.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from custom_diffusion360_tpu.engine import Engine as JEngine
from custom_diffusion360_tpu.io import delta as jdelta
from custom_diffusion360_tpu.train import capture as jcapture
from custom_diffusion360_tpu.train import ema as jema
from custom_diffusion360_tpu.train import lr_schedule as jsched
from custom_diffusion360_tpu.train import trainer as jtrainer
from custom_diffusion360_tpu.utils import config as jconfig
from custom_diffusion360_torch.cli import sample as tsample
from custom_diffusion360_torch.cli import train as tcli
from custom_diffusion360_torch.draws import Draws
from custom_diffusion360_torch.engine import Engine, EngineConfig
from custom_diffusion360_torch.geometry.cameras import Cameras
from custom_diffusion360_torch.io import delta as tdelta
from custom_diffusion360_torch.models.clip import ClipTextConfig
from custom_diffusion360_torch.models.conditioner import ConditionerConfig
from custom_diffusion360_torch.models.unet import UNetConfig
from custom_diffusion360_torch.models.vae import VAEConfig
from custom_diffusion360_torch.train import capture as tcapture
from custom_diffusion360_torch.train import checkpoint as tckpt
from custom_diffusion360_torch.train import ema as tema
from custom_diffusion360_torch.train import logging as tlog
from custom_diffusion360_torch.train import lr_schedule as tsched
from custom_diffusion360_torch.train import trainer as ttrainer
from custom_diffusion360_torch.utils import config as tconfig
from tests.test_data import make_synthetic_co3d
from tests.test_torch_common import max_err, random_params, t, to_torch
from tests.test_torch_train import RES, _batch, _cfgs, _tcams, replay_draws
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

REL_TOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _scale(x):
    return max(float(np.abs(np.asarray(x, np.float32)).max()), 1e-12)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

DOTLIST = ["16", "-3", "0x10", "010", "0b11", "1_000", "1:30", "1.5", "1.0e-4", "2.5E+3",
           "1.", ".5", ".inf", "-.inf", "1e-4", "+.5", "true", "False", "yes", "off", "null",
           "~", "", "[1, 2]", "[0.5, true, a]", "[[1, 2], [3]]", "[]", "{a: 1, b: [2, 3]}",
           "abc", "photo of a <new1> car", "'it''s'", '"16"', "None", "y"]


@pytest.mark.parametrize("raw", DOTLIST)
def test_parse_scalar_matches_yaml_without_yaml(raw, monkeypatch):
    want = yaml.safe_load(raw)
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml now fails
    got = tconfig._parse_scalar(raw)
    assert type(got) is type(want) and got == want, (raw, got, want)


def test_config_file_and_overrides_match_jax():
    from custom_diffusion360_tpu.engine import EngineConfig as JEngineConfig

    path = os.path.join(REPO, "configs", "train_co3d_concept.yaml")
    over = ["unet.num_samples=16", "unet.image_cross_blocks=[0, 2]", "loss.loss_fg_lambda=5",
            "compute_dtype=bfloat16", "sampler.s_churn=0.5", "sampler.order=3",
            "sampler_name=heun_edm", "discretization_name=edm", "denoiser.discrete=false"]
    got = tconfig.config_to_dict(tconfig.load_config(EngineConfig(), path, over))
    want = jconfig.config_to_dict(jconfig.load_config(JEngineConfig(), path, over))
    for section in ("unet", "loss", "denoiser"):
        for k, v in got[section].items():
            if k in want[section]:
                assert v == want[section][k], (section, k)
    assert got["sampler"] == want["sampler"] and got["sampler"]["s_churn"] == 0.5
    for k in ("sampler_name", "discretization_name", "num_sample_steps", "compute_dtype"):
        assert got[k] == want[k], k
    assert got["compute_dtype"] == "bfloat16" and got["unet"]["image_cross_blocks"] == [0, 2]
    cfg = tconfig.apply_overrides(EngineConfig(), ["loss.loss_rgb_lambda=1e-4"])
    assert cfg.loss.loss_rgb_lambda == 1e-4  # YAML 1.1's string, read into a float field
    with pytest.raises(KeyError, match="unknown config field"):
        tconfig.apply_overrides(EngineConfig(), ["unet.no_such_field=1"])
    # every DenoiserConfig is taken now (the v scaling here)
    eng = Engine(tconfig.apply_overrides(EngineConfig(), ["denoiser.scaling=v"]), device="cpu")
    assert eng.denoiser.cfg.scaling == "v" and eng.denoiser.scaling.__name__ == "v_scaling"


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

SCHEDULES = {
    "lambda_warmup_cosine": ((10, 0.1, 1.0, 0.01, 100), (0, 9, 10, 11, 55, 100, 101, 400)),
    "lambda_warmup_cosine2": (([5, 3], [0.1, 0.2], [1.0, 0.8], [0.0, 0.1], [20, 30]),
                              (0, 4, 5, 6, 19, 20, 22, 23, 24, 49, 50, 51, 200)),
    "lambda_linear": (([5, 3], [0.1, 0.2], [1.0, 0.8], [0.0, 0.1], [20, 30]),
                      (0, 4, 5, 6, 19, 20, 22, 23, 24, 49, 50, 51, 200)),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    args, steps = SCHEDULES[name]
    want, got = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for s in steps:
        assert abs(got(s) - float(want(s))) <= 1e-6, (name, s)


# ---------------------------------------------------------------------------
# trainer: accumulation, per-group clipping, schedule, EMA
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = _cfgs()
    jeng = JEngine(jcfg)
    params = random_params(jeng.init_params, seed=3)
    return jeng, Engine(tcfg, device="cpu"), params


def _ulps(p0):
    """Four float32 roundings of the leaf's largest entry: the change of a
    stored parameter is known to no better."""
    return 4 * float(np.finfo(np.float32).eps) * _scale(p0)


def _given(key):
    return {k: t(np.asarray(v)) for k, v in replay_draws(key).items()}


CALLS, ACC, MAX_NORM, EMA_DECAY = 6, 2, 3.0, 0.9
OPT = dict(lr=0.1, eps=1.0, multiplier=0.5, trainkeys="poseattn",
           accumulate_grad_batches=ACC, max_grad_norm=MAX_NORM)
SCHED = (2, 0.1, 1.0, 0.2, 5)  # multipliers 0.2, 0.6, 1.0 for updates 0, 1, 2


def test_accumulate_clip_schedule_and_ema_match_optax(engines):
    jeng, teng, params = engines
    jbatch, tbatch = _batch()
    jtr = jtrainer.Trainer(jeng, jtrainer.TrainConfig(
        **OPT, lr_schedule=jsched.lambda_warmup_cosine(*SCHED)))
    jstate = jtr.init_state(jax.tree.map(jnp.asarray, params))
    jstate = jstate._replace(step=jnp.ones((), jnp.int32))  # fg/bg count from step 1
    jstep = jax.jit(jtr.train_step)
    jshadow = jema.ema_init(jstate.params, jtr.mask)

    ttr = ttrainer.Trainer(teng, ttrainer.TrainConfig(
        **OPT, lr_schedule=tsched.lambda_warmup_cosine(*SCHED)))
    tstate = ttr.init_state(to_torch(params))
    tstate = tstate._replace(step=1)
    tshadow = tema.ema_init(tstate.params, ttrainer.trainable_mask(tstate.params, "poseattn"))
    start = [leaf.detach().clone() for leaf in ttrainer.tree_leaves(tstate.params)]

    for i in range(CALLS):
        key = jax.random.PRNGKey(10 + i)
        jstate, jm = jstep(jstate, jbatch, key)
        jshadow = jema.ema_update(jshadow, jstate.params, EMA_DECAY)
        tstate, tm = ttr.train_step(tstate, tbatch, Draws(torch.Generator().manual_seed(0),
                                                          _given(key)))
        tshadow = tema.ema_update(tshadow, tstate.params, EMA_DECAY)
        assert set(tm) == set(jm)
        for name, want in jm.items():
            assert abs(float(tm[name]) - float(want)) <= REL_TOL * abs(float(want)), (i, name)
        assert tstate.step == int(jstate.step) == 2 + i
        assert tstate.accum["mini_step"] == (i + 1) % ACC
        assert tstate.accum["applied"] == (i + 1) // ACC

    leaves = list(zip(ttrainer.tree_leaves(ttr.labels), ttrainer.tree_leaves(tstate.params),
                      jax.tree.leaves(jstate.params), start))
    shadows = jax.tree.leaves(jshadow.shadow)
    n_train = 0
    for lab, tp, jp, p0 in leaves:
        if lab == "frozen":
            assert torch.equal(tp, p0)
            continue
        moved_j = np.asarray(jp) - p0.numpy()
        moved_t = (tp.detach() - p0).numpy()
        assert np.abs(moved_t - moved_j).max() <= REL_TOL * _scale(moved_j) + _ulps(p0), lab
        n_train += 1
    assert n_train == len(shadows) and tshadow.updates == CALLS
    t_shadows = [s for s in ttrainer.tree_leaves(tshadow.shadow) if s is not None]
    trained = [p0 for lab, _, _, p0 in leaves if lab != "frozen"]
    for ts, js, p0 in zip(t_shadows, shadows, trained):
        moved_j = np.asarray(js) - p0.numpy()
        assert np.abs((ts - p0).numpy() - moved_j).max() <= REL_TOL * _scale(moved_j) + _ulps(p0)
    # both groups were trained; the 'train' group's update used a clipped gradient
    assert {lab for lab, *_ in leaves} == {"train", "lowlr", "frozen"}


def test_update_only_on_every_kth_call(engines):
    _, teng, params = engines
    _, tbatch = _batch()
    tr = ttrainer.Trainer(teng, ttrainer.TrainConfig(accumulate_grad_batches=3))
    state = tr.init_state(to_torch(params))
    p0 = [leaf.detach().clone() for leaf in tr.trainable(state)]
    given = _given(jax.random.PRNGKey(0))
    for i in range(3):
        state, _ = tr.train_step(state, tbatch, Draws(torch.Generator().manual_seed(0), given))
        moved = any(not torch.equal(a, b) for a, b in zip(tr.trainable(state), p0))
        assert moved == (i == 2), i
    assert state.step == 3 and state.accum["applied"] == 1


def test_ema_shadow_is_a_copy_and_swaps_in():
    w = torch.ones(3, requires_grad=True)
    params = {"a": w, "b": torch.zeros(2)}
    state = tema.ema_init(params, {"a": True, "b": False})
    assert state.shadow["b"] is None and state.shadow["a"].data_ptr() != w.data_ptr()
    opt = torch.optim.SGD([w], lr=1.0)
    w.grad = torch.ones(3)
    opt.step()  # in place, as AdamW
    assert torch.equal(state.shadow["a"], torch.ones(3))
    state = tema.ema_update(state, params, decay=0.5)
    d = min(0.5, 2.0 / 11.0)
    assert torch.allclose(state.shadow["a"], torch.full((3,), 1.0 - (1.0 - d)))
    swapped = tema.ema_swap(params, state)
    assert swapped["a"] is state.shadow["a"] and swapped["b"] is params["b"]


def test_resume_equals_uninterrupted(engines, tmp_path):
    _, teng, params = engines
    _, tbatch = _batch()
    cfg = ttrainer.TrainConfig(accumulate_grad_batches=2, max_grad_norm=1.0,
                               lr_schedule=tsched.lambda_warmup_cosine(1, 0.1, 1.0, 0.5, 4))

    def run(state, tr, ema, steps):
        for i in steps:
            given = _given(jax.random.PRNGKey(i))
            state, _ = tr.train_step(state, tbatch, Draws(torch.Generator().manual_seed(i), given))
            ema = tema.ema_update(ema, state.params, 0.9)
        return state, ema

    def fresh():
        tr = ttrainer.Trainer(teng, cfg)
        state = tr.init_state(to_torch(params))
        mask = ttrainer.trainable_mask(state.params)
        return tr, state, tema.ema_init(state.params, mask)

    tr, state, ema = fresh()
    want, want_ema = run(state, tr, ema, range(3))
    tr, state, ema = fresh()
    state, ema = run(state, tr, ema, range(1))  # stops mid-accumulation
    path = tckpt.save_train_state(str(tmp_path / "checkpoints"), state, ema=ema)
    assert os.path.basename(path) == "step_00000001"
    assert tckpt.latest_checkpoint(str(tmp_path / "checkpoints")) == path
    tr, state, ema = fresh()
    state, ema = tckpt.restore_train_state(path, state, ema)
    assert state.step == 1 and state.accum["mini_step"] == 1 and ema.updates == 1
    got, got_ema = run(state, tr, ema, range(1, 3))
    for a, b in zip(ttrainer.tree_leaves(got.params), ttrainer.tree_leaves(want.params)):
        assert torch.equal(a.detach(), b.detach())
    for a, b in zip(ttrainer.tree_leaves(got_ema.shadow), ttrainer.tree_leaves(want_ema.shadow)):
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b))
    assert got.optimizer.state_dict()["state"].keys() == want.optimizer.state_dict()["state"].keys()
    assert tckpt.latest_checkpoint(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------


def capture_draws(key, n_views, lat):
    """The draws of JAX capture_references's jax.random.split(key, 4)."""
    k_enc, k_sig, k_noise, k_noise2 = jax.random.split(key, 4)
    z = (1, n_views, lat, lat, 4)
    draws = {"vae_eps": jax.random.normal(k_enc, z[1:]),
             "sigma_ref_idx": jax.random.randint(k_sig, (1,), 0, 50),
             "noise_ref": jax.random.normal(k_noise, z),
             "noise_ref2": jax.random.normal(k_noise2, z)}
    return {k: t(np.asarray(v)) for k, v in draws.items()}


def test_capture_matches_jax(engines):
    jeng, teng, params = engines
    from tests.test_cameras import random_cameras

    n = 3
    rng = np.random.default_rng(11)
    imgs = rng.normal(size=(n, RES, RES, 3)).astype(np.float32) * 0.2
    jc = random_cameras(n + 2, seed=12).reshape(1, n + 2)
    cfg = jeng.cfg.unet
    cond = {"crossattn": rng.normal(size=(n + 2, 16, cfg.context_dim)).astype(np.float32) * 0.1,
            "vector": rng.normal(size=(n + 2, cfg.adm_in_channels)).astype(np.float32) * 0.1}
    key = jax.random.PRNGKey(7)
    want = jcapture.capture_references(jeng, jax.tree.map(jnp.asarray, params),
                                       jnp.asarray(imgs), jc,
                                       {k: jnp.asarray(v) for k, v in cond.items()}, key)
    got = tcapture.capture_references(
        teng, to_torch(params), t(imgs), _tcams(jc), {k: t(v) for k, v in cond.items()},
        Draws(given=capture_draws(key, n + 1, RES // 8)))
    assert got.keys() == want.keys() and got
    for attn_id in want:
        assert got[attn_id].keys() == want[attn_id].keys()
        for d, w in want[attn_id].items():
            assert tuple(got[attn_id][d].shape) == w.shape and w.shape[0] == n + 1
            assert max_err(got[attn_id][d], w) <= REL_TOL * _scale(w), (attn_id, d)


def test_capture_golden():
    """goldens.npz["capture_ref_tokens"], built as tools/goldens_lib.py
    builds it (TINY_CFG, PRNGKey(0) params, rng 110, rot_cams(5, 111),
    PRNGKey(20) replayed as draws). The rows of the three images hold the
    golden within test_goldens.py's limits. The last row, the appended zero
    image, is held within 1e-3 of max|golden|: with the initial weights the
    VAE encoder's activations of a zero image are constant over space, so
    its GroupNorm variances E[x^2] - E[x]^2 (one pass, in both packages)
    are differences of nearly equal sums, and their rounding depends on the
    order of summation (XLA's and torch's differ; the encoder moments of
    that image differ by 0.043 of 1.22 between the packages, those of a
    random image by 1e-6)."""
    from tests.test_engine import TINY_CFG

    golden = np.load(os.path.join(REPO, "tests", "goldens", "goldens.npz"))["capture_ref_tokens"]
    ju, jv, jc_ = TINY_CFG.unet, TINY_CFG.vae, TINY_CFG.conditioner
    cfg = EngineConfig(
        unet=UNetConfig(**{f.name: getattr(ju, f.name) for f in dataclasses.fields(UNetConfig)}),
        vae=VAEConfig(**{f.name: getattr(jv, f.name) for f in dataclasses.fields(VAEConfig)}),
        conditioner=ConditionerConfig(
            clip_l=ClipTextConfig(**dataclasses.asdict(jc_.clip_l)),
            open_clip=ClipTextConfig(**dataclasses.asdict(jc_.open_clip)),
            size_outdim=jc_.size_outdim))
    with jax.default_matmul_precision("float32"):
        params = JEngine(TINY_CFG).init_params(jax.random.PRNGKey(0))
    n_items = 3
    rng = np.random.default_rng(110)
    imgs = rng.normal(size=(n_items, 64, 64, 3)).astype(np.float32) * 0.2
    r = np.random.default_rng(111)
    th = r.uniform(0, 2 * np.pi, n_items + 2)
    R = np.stack([np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                           np.float32) for a in th])
    T = np.tile(np.array([0, 0, 2.7], np.float32), (n_items + 2, 1))
    cams = Cameras.create(R, T, 2.0, 0.0).reshape(1, n_items + 2)
    cond = {"crossattn": rng.normal(size=(n_items + 2, 16, ju.context_dim)).astype(np.float32)
            * 0.1,
            "vector": rng.normal(size=(n_items + 2, ju.adm_in_channels)).astype(np.float32) * 0.1}
    eng = Engine(cfg, device="cpu")
    cap = tcapture.capture_references(
        eng, to_torch(params), t(imgs), cams, {k: t(v) for k, v in cond.items()},
        Draws(given=capture_draws(jax.random.PRNGKey(20), n_items + 1, 8)))
    a0 = sorted(cap)[0]
    got = cap[a0][sorted(cap[a0])[0]].numpy()
    assert got.shape == golden.shape == (n_items + 1, 16, 128)
    scale = float(np.abs(golden).max())
    d = float(np.abs(got[:n_items] - golden[:n_items]).max())
    assert d <= 1e-5 or d <= 1e-4 * scale, d
    assert float(np.abs(got[n_items] - golden[n_items]).max()) <= 1e-3 * scale


# ---------------------------------------------------------------------------
# delta export
# ---------------------------------------------------------------------------


def test_extract_delta_matches_jax_and_round_trips(engines):
    jeng, _, params = engines
    cfg = jeng.cfg.unet
    rng = np.random.default_rng(13)
    refs = {}
    for _, _, attn_id, d in jdelta.iter_pose_blocks(cfg):
        refs.setdefault(attn_id, {})[d] = rng.normal(size=(4, 16, 64)).astype(np.float32)
    params = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    want = jdelta.extract_delta(jax.tree.map(jnp.asarray, params), refs, cfg)
    tparams = to_torch(params)
    trefs = {a: {d: t(v).to(torch.bfloat16) for d, v in per.items()} for a, per in refs.items()}
    got = tdelta.extract_delta(tparams, trefs, cfg)
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k == "embed":
            for g, ww in zip(got[k], w):
                np.testing.assert_array_equal(g, np.asarray(ww))
                assert g.dtype == np.float32
            continue
        assert got[k].dtype == np.float32 and got[k].shape == np.asarray(w).shape, k
        if k.endswith(".references"):  # written as float32 from bf16
            np.testing.assert_array_equal(got[k], t(np.asarray(w)).to(torch.bfloat16).float())
        else:
            np.testing.assert_array_equal(got[k], np.asarray(w))
    # apply_delta_state_dict(extract_delta(p)) gives p's pose leaves back
    target = to_torch(random_params(jeng.init_params, seed=4))
    target, back = tdelta.apply_delta_state_dict(target, got, cfg)
    for prefix, path, attn_id, d in tdelta.iter_pose_blocks(cfg):
        a = tdelta._get_block(target["unet"], path, d)
        b = tdelta._get_block(tparams["unet"], path, d)
        for _, keys, _ in tdelta._POSE_LEAVES:
            assert torch.equal(tdelta._tree_get(a, keys), tdelta._tree_get(b, keys)), keys
        assert torch.equal(back[attn_id][d], trefs[attn_id][d].float())
    for tower in ("clip_l", "open_clip"):
        assert torch.equal(target["conditioner"][tower]["modifier_rows"],
                           tparams["conditioner"][tower]["modifier_rows"])


# ---------------------------------------------------------------------------
# metrics file and image grid
# ---------------------------------------------------------------------------


def test_metrics_file_grows_its_schema_and_grid_writes(tmp_path):
    m = tlog.MetricsLogger(str(tmp_path), images_per_step=2)
    m.tic()
    m.toc()
    m.log(0, {"loss": torch.tensor(1.5)})
    m.log(1, {"val_loss": 2.0})
    m.close()
    resumed = tlog.MetricsLogger(str(tmp_path), images_per_step=2)
    resumed.log(2, {"loss": 1.0, "grad_norm": 3.0})
    resumed.close()
    import csv

    with open(tmp_path / "metrics.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["step"] for r in rows] == ["0", "1", "2"]
    assert set(rows[0]) == {"step", "images_per_min", "loss", "val_loss", "grad_norm"}
    assert rows[1]["val_loss"] == "2.0" and rows[2]["grad_norm"] == "3.0"
    assert tlog.MetricsLogger.device_memory_stats() == {} or torch.cuda.is_available()
    from PIL import Image

    imgs = np.linspace(-1, 1, 5 * 4 * 6 * 3, dtype=np.float32).reshape(5, 4, 6, 3)
    path = tlog.save_image_grid(str(tmp_path / "g" / "grid.png"), imgs, nrow=2)
    grid = np.asarray(Image.open(path))
    assert grid.shape == (3 * 4, 2 * 6, 3)
    want = np.clip((imgs[3] + 1.0) * 127.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(grid[4:8, 6:12], want)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def _tiny_yaml(path):
    """The sampling CLI's SMOKE_CFG as a --config file, with the test
    tokenizer's vocabulary so the <new1> id lands on modifier row 0."""
    tok, _ = tsample.make_tokenizers(None, context_length=16)
    d = tconfig.config_to_dict(tsample.SMOKE_CFG)
    for tower in ("clip_l", "open_clip"):
        d["conditioner"][tower]["vocab_size"] = tok.base_vocab_size
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return tok.base_vocab_size


def test_train_cli_on_co3d_resumes_and_feeds_sample_cli(tmp_path):
    root = make_synthetic_co3d(tmp_path / "co3d")
    vocab = _tiny_yaml(tmp_path / "tiny.yaml")
    out = tmp_path / "run"
    common = ["--data_root", root, "--category", "car", "--config", str(tmp_path / "tiny.yaml"),
              "--output_dir", str(out), "--img_size", "64", "--num_images", "3",
              "--batch_size", "1", "--log_every", "1", "--device", "cpu", "--use_ema",
              "--val_every", "1", "--ckpt_every", "1"]
    first = tcli.main(common + ["--max_steps", "2"])
    assert [s["step"] for s in first["steps"]] == [0, 1]
    assert os.listdir(out / "checkpoints") == ["step_00000002"]
    resumed = tcli.main(common + ["--max_steps", "3", "--resume"])
    assert [s["step"] for s in resumed["steps"]] == [2]
    assert sorted(os.listdir(out / "checkpoints")) == ["step_00000002", "step_00000003"]
    for name in ("delta_last.npz", "delta_step1.npz", "delta_step2.npz", "cameras.npz",
                 "config.json", "metrics.csv"):
        assert (out / name).exists(), name
    with np.load(out / "delta_last.npz") as z:
        keys = list(z.keys())
        refs = [k for k in keys if k.endswith(".references")]
        # 6 valid frames (12 frames, skip 2): 6 captured rows + the zero row
        assert refs and all(z[k].shape[0] == 7 and z[k].dtype == np.float32 for k in refs)
        assert np.isfinite(np.concatenate([z[k].ravel() for k in refs])).all()
        assert "embed.0" in keys and "embed.1" in keys
    with open(out / "metrics.csv") as f:
        header = f.readline().strip().split(",")
        rows = f.read().strip().splitlines()
    assert {"loss", "grad_norm", "step_ms", "data_ms", "val_loss"} <= set(header)
    assert len(rows) == 5  # 3 train rows, val rows at steps 1 and 2
    recs = tsample.main([
        "--smoke", "--device", "cpu", "--dtype", "float32", "--num_steps", "2",
        "--num_images", "1", "--resolution", "64", "--scale_im", "0", "--num_ref", "2",
        "--delta_ckpt", str(out / "delta_last.npz"), "--cameras", str(out / "cameras.npz"),
        "--output_dir", str(tmp_path / "samples"),
        "--override", f"conditioner.clip_l.vocab_size={vocab}",
        "--override", f"conditioner.open_clip.vocab_size={vocab}"])
    assert os.path.exists(recs[0]["paths"][0]) and recs[0]["images"].std() > 0


def test_train_cli_smoke_writes_its_files(tmp_path):
    out = tmp_path / "run"
    res = tcli.main(["--smoke", "--device", "cpu", "--output_dir", str(out)])
    assert len(res["steps"]) == 2 and res["capture_s"] is None
    for name in ("delta_last.npz", "metrics.csv", "config.json"):
        assert (out / name).exists(), name
    assert (out / "checkpoints" / "step_00000002" / tckpt.STATE_FILE).exists()
    with np.load(out / "delta_last.npz") as z:
        assert "embed.0" in z.files and not [k for k in z.files if k.endswith(".references")]


def test_train_cli_profiles_steps_and_rewrites_nothing_on_resume(tmp_path):
    out = tmp_path / "run"
    tcli.main(["--smoke", "--device", "cpu", "--output_dir", str(out), "--smoke_steps", "11",
               "--profile_steps", "1", "--log_every", "5"])
    assert (out / "profile" / "trace.json").stat().st_size > 0
    with open(out / "metrics.csv") as f:
        assert [r.split(",")[0] for r in f.read().strip().splitlines()[1:]] == ["0", "5", "10"]
    res = tcli.main(["--smoke", "--device", "cpu", "--output_dir", str(out), "--smoke_steps", "11",
                     "--resume"])
    assert res["steps"] == []  # the checkpoint is at step 11 already


@pytest.mark.parametrize("flags", [["--num_processes", "2"], ["--process_id", "0"],
                                   ["--multihost"], ["--coordinator", "localhost:1234"]],
                         ids=["num_processes", "process_id", "multihost", "coordinator"])
def test_train_cli_refuses_unported_flags(flags, tmp_path, monkeypatch):
    """The multi-host flags are ported (tests/test_torch_parallel_train.py
    runs them on two ranks); what is refused is a rendezvous flag without
    --multihost, and --multihost with no rendezvous (no --coordinator and
    no torchrun environment), rather than training alone."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="--multihost"):
        tcli.main(["--smoke", "--device", "cpu", "--output_dir", str(tmp_path), *flags])
    assert not os.path.exists(tmp_path / "metrics.csv")


@pytest.mark.parametrize("every,increase", [(0, True), (1, False), (4, False), (4, True),
                                            (6, True), (10, True)])
def test_preview_schedule_matches_jax(every, increase):
    """The JAX CLI's inline schedule (custom_diffusion360_tpu/cli/train.py)."""
    def jax_log_now(step):
        return bool(every and step and (step % every == 0 or (
            increase and step <= every and (step & (step - 1)) == 0)))

    for step in range(40):
        assert tcli.log_images_now(step, every, increase) == jax_log_now(step), step
    if every == 10 and increase:
        assert [s for s in range(25) if tcli.log_images_now(s, every, increase)] == [
            1, 2, 4, 8, 10, 20]


def test_render_text_image_matches_jax():
    from custom_diffusion360_tpu.train import logging as jlog

    texts = ["photo of a <new1> car", "", "a very long prompt " * 8, "ß ü € 123"]
    want = jlog.render_text_image(texts)
    got = tlog.render_text_image(texts)
    assert got.shape == (4, 256, 256, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got[0].min() < 0.0 and got[1].min() == 1.0  # text drawn; the empty prompt blank
    np.testing.assert_array_equal(tlog.render_text_image(["x"], size=64),
                                  jlog.render_text_image(["x"], size=64))


def test_train_cli_writes_preview_grids_on_co3d(tmp_path):
    """--sample_every 1 --log_steps_increase on the synthetic CO3D tree:
    every step after step 0 writes its grids, the prompts included."""
    root = make_synthetic_co3d(tmp_path / "co3d")
    _tiny_yaml(tmp_path / "tiny.yaml")
    out = tmp_path / "run"
    res = tcli.main(["--data_root", root, "--category", "car", "--config",
                     str(tmp_path / "tiny.yaml"), "--output_dir", str(out), "--img_size", "64",
                     "--num_images", "3", "--max_steps", "3", "--device", "cpu",
                     "--sample_every", "1", "--log_steps_increase", "--ckpt_every", "0"])
    names = ["inputs", "reconstructions", "samples", "predicted_rgb_0", "fg_mask_0",
             "conditioning"]
    assert [g["step"] for g in res["grids"]] == [1, 2]
    want = sorted(f"{n}_{s:06d}.png" for n in names for s in (1, 2))
    assert sorted(os.listdir(out / "images")) == want
    from PIL import Image

    for g in res["grids"]:
        assert g["seconds"] > 0 and len(g["paths"]) == len(names)
        for path in g["paths"]:
            img = np.asarray(Image.open(path))
            assert img.ndim == 3 and img.shape[2] == 3
            name = os.path.basename(path).rsplit("_", 1)[0]
            side = {"conditioning": 256, "predicted_rgb_0": 4, "fg_mask_0": 4}.get(name, 64)
            assert img.shape[:2] == (side, side), path  # batch 1: one tile
    samples = np.asarray(Image.open(out / "images" / "samples_000002.png"))
    assert samples.std() > 0


def test_train_cli_flags_match_jax():
    from custom_diffusion360_tpu.cli import train as jcli

    def flags(parser):
        return {a.dest: a.default for a in parser._actions if a.dest != "help"}

    want, got = flags(jcli.build_parser()), flags(tcli.build_parser())
    assert set(got) - set(want) == {"device"} and got["device"] == "cuda"
    assert {k: got[k] for k in want} == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tcli.main(["--smoke"])


def test_sample_cli_config_and_override_reach_the_engine(tmp_path, monkeypatch):
    seen = []
    orig = Engine.__init__

    def spy(self, cfg=EngineConfig(), device="cuda"):
        seen.append(cfg)
        orig(self, cfg, device)

    monkeypatch.setattr(Engine, "__init__", spy)
    cfg_file = tmp_path / "c.yaml"
    cfg_file.write_text("num_sample_steps: 7\nunet:\n  num_samples: 3\n")
    tsample.main(["--smoke", "--device", "cpu", "--dtype", "float32", "--num_steps", "1",
                  "--num_images", "1", "--resolution", "64", "--scale_im", "0",
                  "--output_dir", str(tmp_path / "s"), "--config", str(cfg_file),
                  "--override", "unet.num_samples=6"])
    assert seen[-1].unet.num_samples == 6  # the dotlist after the file
    assert seen[-1].num_sample_steps == 7
    assert seen[-1].unet.model_channels == tsample.SMOKE_CFG.unet.model_channels
