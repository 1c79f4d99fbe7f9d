"""The sampling CLI's path in the port vs the JAX package, f32 on the CPU:
the x3 image+text guider, a TINY 3-step x3 sample + decode whose
conditioning comes from token ids through the conditioner and whose
reference features come from a delta checkpoint (shared target cameras, so
both dedupes run on both sides) against a live JAX ``Engine.sample`` with
the same injected noise (1e-5 relative to the output scale, the slice-1
tolerance), the dedupes against full-row compute in the port, and
``cli.sample.main`` itself."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import custom_diffusion360_torch.cli.sample as cli
from custom_diffusion360_tpu.diffusion import scheduled_cfg_img_text_ref as JGuider3
from custom_diffusion360_tpu.engine import Engine as JEngine, EngineConfig as JEngineConfig
from custom_diffusion360_tpu.geometry.cameras import Cameras as JCams
from custom_diffusion360_tpu.io import delta as jdelta
from custom_diffusion360_tpu.models.clip import ClipTextConfig as JClipCfg
from custom_diffusion360_tpu.models.conditioner import ConditionerConfig as JCondCfg
from custom_diffusion360_tpu.models.conditioner import (
    get_unconditional_conditioning as j_get_uc,
)
from custom_diffusion360_tpu.models.unet import UNetConfig as JUNetConfig, attn_block_meta
from custom_diffusion360_tpu.models.vae import VAEConfig as JVAEConfig
from custom_diffusion360_torch.data.tokenizer import make_test_tokenizer
from custom_diffusion360_torch.diffusion.guiders import scheduled_cfg_img_text_ref
from custom_diffusion360_torch.engine import Engine, EngineConfig
from custom_diffusion360_torch.geometry.cameras import Cameras
from custom_diffusion360_torch.io.delta import (
    apply_delta_state_dict,
    iter_pose_blocks,
    load_delta_npz,
    save_delta_npz,
)
from custom_diffusion360_torch.models.clip import ClipTextConfig
from custom_diffusion360_torch.models.conditioner import (
    ConditionerConfig,
    get_unconditional_conditioning,
)
from custom_diffusion360_torch.models.unet import UNetConfig
from custom_diffusion360_torch.models.unet import attn_block_meta as t_attn_block_meta
from custom_diffusion360_torch.models.vae import VAEConfig
from tests.test_cameras import random_cameras
from tests.test_torch_common import TINY_UNET, TINY_VAE, max_err, random_params, t, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

B, NREF, LAT, STEPS, CTX = 1, 2, 8, 3, 16
TOK = make_test_tokenizer(["photo", "of", "a", "car"], additional_special_tokens=("<new1>",),
                          context_length=CTX)
CLIP_L = dict(vocab_size=TOK.base_vocab_size, width=32, layers=1, heads=2, context_length=CTX)
OPEN = dict(CLIP_L, layers=2, act="gelu", text_projection=True)
UNET = dict(TINY_UNET, adm_in_channels=32 + 6 * 4)  # pooled 32 + 3 size pairs x 4


def _rel(got, want, tol=1e-5):
    return max_err(got, want) < tol * max(1.0, float(np.abs(np.asarray(want)).max()))


def test_guider_x3_matches_jax():
    rng = np.random.default_rng(0)
    b = 2
    x = rng.normal(size=(b, 4, 4, 4)).astype(np.float32)
    s = rng.uniform(1, 10, size=(b,)).astype(np.float32)
    c = {"crossattn": rng.normal(size=(3 * b, 5, 8)).astype(np.float32),
         "vector": rng.normal(size=(3 * b, 6)).astype(np.float32)}
    uc = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in c.items()}
    jg, tg = JGuider3(scale=5.0, scale_im=2.0), scheduled_cfg_img_text_ref(scale=5.0, scale_im=2.0)
    jx, js, jc = jg.prepare(jnp.asarray(x), jnp.asarray(s), jax.tree.map(jnp.asarray, c),
                            jax.tree.map(jnp.asarray, uc))
    tx, ts, tc = tg.prepare(t(x), t(s), {k: t(v) for k, v in c.items()},
                            {k: t(v) for k, v in uc.items()})
    assert max_err(tx, jx) == 0 and max_err(ts, js) == 0
    for k in c:
        assert tc[k].shape == jc[k].shape and max_err(tc[k], jc[k]) == 0
    d = rng.normal(size=(3 * b, 4, 4, 4)).astype(np.float32)
    assert _rel(tg.combine(t(d), t(s)), jg.combine(jnp.asarray(d), jnp.asarray(s)), 1e-6)
    assert tg.num_copies == jg.num_copies == 3
    assert tg.prefix_copy_groups == jg.prefix_copy_groups == (0, 0, 1)


@pytest.fixture(scope="module")
def inputs():
    jcfg = JEngineConfig(
        unet=JUNetConfig(**UNET), vae=JVAEConfig(**TINY_VAE),
        conditioner=JCondCfg(clip_l=JClipCfg(**CLIP_L), open_clip=JClipCfg(**OPEN),
                             size_outdim=4))
    params = random_params(lambda k: JEngine(jcfg).init_params(k), seed=21)
    rng = np.random.default_rng(22)
    meta = attn_block_meta(jcfg.unet)
    refs = {}
    for _, _, attn_id, d in jdelta.iter_pose_blocks(jcfg.unet):
        ds, ch, _ = meta[attn_id]
        refs.setdefault(attn_id, {})[d] = rng.normal(
            size=(NREF + 2, (LAT // ds) ** 2, ch)).astype(np.float32) * 0.5
    # a delta carrying the references, pose weights of its own and V* rows
    pose = random_params(lambda k: JEngine(jcfg).init_params(k), seed=23)
    delta = jdelta.extract_delta(jax.tree.map(jnp.asarray, pose), refs, jcfg.unet)
    block = random_cameras(1 + NREF, seed=24)
    cams = [np.concatenate([np.asarray(f)[None]] * 3) for f in block]  # tiled over 3 copies
    noise = rng.normal(size=(B, LAT, LAT, 4)).astype(np.float32)
    return jcfg, params, delta, cams, noise


def _cond_batch(prompt):
    toks = TOK([prompt] * B)
    return {"tokens_clip": toks, "tokens_open": toks,
            "original_size": np.full((B, 2), 64.0, np.float32),
            "crop_coords": np.zeros((B, 2), np.float32),
            "target_size": np.full((B, 2), 64.0, np.float32)}


def _port_sample(inputs, tmp_path):
    _, params, delta, cams, noise = inputs
    cfg = EngineConfig(unet=UNetConfig(**UNET), vae=VAEConfig(**TINY_VAE),
                       conditioner=ConditionerConfig(clip_l=ClipTextConfig(**CLIP_L),
                                                     open_clip=ClipTextConfig(**OPEN),
                                                     size_outdim=4))
    path = str(tmp_path / "delta.npz")
    save_delta_npz(path, delta)
    tp, refs = apply_delta_state_dict(to_torch(params), load_delta_npz(path), cfg.unet)
    c, uc = get_unconditional_conditioning(
        tp["conditioner"], {k: t(v) for k, v in _cond_batch("photo of a <new1> car").items()},
        {k: t(v) for k, v in _cond_batch("").items()}, cfg.conditioner, force_uc_zero_txt=True)
    eng = Engine(cfg, device="cpu")
    z = eng.sample(tp, c, uc, scheduled_cfg_img_text_ref(scale=7.5, scale_im=3.5),
                   noise=t(noise), cams=Cameras(*(t(f) for f in cams)), references=refs,
                   choices=[2, 0], num_steps=STEPS, shared_target_cams=True)
    return z, eng.decode_first_stage(tp, z), c, uc


def test_x3_sample_through_conditioner_and_delta_matches_jax(inputs, tmp_path):
    jcfg, params, delta, cams, noise = inputs
    je = JEngine(jcfg)
    jp, jrefs = jdelta.apply_delta_state_dict(jax.tree.map(jnp.asarray, params), delta, jcfg.unet)
    jc, juc = j_get_uc(jp["conditioner"],
                       jax.tree.map(jnp.asarray, _cond_batch("photo of a <new1> car")),
                       jax.tree.map(jnp.asarray, _cond_batch("")), jcfg.conditioner,
                       force_uc_zero_txt=True, ref=False)
    z_j = je.sample(jp, jc, juc, JGuider3(scale=7.5, scale_im=3.5), jax.random.PRNGKey(0),
                    shape=noise.shape, cams=JCams(*(jnp.asarray(f) for f in cams)),
                    references=jrefs, choices=np.array([2, 0]), num_steps=STEPS,
                    noise=jnp.asarray(noise), shared_target_cams=True)
    img_j = np.asarray(je.decode_first_stage(jp, z_j))
    z_t, img_t, c, uc = _port_sample(inputs, tmp_path)
    for k in ("crossattn", "vector"):
        assert _rel(c[k], jc[k]) and _rel(uc[k], juc[k])
    assert not uc["crossattn"].any()  # the negative prompt's text is zeroed
    assert float(np.abs(np.asarray(z_j) - noise * np.sqrt(1 + 14.6**2)).max()) > 1.0  # it moved
    assert _rel(z_t, z_j) and _rel(img_t, img_j)


def test_dedupes_do_not_change_the_port_sample(inputs, tmp_path, monkeypatch):
    """CD360_CFG3_DEDUPE=0 / CD360_PREFIX_DEDUPE=0 give full-row compute;
    the same sums on fewer rows: 1e-5 relative."""
    import custom_diffusion360_torch.models.transformer as ttr

    calls = []
    orig = ttr.nerfsd_apply
    monkeypatch.setattr(ttr, "nerfsd_apply",
                        lambda p, cams, *a, **kw: calls.append(cams.R.shape[0]) or orig(
                            p, cams, *a, **kw))
    z_on, img_on, _, _ = _port_sample(inputs, tmp_path)
    assert calls and set(calls) == {2 * B}  # the render ran on the 2 unique copies
    calls.clear()
    monkeypatch.setenv("CD360_CFG3_DEDUPE", "0")
    monkeypatch.setenv("CD360_PREFIX_DEDUPE", "0")
    z_off, img_off, _, _ = _port_sample(inputs, tmp_path)
    assert set(calls) == {3 * B}
    assert _rel(z_on, z_off) and _rel(img_on, img_off)


def _smoke_delta(path, n_train=20):
    meta = t_attn_block_meta(cli.SMOKE_CFG.unet)
    rng = np.random.default_rng(3)
    delta = {}
    for prefix, _, attn_id, _ in iter_pose_blocks(cli.SMOKE_CFG.unet):
        ds, ch, _ = meta[attn_id]
        delta[prefix + ".references"] = rng.normal(
            size=(n_train + 1, (8 // ds) ** 2, ch)).astype(np.float32)
    delta["embed"] = [rng.normal(size=(1, 48)).astype(np.float32)] * 2
    save_delta_npz(path, delta)


def test_cli_main_writes_pngs_for_the_jax_clis_poses(tmp_path, monkeypatch):
    delta = str(tmp_path / "delta.npz")
    _smoke_delta(delta)
    seen = []
    orig = Engine.sample

    def spy(self, *a, **kw):
        seen.append((kw["cams"], kw["shared_target_cams"], a[3].num_copies))
        return orig(self, *a, **kw)

    monkeypatch.setattr(Engine, "sample", spy)
    common = ["--smoke", "--device", "cpu", "--dtype", "float32", "--num_steps", "2",
              "--num_images", "3", "--resolution", "64", "--num_ref", "4",
              "--delta_ckpt", delta, "--seed", "5"]
    out1 = str(tmp_path / "b1")
    rec1 = cli.main(common + ["--output_dir", out1])
    pngs = sorted(f for f in os.listdir(out1) if f.endswith(".png"))
    assert pngs == [f"sample_{i:02d}_00.png" for i in range(3)]
    for r in rec1:
        for path, img in zip(r["paths"], r["images"]):
            np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), img)
            assert img.shape == (64, 64, 3) and img.std() > 0
    # the JAX CLI's choices: evenly spaced references, seeded target poses
    pose_ids = np.random.default_rng(5).choice(7, 3, replace=False)
    val, train = cli.ring_cameras(7), cli.ring_cameras(20)
    ref_ids = [int(x) for x in np.linspace(0, 20 - 20 / 4, 4)]
    for (cams, shared, copies), pid in zip(seen, pose_ids):
        assert shared and copies == 3 and cams.R.shape == (3, 5, 3, 3)
        assert torch.equal(cams.R[0, 0], val.R[pid]) and torch.equal(cams.R[2, 0], val.R[pid])
        assert torch.equal(cams.R[0, 1:], train.R[ref_ids])
    # --batch 2 (ragged tail padded, not saved) gives the same images: the
    # noise is drawn per job; batched f32 sums may differ in the last bits,
    # which can flip one uint8 rounding
    out2 = str(tmp_path / "b2")
    rec2 = cli.main(common + ["--output_dir", out2, "--batch", "2"])
    assert sorted(os.listdir(out2)) == pngs
    diff = np.abs(np.concatenate([r["images"] for r in rec2]).astype(int)
                  - np.concatenate([r["images"] for r in rec1]))
    assert diff.max() <= 1 and diff.mean() < 1e-3


def test_cli_translate_sweep(tmp_path):
    delta = str(tmp_path / "delta.npz")
    _smoke_delta(delta)
    out = str(tmp_path / "sweep")
    rec = cli.main(["--smoke", "--device", "cpu", "--dtype", "float32", "--num_steps", "1",
                    "--num_images", "1", "--resolution", "64", "--num_ref", "2",
                    "--delta_ckpt", delta, "--translate", "x", "--batch", "3",
                    "--output_dir", out])
    n = len(np.arange(-0.3, 0.3, 0.1))
    assert sorted(os.listdir(out)) == [f"sample_00_{j:02d}.png" for j in range(n)]
    assert sum(len(r["paths"]) for r in rec) == n


def test_cli_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--smoke", "--num_images", "1"])


def test_cli_flags_match_jax(tmp_path, monkeypatch):
    from custom_diffusion360_tpu.cli import sample as jcli

    def flags(parser):
        return {a.dest: (a.default, a.choices) for a in parser._actions if a.dest != "help"}

    want, got = flags(jcli.build_parser()), flags(cli.build_parser())
    assert set(got) - set(want) == {"device", "config"}
    assert {k: got[k] for k in want} == want
    # --latency_shard without a process group (no torchrun environment)
    # samples as without it, as the JAX CLI does on one device
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = ["--smoke", "--device", "cpu", "--dtype", "float32", "--num_steps", "2",
            "--num_images", "1", "--resolution", "64"]
    (plain,) = cli.main(argv + ["--output_dir", str(tmp_path / "a")])
    (shard,) = cli.main(argv + ["--output_dir", str(tmp_path / "b"), "--latency_shard"])
    np.testing.assert_array_equal(shard["images"], plain["images"])
    assert len(shard["paths"]) == 1


DETERMINISTIC = ("euler_edm", "heun_edm", "dpmpp2m", "lms")


@pytest.mark.parametrize("sampler", ["euler_edm", "heun_edm", "euler_ancestral",
                                     "dpmpp2s_ancestral", "dpmpp2m", "lms"])
def test_cli_sampler_writes_pngs(sampler, tmp_path):
    """Each --sampler writes its images; a deterministic sampler's images do
    not depend on --batch (per-job noise), an ancestral sampler's repeat
    for a fixed --batch (per-chunk step noise from --seed)."""
    delta = str(tmp_path / "delta.npz")
    _smoke_delta(delta)
    common = ["--smoke", "--device", "cpu", "--dtype", "float32", "--num_steps", "3",
              "--num_images", "2", "--resolution", "64", "--num_ref", "2", "--delta_ckpt", delta,
              "--sampler", sampler, "--seed", "4"]
    rec1 = cli.main(common + ["--output_dir", str(tmp_path / "b1")])
    assert sorted(os.listdir(tmp_path / "b1")) == ["sample_00_00.png", "sample_01_00.png"]
    img1 = np.concatenate([r["images"] for r in rec1])
    assert img1.shape == (2, 64, 64, 3) and img1.std() > 0
    if sampler in DETERMINISTIC:
        rec2 = cli.main(common + ["--output_dir", str(tmp_path / "b2"), "--batch", "2"])
        diff = np.abs(np.concatenate([r["images"] for r in rec2]).astype(int) - img1)
        assert diff.max() <= 1 and diff.mean() < 1e-3
    else:
        again = cli.main(common + ["--output_dir", str(tmp_path / "again")])
        np.testing.assert_array_equal(np.concatenate([r["images"] for r in again]), img1)
        other = cli.main(common[:-1] + ["5", "--output_dir", str(tmp_path / "seed5")])
        assert not np.array_equal(np.concatenate([r["images"] for r in other]), img1)


def test_cli_overrides_reach_the_sampler(tmp_path, monkeypatch):
    """--override discretization_name=edm and sampler.* configure the
    engine's sampler; the churned Euler run draws per-step noise."""
    seen = []
    orig = Engine.sample

    def spy(self, *a, **kw):
        seen.append((self.cfg.discretization_name, self.cfg.sampler.s_churn, kw["sampler"]))
        return orig(self, *a, **kw)

    monkeypatch.setattr(Engine, "sample", spy)
    delta = str(tmp_path / "delta.npz")
    _smoke_delta(delta)
    common = ["--smoke", "--device", "cpu", "--dtype", "float32", "--num_steps", "3",
              "--num_images", "1", "--resolution", "64", "--num_ref", "2", "--delta_ckpt", delta]
    plain = cli.main(common + ["--output_dir", str(tmp_path / "a")])
    churned = cli.main(common + ["--output_dir", str(tmp_path / "b"), "--override",
                                 "discretization_name=edm", "--override", "sampler.s_churn=1.5",
                                 "--override", "sampler.s_tmax=100"])
    assert seen == [("legacy_ddpm", 0.0, "euler_edm"), ("edm", 1.5, "euler_edm")]
    assert churned[0]["images"].std() > 0
    assert not np.array_equal(churned[0]["images"], plain[0]["images"])
