"""The port's spans (custom_diffusion360_torch/utils/trace.py): with no
profiler running a span enters no ``record_function``; under
``torch.profiler`` a tiny ``Engine.sample`` (Euler, the render cached), a
tiny ``Trainer.train_step`` and a tiny ``AEEngine.train_step`` give their
phase spans once each, nested and in order. CPU, the sampling CLI's
``SMOKE_CFG`` in f32."""
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from custom_diffusion360_torch.cli.sample import SMOKE_CFG, make_tokenizers
from custom_diffusion360_torch.cli.train import _synthetic_batches
from custom_diffusion360_torch.diffusion.guiders import scheduled_cfg_img_text_ref
from custom_diffusion360_torch.draws import Draws
from custom_diffusion360_torch.engine import Engine
from custom_diffusion360_torch.geometry.cameras import Cameras
from custom_diffusion360_torch.io.delta import iter_pose_blocks
from custom_diffusion360_torch.models.conditioner import get_unconditional_conditioning
from custom_diffusion360_torch.models.unet import attn_block_meta
from custom_diffusion360_torch.models.vae import VAEConfig
from custom_diffusion360_torch.train.ae_engine import AEEngine, AEEngineConfig, init_ae_engine
from custom_diffusion360_torch.train.trainer import TrainConfig, Trainer
from custom_diffusion360_torch.utils import trace
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

STEPS, NREF, RES = 4, 2, 64


def spans(prof):
    """The profile's ``cd360.*`` spans: [(start ns, end ns, name)] by start."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CPU and e.name().startswith("cd360."))


def only(found, name):
    (one,) = [s for s in found if s[2] == name]
    return one


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_span_without_a_profiler_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert trace.span("cd360.x") is trace.span("cd360.y") is trace._OFF
    with trace.span("cd360.x"):
        pass
    assert list(trace.span_range("cd360.x", 3)) == [0, 1, 2]
    assert trace.spanned("cd360.x")(lambda a, b=1: a + b)(2, b=3) == 5


def test_span_under_a_profiler_is_recorded():
    with torch.profiler.profile() as prof:
        with trace.span("cd360.outer"):
            for _ in trace.span_range("cd360.inner", 3):
                torch.ones(4).sum()
    found = spans(prof)
    assert [s[2] for s in found] == ["cd360.outer"] + ["cd360.inner"] * 3
    assert all(inside(s, found[0]) for s in found[1:])
    assert all(a[1] <= b[0] for a, b in zip(found[1:], found[2:]))


def _sample_inputs(cfg):
    gen = torch.Generator().manual_seed(5)
    meta = attn_block_meta(cfg.unet)
    refs = {}
    for _, _, attn_id, d in iter_pose_blocks(cfg.unet):
        ds, ch, _ = meta[attn_id]
        refs.setdefault(attn_id, {})[d] = torch.randn(
            (NREF + 1, (RES // 8 // ds) ** 2, ch), generator=gen) * 0.5
    th = np.linspace(0, 2 * np.pi, 1 + NREF, endpoint=False)
    rot = np.stack([np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
                             np.float32) for a in th])
    trans = np.tile(np.array([0, 0, 2.7], np.float32), (1 + NREF, 1))
    cams = Cameras.create(np.tile(rot, (3, 1, 1)), np.tile(trans, (3, 1)), 2.0, 0.0)
    ids = torch.randint(0, 64, (1, 16), generator=gen)
    batch = {"tokens_clip": ids, "tokens_open": ids, "original_size": torch.full((1, 2), 64.0),
             "crop_coords": torch.zeros((1, 2)), "target_size": torch.full((1, 2), 64.0)}
    noise = torch.randn((1, RES // 8, RES // 8, 4), generator=gen)
    return refs, cams.reshape(3, 1 + NREF), batch, noise


def test_sample_spans_nest_render_then_cached_steps():
    eng = Engine(SMOKE_CFG, device="cpu")
    params = eng.init_params(seed=0)
    refs, cams, batch, noise = _sample_inputs(SMOKE_CFG)
    guider = scheduled_cfg_img_text_ref(scale=7.5, scale_im=3.5)
    with torch.profiler.profile() as prof:
        c, uc = get_unconditional_conditioning(params["conditioner"], batch, batch,
                                               SMOKE_CFG.conditioner, ref=False)
        z = eng.sample(params, c, uc, guider, noise=noise, cams=cams, references=refs,
                       choices=list(range(NREF)), num_steps=STEPS, sampler="euler_edm",
                       shared_target_cams=True)
        eng.decode_first_stage(params, z)
    found = spans(prof)
    cond, sample, decode = (only(found, n) for n in
                            ("cd360.conditioner", "cd360.sample", "cd360.decode"))
    assert cond[1] <= sample[0] and sample[1] <= decode[0]  # one conditioner span, outermost
    prepare, render = only(found, "cd360.sample.prepare"), only(found, "cd360.sample.render")
    steps = [s for s in found if s[2] == "cd360.sample.step"]
    assert len(steps) == STEPS - 1
    assert all(inside(s, sample) for s in [prepare, render] + steps)
    assert prepare[1] <= render[0] and render[1] <= steps[0][0]
    assert all(a[1] <= b[0] for a, b in zip(steps, steps[1:]))
    nerf = [s for s in found if s[2] == "cd360.nerf"]
    assert nerf and all(inside(s, render) for s in nerf)  # the cached steps render nothing
    layers = [s for s in found if s[2].startswith("cd360.unet.")]
    assert {s[2] for s in layers} == {f"cd360.unet.{k}" for k in ("conv_in", "res", "down",
                                                                  "up", "attn")}
    assert all(any(inside(u, s) for s in [render] + steps) for u in layers)
    towers = [s for s in found if s[2] == "cd360.clip"]
    assert len(towers) == 4 and all(inside(s, cond) for s in towers)  # 2 towers, c and uc


def test_train_step_phase_spans_in_order():
    eng = Engine(SMOKE_CFG, device="cpu")
    trainer = Trainer(eng, TrainConfig())
    state = trainer.init_state(eng.init_params(seed=0))
    args = types.SimpleNamespace(batch_size=1, num_images=3, img_size=RES, max_steps=1,
                                 modifier_token="<new1>", category="car")
    tok = make_tokenizers(None, context_length=SMOKE_CFG.conditioner.clip_l.context_length)
    (batch,) = _synthetic_batches(args, SMOKE_CFG, *tok, "cpu")
    with torch.profiler.profile() as prof:
        trainer.train_step(state, batch, Draws(torch.Generator().manual_seed(3)))
    found = spans(prof)
    step = only(found, "cd360.train.step")
    phases = [only(found, f"cd360.train.{p}") for p in ("forward", "backward", "update")]
    assert all(inside(p, step) for p in phases)
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))
    assert inside(only(found, "cd360.conditioner"), phases[0])
    nerf = [s for s in found if s[2] == "cd360.nerf"]
    assert any(inside(s, phases[0]) for s in nerf)  # the forward renders


def test_ae_train_step_phase_spans_in_order():
    cfg = AEEngineConfig(vae=VAEConfig(ch=32, ch_mult=(1,), num_res_blocks=1, z_channels=4),
                         disc_ndf=8, disc_n_layers=2, use_lpips=False)
    eng = AEEngine(cfg, device="cpu")
    state = eng.init_state(init_ae_engine(cfg, seed=0, device="cpu"))
    x = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(4)) * 2 - 1
    with torch.profiler.profile() as prof:
        eng.train_step(state, x, Draws(torch.Generator().manual_seed(6)))
    found = spans(prof)
    step = only(found, "cd360.ae.step")
    phases = [only(found, f"cd360.ae.{p}") for p in ("forward", "backward", "update", "disc")]
    assert all(inside(p, step) for p in phases)
    assert all(a[1] <= b[0] for a, b in zip(phases, phases[1:]))
