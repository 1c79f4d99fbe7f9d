"""The training step replayed as piecewise CUDA graphs
(``train/train_graphs.py`` on ``utils/graphs.py``) against the same step run eagerly, on a CUDA
card.

Marked ``cuda``: skipped without a card. The file imports neither JAX nor
the JAX package, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_train_graphs.py

A small bf16 SDXL-shaped model at image 256² (latent 32): a UNet whose
spatial transformers at ½ resolution (256 tokens, head dim 64, so their
self-attentions reach the hand-written kernel) hold a pose block at each of
their depths, the second one importance-sampling from the first; the NeRF
in f32 at ray chunks of 128, so its two chunks a block are checkpointed
and recomputed in the backward; the VAE encoder; text towers of width 32
with a V* row each; 1 + 2 views; AdamW under an lr schedule that changes
every step, with the gradients clipped. One set-up runs the same steps on two trainers from the same
weights, items and draws: one as the program runs it (step 0 eager, step 1
captured, then replays) and its twin with every step eager
(``train_graphs.engages`` patched to False after ``init_state``). Each
property is a case of ``test_the_replayed_training_step``.

A replay launches the kernels of the eager step on the same inputs, so the
two agree bit for bit.
"""
import numpy as np
import pytest
import torch

from custom_diffusion360_torch.draws import Draws
from custom_diffusion360_torch.engine import Engine, EngineConfig
from custom_diffusion360_torch.geometry.cameras import Cameras
from custom_diffusion360_torch.models.clip import ClipTextConfig
from custom_diffusion360_torch.models.conditioner import ConditionerConfig
from custom_diffusion360_torch.models.unet import UNetConfig
from custom_diffusion360_torch.models.vae import VAEConfig
from custom_diffusion360_torch.train import train_graphs
from custom_diffusion360_torch.train.trainer import TrainConfig, Trainer, tree_map
from custom_diffusion360_torch.utils.graphs import COUNTED

pytestmark = pytest.mark.cuda

RES, NREF, VOCAB = 256, 2, 64
CLIP = dict(vocab_size=VOCAB, width=32, layers=1, heads=2, context_length=16)
CFG = EngineConfig(
    unet=UNetConfig(model_channels=64, channel_mult=(1, 2), transformer_depth=(1, 2),
                    attention_resolutions=(2,), context_dim=64, adm_in_channels=32 + 6 * 8,
                    num_head_channels=64, image_cross_blocks=(0, 1), poscontrol_interval=1,
                    num_samples=8, num_freqs=4, nerf_chunk_size=128),
    vae=VAEConfig(ch=16, ch_mult=(1, 2, 4, 4), num_res_blocks=1),
    conditioner=ConditionerConfig(clip_l=ClipTextConfig(**CLIP),
                                  open_clip=ClipTextConfig(**dict(CLIP, layers=2, act="gelu",
                                                                  text_projection=True)),
                                  size_outdim=8),
    compute_dtype="bfloat16",
)
SCHEDULE = (1.0, 0.5, 2.0, 0.25, 1.5, 0.75)
STEPS = 4  # compared with the eager twin: eager, capture, replay, replay
PROMPTS = (4, 7, 10, 13, 15, 6)  # ids a prompt, one item a step


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _params(dev):
    params = Engine(CFG, device=dev).init_params(seed=20, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(21)

    def fill(x):  # no zero leaf, so that every layer moves the loss
        if x.is_floating_point() and not x.abs().max() > 0:
            x = (torch.randn(x.shape, generator=gen, device=dev) * 0.02).to(x.dtype)
        return x

    return tree_map(fill, params)


def _item(k, dev):
    """Training item ``k``: its own images, ring cameras and a prompt of
    ``PROMPTS[k]`` ids (BOS, words, V*, EOT, then padding)."""
    rng = np.random.default_rng(100 + k)
    gen = torch.Generator(device=dev).manual_seed(200 + k)

    def image(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.3

    def ids(m):
        out = np.zeros((m, CLIP["context_length"]), np.int64)
        n = PROMPTS[k]
        for row in out:
            row[:n] = np.concatenate([[1], rng.integers(2, VOCAB - 2, n - 3), [VOCAB, VOCAB - 1]])
        return torch.from_numpy(out).to(dev)

    th = np.concatenate([[rng.uniform(0, 2 * np.pi)],
                         np.linspace(0, 2 * np.pi, NREF, endpoint=False)])
    rot = np.zeros((1 + NREF, 3, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 2], rot[:, 1, 1] = np.cos(th), np.sin(th), 1.0
    rot[:, 2, 0], rot[:, 2, 2] = -np.sin(th), np.cos(th)
    trans = np.tile(np.array([0, 0, 2.7], np.float32), (1 + NREF, 1))
    yy, xx = np.mgrid[:RES, :RES]
    disc = ((yy - RES / 2) ** 2 + (xx - RES / 2) ** 2 < (0.35 * RES) ** 2).astype(np.float32)
    lat = RES // 8
    batch = {
        "image": image(1, RES, RES, 3), "image_ref": image(1, NREF, RES, RES, 3),
        "mask": torch.ones((1, lat, lat, 1), device=dev),
        "mask_ref": torch.ones((1, NREF, lat, lat, 1), device=dev),
        "opacity": torch.from_numpy(disc)[None, :, :, None].to(dev),
        "drop_im": torch.ones((1,), device=dev),
        "cams": Cameras.create(rot, trans, 2.0, 0.0, device=dev).reshape(1, 1 + NREF),
        "tokens_clip": ids(1), "tokens_open": ids(1),
        "tokens_clip_ref": ids(NREF), "tokens_open_ref": ids(NREF),
    }
    for suffix, m in (("", 1), ("_ref", NREF)):
        batch["original_size" + suffix] = torch.full((m, 2), float(RES), device=dev)
        batch["crop_coords" + suffix] = torch.zeros((m, 2), device=dev)
        batch["target_size" + suffix] = torch.full((m, 2), float(RES), device=dev)
    return batch


def _draws(k, dev):
    return Draws(torch.Generator(device=dev).manual_seed(300 + k))


def _launches():
    return {fn.__name__: dict(fn.launches_by_shape) for fn in COUNTED}


def _launched(before):
    out = {}
    for fn in COUNTED:
        moved = {k: v - before[fn.__name__].get(k, 0) for k, v in fn.launches_by_shape.items()}
        out[fn.__name__] = {k: v for k, v in moved.items() if v}
    return out


def _counts():
    return {k: train_graphs.steps[k] for k in ("capture", "replay", "eager")}


def _moved(before):
    return {k: v - before[k] for k, v in _counts().items()}


def _trainer(eng, params):
    # a gradient-norm limit below the step's norm, so the captured clipping scales
    trainer = Trainer(eng, TrainConfig(lr=1e-3, lr_schedule=lambda n: SCHEDULE[n],
                                       max_grad_norm=1e-4))
    return trainer, trainer.init_state(params)


def _step(trainer, state, k, dev):
    """Step ``k`` on item ``k``: (state, metrics, copies of the metrics,
    counts moved, launches counted)."""
    batch, draws = _item(k, dev), _draws(k, dev)
    before, launches = _counts(), _launches()
    state, metrics = trainer.train_step(state, batch, draws)
    torch.cuda.synchronize()
    return state, metrics, {k: v.clone() for k, v in metrics.items()}, _moved(before), \
        _launched(launches)


def _snapshot(trainer, state):
    leaves = trainer.trainable(state)
    opt = state.optimizer
    return ([leaf.detach().clone() for leaf in leaves],
            [opt.state[leaf]["exp_avg"].clone() for leaf in leaves],
            [group["lr"].clone() for group in opt.param_groups])


def _profiled_step(trainer, state, k, dev):
    """Step ``k`` under the torch profiler -> (state, [(kernel name, the
    cd360 spans open at its launch on the launching thread, innermost
    last)], {span name: calls}, [spans open at each graph launch])."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    batch, draws = _item(k, dev), _draws(k, dev)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        state, _ = trainer.train_step(state, batch, draws)
        torch.cuda.synchronize()
    spans, calls, kernels = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                kernels.append((name, e.correlation_id()))
        elif name.startswith("cd360."):
            spans.append((e.start_ns(), e.end_ns(), e.start_thread_id(), name))
        elif name.startswith("cu"):
            calls[e.correlation_id()] = (e.start_ns(), e.start_thread_id(), name)

    def open_at(t, tid):
        inside = [s for s in spans if s[2] == tid and s[0] <= t <= s[1]]
        return [s[3] for s in sorted(inside, key=lambda s: (s[0], -s[1]))]

    located = [(name, open_at(*calls[corr][:2])) for name, corr in kernels if corr in calls]
    graph_launches = [open_at(t, tid) for t, tid, name in calls.values()
                      if name.startswith("cudaGraphLaunch")]
    names = {}
    for s in spans:
        names[s[3]] = names.get(s[3], 0) + 1
    return state, located, names, graph_launches


@pytest.fixture(scope="module")
def run(dev):
    """The shared set-up: STEPS steps of the graphed trainer and of its eager
    twin, then graphed steps under the sync check and under the profiler."""
    eng = Engine(CFG, device=dev)
    params = _params(dev)
    out = {"graphed": [], "eager": []}
    trainer, state = _trainer(eng, params)
    for k in range(STEPS):
        state, *rest = _step(trainer, state, k, dev)
        out["graphed"].append(rest)
    out["graphed_final"] = _snapshot(trainer, state)
    out["graphs"] = list(trainer.graphs._graphs.values())

    twin, twin_state = _trainer(eng, params)
    mp = pytest.MonkeyPatch()
    mp.setattr(train_graphs, "engages", lambda *a, **k: False)
    try:
        for k in range(STEPS):
            twin_state, *rest = _step(twin, twin_state, k, dev)
            out["eager"].append(rest)
    finally:
        mp.undo()
    out["eager_final"] = _snapshot(twin, twin_state)
    del twin, twin_state

    # a replay with every host synchronisation an error
    batch, draws = _item(STEPS, dev), _draws(STEPS, dev)
    before = _counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = trainer.train_step(state, batch, draws)
        out["sync_error"] = None
    except RuntimeError as err:
        out["sync_error"] = err
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out["sync_moved"] = _moved(before)

    # last, as it profiles: a replay under the torch profiler
    before = _counts()
    state, *out["profiled"] = _profiled_step(trainer, state, STEPS + 1, dev)
    out["profiled_moved"] = _moved(before)
    return out


CASES = ["equal", "sync", "prompt lengths", "launches", "kept metrics", "spans", "lr schedule"]


@pytest.mark.parametrize("case", CASES)
def test_the_replayed_training_step(run, case):
    graphed, eager = run["graphed"], run["eager"]
    if case == "equal":  # loss terms, every trainable leaf after the steps, AdamW's exp_avg
        assert all(float(m["grad_norm"]) > 1e-4 for _, m, _, _ in graphed)  # clipped
        assert [m for _, _, m, _ in graphed] == [{"capture": 0, "replay": 0, "eager": 1},
                                                {"capture": 1, "replay": 0, "eager": 0},
                                                {"capture": 0, "replay": 1, "eager": 0},
                                                {"capture": 0, "replay": 1, "eager": 0}]
        for k, ((_, got, _, _), (_, want, _, _)) in enumerate(zip(graphed, eager)):
            assert set(got) == set(want)
            for name in want:
                assert torch.equal(got[name], want[name]), (k, name, float(got[name]),
                                                            float(want[name]))
        (leaves, moments, _), (want_leaves, want_moments, _) = \
            run["graphed_final"], run["eager_final"]
        assert len(leaves) == len(want_leaves) > 0
        for i, (a, b) in enumerate(zip(leaves + moments, want_leaves + want_moments)):
            assert torch.equal(a, b), (i, float((a - b).abs().max()))
    elif case == "sync":
        assert run["sync_error"] is None, run["sync_error"]
        assert run["sync_moved"] == {"capture": 0, "replay": 1, "eager": 0}
    elif case == "prompt lengths":  # items of 4-15 ids replay the one capture
        assert len(set(PROMPTS)) == len(PROMPTS)
        assert sum(m["capture"] for _, _, m, _ in graphed) == 1
        assert len(run["graphs"]) == 1
        assert run["sync_moved"]["replay"] == run["profiled_moved"]["replay"] == 1
    elif case == "launches":  # a replay counts what the eager step launches
        for k in range(1, STEPS):  # the capture, the replays
            assert graphed[k][3] == eager[k][3], k
        counted = graphed[3][3]
        assert counted["layer_norm_fused"] and counted["attention_fwd"]
        assert counted["bilinear_sample"] and counted["bilinear_sample_bwd"]
        assert not any(fn in ("bilinear_sample", "bilinear_sample_bwd")
                       for fn in (f.__name__ for f in run["graphs"][0].credit))
    elif case == "kept metrics":  # a returned metric is not graph memory
        for k in range(STEPS):
            metrics, copies, _, _ = graphed[k]
            for name in metrics:
                assert torch.equal(metrics[name], copies[name]), (k, name)
        assert not torch.equal(graphed[2][0]["loss"], graphed[3][0]["loss"])
    elif case == "spans":  # the fold reads a profiled replay as an eager step
        located, names, launches = run["profiled"]
        assert run["profiled_moved"] == {"capture": 0, "replay": 1, "eager": 0}
        bilinear = [(name, open_) for name, open_ in located if "bilinear" in name.lower()]
        assert bilinear
        for name, open_ in bilinear:
            want = "cd360.op.bilinear_bwd" if "bwd" in name.lower() else "cd360.op.bilinear"
            assert open_ and open_[-1] == want, (name, open_)
        nerf = [open_ for open_ in launches if "cd360.nerf" in open_]
        assert nerf and all(o[-1] == "cd360.nerf" for o in nerf), \
            [o for o in nerf if o[-1] != "cd360.nerf"][:4]
        assert any("cd360.nerf" in open_ and "bilinear" not in name.lower()
                   for name, open_ in located)
        instances = {s for _, _, stack in run["graphs"][0].items for s in stack
                     if s[0] == "cd360.nerf"}
        assert names["cd360.nerf"] == len(instances) > 0
        for phase in ("forward", "backward", "update"):
            assert names[f"cd360.train.{phase}"] == 1
            assert any(f"cd360.train.{phase}" in open_ for open_ in launches)
    else:  # the lr a replay's update reads is the schedule's for that step
        (_, _, lrs), (_, _, want) = run["graphed_final"], run["eager_final"]
        assert len(SCHEDULE) > STEPS and len(set(SCHEDULE[1:STEPS])) == STEPS - 1
        for lr, w, group_lr in zip(lrs, want, (1e-3, 1e-3 * 0.05)):
            assert torch.equal(lr, w)
            assert float(lr) == pytest.approx(group_lr * SCHEDULE[STEPS - 1], rel=1e-6)
