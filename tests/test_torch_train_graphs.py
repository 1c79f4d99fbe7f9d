"""The training step's CUDA-graph path (``train/train_graphs.py`` on
``utils/graphs.py``) on the CPU: when it engages, that the CPU runs the step
as before and counts nothing, the draws' fixed order (the NeRF's coin
selects on the device), the noted draws taken again and served in order, the
spans a replay reopens, and a span's edges in a capture. The graphs themselves are held to the
eager step on the card (``tests/test_torch_cuda_train_graphs.py``)."""
import types

import pytest
import torch
from torch.autograd import DeviceType

from custom_diffusion360_torch.cli.sample import SMOKE_CFG, make_tokenizers
from custom_diffusion360_torch.cli.train import _synthetic_batches
from custom_diffusion360_torch.draws import Draws
from custom_diffusion360_torch.engine import Engine
from custom_diffusion360_torch.geometry.cameras import Cameras
from custom_diffusion360_torch.models import nerf
from custom_diffusion360_torch.ops import image_resize
from custom_diffusion360_torch.train import train_graphs
from custom_diffusion360_torch.train.trainer import TrainConfig, Trainer, TrainState
from custom_diffusion360_torch.utils import graphs, trace
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("torch_threads")

CUDA = torch.device("cuda")  # a device object only: nothing here runs on a card


class _Recording(Draws):
    """Draws that note each full name they hand out, in order."""

    def __init__(self, gen, names, prefix=""):
        super().__init__(gen, prefix=prefix)
        self.names = names

    def child(self, name):
        return _Recording(self.gen, self.names, f"{self.prefix}{name}/")

    def take(self, name, shape, device, make):
        self.names.append(self.prefix + name)
        return super().take(name, shape, device, make)


def _counts():
    return dict(train_graphs.steps)


@pytest.mark.parametrize("case", ["card", "cpu", "data group", "accumulation",
                                  "profiler at capture"])
def test_the_graphs_engage_only_on_one_card_without_accumulation(case, monkeypatch):
    if case == "card":
        assert train_graphs.engages(CUDA) and train_graphs.engages("cuda:0", None, 1)
    elif case == "cpu":
        assert not train_graphs.engages("cpu")
    elif case == "data group":
        assert not train_graphs.engages(CUDA, data_group=object())
    elif case == "accumulation":
        assert not train_graphs.engages(CUDA, accumulate=2)
    else:  # the step that would capture runs eagerly while a profiler traces
        ran = []
        trainer = types.SimpleNamespace(
            engine=types.SimpleNamespace(device=CUDA), data_group=None,
            cfg=TrainConfig(), _step=lambda state, batch, draws: ran.append(draws) or (state, {}))
        state = TrainState({}, None, 0, {"mini_step": 0, "applied": 0, "grads": None})
        graphs, before = train_graphs.TrainGraphs(), _counts()
        graphs.step(trainer, state, {"x": torch.zeros(2)}, Draws())  # the first: eager
        monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
        graphs.step(trainer, state._replace(step=1), {"x": torch.ones(2)}, Draws())
        moved = {k: v - before.get(k, 0) for k, v in _counts().items()}
        assert moved.get("eager") == 2 and not moved.get("capture") and len(ran) == 2
        assert graphs._graphs == {} and list(graphs._orders.values()) == [[]]


def _smoke():
    eng = Engine(SMOKE_CFG, device="cpu")
    args = types.SimpleNamespace(batch_size=1, num_images=3, img_size=64, max_steps=2,
                                 modifier_token="<new1>", category="car")
    tok = make_tokenizers(None, context_length=SMOKE_CFG.conditioner.clip_l.context_length)
    return eng, _synthetic_batches(args, SMOKE_CFG, *tok, "cpu")


def test_the_cpu_runs_the_step_as_before_and_counts_nothing(monkeypatch):
    eng, batches = _smoke()
    params = eng.init_params(seed=0)
    got, want = Trainer(eng, TrainConfig()), Trainer(eng, TrainConfig())
    s_got, s_want = got.init_state(params), want.init_state(params)
    assert not s_got.optimizer.param_groups[0]["capturable"]
    assert isinstance(s_got.optimizer.param_groups[0]["lr"], float)

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU reached the graphs")

    before = _counts()
    with monkeypatch.context() as m:
        m.setattr(train_graphs.TrainGraphs, "step", refuse)
        for k, batch in enumerate(batches):
            s_got, m_got = got.train_step(s_got, batch, Draws(torch.Generator().manual_seed(k)))
            s_want, m_want = want._step(s_want, batch, Draws(torch.Generator().manual_seed(k)))
            assert {n: float(v) for n, v in m_got.items()} == \
                {n: float(v) for n, v in m_want.items()}
    assert _counts() == before
    assert got.graphs._graphs == {} and got.graphs._orders == {}
    for a, b in zip(got.trainable(s_got), want.trainable(s_want)):
        assert torch.equal(a, b)
    assert s_got.step == 2 and s_got.accum["applied"] == 2


def _raymarch(coin):
    cfg = nerf.NerfConfig(dim=8, num_samples=4, num_freqs=2, imp_sampling_percent=0.5)
    gen = torch.Generator().manual_seed(0)
    rot = torch.eye(3).expand(1, 3, 3, 3)
    cams = Cameras.create(rot, torch.tensor([[[0.0, 0.0, 2.7]] * 3]), 2.0, 0.0)
    prev = torch.rand((1, 16, 4, 1), generator=gen)
    names = []
    draws = _Recording(torch.Generator().manual_seed(1), names)
    draws.given = {"coin": torch.tensor(coin)}
    out = nerf.raymarch(cams, 4, cfg, prev_weights=prev, draws=draws)
    return names, out


def test_raymarch_takes_its_draws_in_one_order_whatever_the_coin():
    """With a previous block's weights both length sets are drawn and the
    coin selects between them on the device."""
    (take_strat, strat), (take_imp, imp) = _raymarch(0.1), _raymarch(0.9)
    assert take_strat == take_imp == ["ray_x", "ray_y", "coin", "strat", "imp"]
    assert not torch.equal(strat["dists"], imp["dists"])
    assert torch.equal(strat["rays"], imp["rays"])  # the same jitter, the coin apart


def test_noted_draws_are_taken_again_and_served_in_order():
    def step(draws):  # a step's draws: the top level and a nested block
        a = draws.normal("noise", (2, 3), "cpu")
        block = draws.child("nerf").child("3")
        b = block.child("0").uniform("strat", (4,), "cpu")
        c = block.child("1").uniform("coin", (), "cpu")
        return [a, b, c]

    order = []
    first = step(train_graphs._Noting(Draws(torch.Generator().manual_seed(5)), order))
    assert [(n, s) for n, s, _, _ in order] == [("noise", (2, 3)), ("nerf/3/0/strat", (4,)),
                                                 ("nerf/3/1/coin", ())]
    names = []
    again = train_graphs._take_all(_Recording(torch.Generator().manual_seed(5), names), order)
    assert names == ["noise", "nerf/3/0/strat", "nerf/3/1/coin"]
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    buffers = [t.clone() for t in again]
    served = step(train_graphs._Served(buffers, order))
    assert all(a is b for a, b in zip(served, buffers))
    with pytest.raises(RuntimeError, match="where the eager step drew"):
        train_graphs._Served(buffers, order).normal("other", (2, 3), "cpu")


def test_a_replay_reopens_the_spans_of_its_segments():
    """``graphs._Spans`` keeps a span open over consecutive items of one instance
    and closes and reopens it between two instances of one name."""
    fwd, nerf_a, nerf_b = ("cd360.train.forward", 1), ("cd360.nerf", 2), ("cd360.nerf", 3)
    stacks = [(fwd,), (fwd, nerf_a), (fwd, nerf_a), (fwd, nerf_b), (fwd,), (),
              (("cd360.train.backward", 4),)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        spans = graphs._Spans()
        for stack in stacks:
            spans.enter(stack)
            torch.zeros(1).add_(1)
        spans.close()
    found = sorted((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CPU and e.name().startswith("cd360."))
    assert [n for _, _, n in found] == ["cd360.train.forward", "cd360.nerf", "cd360.nerf",
                                        "cd360.train.backward"]
    (f0, f1, _), (a0, a1, _), (b0, b1, _), (k0, _, _) = found
    assert f0 <= a0 and a1 <= b0 and b1 <= f1 <= k0
    assert spans.open == []


def test_a_span_goes_to_the_recorder_only_without_a_profiler(monkeypatch):
    """A span is the capture's edge only when the capture splits at it, and
    never under a profiler."""
    seen = []

    class Capture:
        spans = train_graphs.SPLIT_SPANS

        def edge(self, name):
            seen.append(name)
            return trace._OFF

    monkeypatch.setattr(graphs, "capture", Capture())
    with trace.span("cd360.nerf"):
        pass
    assert seen == ["cd360.nerf"]
    assert trace.span("cd360.unet.attn") is trace._OFF
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(trace.span("cd360.nerf"), torch.profiler.record_function)
    assert seen == ["cd360.nerf"]


def test_a_recompute_stopped_early_closes_its_span(monkeypatch):
    """A checkpointed chunk's recompute ends by an exception raised through
    its ``cd360.nerf`` span once the saved tensors are back (checkpoint's
    early stop); the capture's edge closes the span all the same."""
    from torch.utils.checkpoint import checkpoint

    class Edges(graphs.Segments):
        def __init__(self):  # the span bookkeeping only: no graphs on the CPU
            super().__init__(spans=train_graphs.SPLIT_SPANS)
            self.log = []

        def _begin(self):
            self.log.append(tuple(name for name, _ in self._stack))

        def _end(self):
            pass

    edges = Edges()
    monkeypatch.setattr(graphs, "capture", edges)

    def run(x):
        with trace.span("cd360.nerf"):
            return x.sin().exp() * 2.0

    x = torch.rand(4, requires_grad=True)
    with trace.span("cd360.train.backward"):
        checkpoint(run, x, use_reentrant=False, preserve_rng_state=False).sum().backward()
    assert edges._stack == []
    assert edges.log == [("cd360.train.backward",), ("cd360.train.backward", "cd360.nerf"),
                         ("cd360.train.backward",), ("cd360.train.backward", "cd360.nerf"),
                         ("cd360.train.backward",), ()]
    assert x.grad is not None


def test_resize_reads_weights_made_once_a_shape():
    x = torch.rand((2, 16, 16, 3), generator=torch.Generator().manual_seed(0))
    got = image_resize.resize_images(x, 4, "linear")
    w = image_resize.resize_weights(16, 4, "linear")
    assert torch.equal(got, torch.einsum("bhwc,wW->bhWc",
                                         torch.einsum("bhwc,hH->bHwc", x, w), w))
    assert image_resize._weights(16, 4, "linear", x.device) is \
        image_resize._weights(16, 4, "linear", x.device)
