"""The cached UNet evaluation replayed as piecewise CUDA graphs
(``models/unet_graphs.py``) against the same network run eagerly, on a CUDA
card.

Marked ``cuda``: skipped without a card. The file imports neither JAX nor
the JAX package, so it runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_graphs.py

A tiny bf16 UNet whose two levels hold spatial transformers of 1024 and 256
tokens at head dim 64 (so every self-attention goes to the hand-written
kernel, and the capture splits there), a pose block at every depth, the x3
image + text guider with both dedupes, two reference views from
delta-style buffers. The eager side is the same Engine with
``unet_graphs.engages`` patched to False, so every cached evaluation runs
the network that the graphs wrap. A replay launches the kernels of the
eager evaluation on the same inputs, so the two agree bit for bit.
"""
import numpy as np
import pytest
import torch

from custom_diffusion360_torch.diffusion.guiders import scheduled_cfg_img_text_ref
from custom_diffusion360_torch.engine import Engine, EngineConfig
from custom_diffusion360_torch.geometry.cameras import Cameras
from custom_diffusion360_torch.models import unet_graphs
from custom_diffusion360_torch.models.unet import UNetConfig, attn_block_meta, init_unet_params

pytestmark = pytest.mark.cuda

UNET = UNetConfig(model_channels=64, channel_mult=(1, 2), transformer_depth=(1, 2),
                  attention_resolutions=(1, 2), context_dim=64, adm_in_channels=32,
                  num_head_channels=64, image_cross_blocks=(0, 1, 2, 3), poscontrol_interval=1,
                  num_samples=4, num_freqs=2, nerf_chunk_size=256)
LAT, NREF, STEPS = 32, 2, 6
GUIDER = scheduled_cfg_img_text_ref(scale=7.5, scale_im=3.5)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _params(dev, seed=0):
    params = init_unet_params(UNET, seed, dev, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(seed + 100)

    def fill(node):  # no zero leaf, so that every layer moves the output
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        if isinstance(node, list):
            return [fill(v) for v in node]
        if not node.abs().max() > 0:
            node = (torch.randn(node.shape, generator=gen, device=dev) * 0.02).to(node.dtype)
        return node

    return {"unet": fill(params)}


def _request(dev, seed):
    """The x3 guider's inputs of one request: prompt, noise, target pose and
    reference buffers, all from ``seed``."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    cond = {"crossattn": randn(1, 77, UNET.context_dim), "vector": randn(1, UNET.adm_in_channels)}
    uc = {"crossattn": torch.zeros_like(cond["crossattn"]),
          "vector": randn(1, UNET.adm_in_channels)}
    refs = {}
    for attn_id, (ds, ch, depth) in sorted(attn_block_meta(UNET).items()):
        tcfg = UNET.transformer_config(ch, depth, attn_id)
        for d in range(depth):
            if tcfg.block_has_nerf(d):
                refs.setdefault(attn_id, {})[d] = randn(NREF + 2, (LAT // ds) ** 2, ch,
                                                        scale=0.5, dtype=torch.float32)
    th = np.concatenate([[np.random.default_rng(seed).uniform(0, 2 * np.pi)],
                         np.linspace(0, 2 * np.pi, NREF, endpoint=False)])
    rot = np.zeros((len(th), 3, 3), np.float32)
    rot[:, 0, 0], rot[:, 0, 2], rot[:, 1, 1] = np.cos(th), np.sin(th), 1.0
    rot[:, 2, 0], rot[:, 2, 2] = -np.sin(th), np.cos(th)
    trans = np.tile(np.array([0, 0, 2.7], np.float32), (len(th), 1))
    copies = GUIDER.num_copies
    cams = Cameras.create(rot[None].repeat(copies, 0), trans[None].repeat(copies, 0), 2.0, 0.0,
                          device=dev)
    return dict(cond=cond, uc=uc, noise=randn(1, LAT, LAT, 4, dtype=torch.float32), cams=cams,
                refs=refs)


class _Recorder:
    """The guider, passed through; keeps a copy of each step's guided
    denoised latent."""

    def __init__(self, guider):
        self._guider, self.steps = guider, []

    def __getattr__(self, name):
        return getattr(self._guider, name)

    def combine(self, denoised, sigma):
        out = self._guider.combine(denoised, sigma)
        self.steps.append(out.clone())
        return out


def _sample(eng, params, req, sampler="euler_edm"):
    rec = _Recorder(GUIDER)
    z = eng.sample(params, req["cond"], req["uc"], rec, noise=req["noise"], cams=req["cams"],
                   references=req["refs"], choices=list(range(NREF)), num_steps=STEPS,
                   sampler=sampler, shared_target_cams=True)
    torch.cuda.synchronize()
    return [z] + rec.steps


def _eager(monkeypatch, fn):
    """``fn()`` with every cached evaluation run eagerly, through the network
    that the graphs wrap."""
    with monkeypatch.context() as m:
        m.setattr(unet_graphs, "engages", lambda *a, **k: False)
        return fn()


def _traced(monkeypatch, fn):
    """``fn()`` as the program sees a running profiler: ``utils/trace.py``
    and the graphs read ``torch.autograd._profiler_enabled``. (A real
    profile of a sample leaves later CUDA-only profiles in the process
    short of kernels, with or without graphs, which breaks the launch
    checks of ``tests/test_torch_cuda.py`` run after it.)"""
    with monkeypatch.context() as m:
        m.setattr(torch.autograd, "_profiler_enabled", lambda: True)
        return fn()


def _counts():
    return {k: unet_graphs.evaluations[k] for k in ("capture", "replay", "eager")}


def _moved(before):
    return {k: v - before[k] for k, v in _counts().items()}


def _assert_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (i, float((g.float() - w.float()).abs().max()))


@pytest.mark.parametrize("sampler", ["euler_edm", "heun_edm"])
def test_replay_matches_the_eager_network_at_every_cached_step(dev, monkeypatch, sampler):
    eng, params, req = Engine(EngineConfig(unet=UNET, compute_dtype="bfloat16"), dev), \
        _params(dev), _request(dev, 1)
    _sample(eng, params, req, sampler)  # the warm-up evaluation and the capture
    before = _counts()
    got = _sample(eng, params, req, sampler)
    moved = _moved(before)
    assert moved["capture"] == moved["eager"] == 0 and moved["replay"] >= 4
    want = _eager(monkeypatch, lambda: _sample(eng, params, req, sampler))
    assert len(got) >= 1 + 4
    _assert_equal(got, want)


def test_a_new_request_replays_without_a_capture(dev, monkeypatch):
    eng, params = Engine(EngineConfig(unet=UNET, compute_dtype="bfloat16"), dev), _params(dev)
    _sample(eng, params, _request(dev, 1))
    req = _request(dev, 2)  # new prompt, noise, target pose and references
    before = _counts()
    got = _sample(eng, params, req)
    assert _moved(before) == {"capture": 0, "replay": STEPS - 1, "eager": 0}
    _assert_equal(got, _eager(monkeypatch, lambda: _sample(eng, params, req)))
    assert not torch.equal(got[0], _sample(eng, params, _request(dev, 1))[0])


def test_new_parameters_capture_once_and_in_place_changes_are_seen(dev, monkeypatch):
    eng = Engine(EngineConfig(unet=UNET, compute_dtype="bfloat16"), dev)
    req, first = _request(dev, 3), _params(dev)
    _sample(eng, first, req)
    other = _params(dev, seed=5)  # a new tree of new tensors, while the first lives
    before = _counts()
    got = _sample(eng, other, req)
    assert _moved(before) == {"capture": 1, "replay": STEPS - 2, "eager": 0}
    _assert_equal(got, _eager(monkeypatch, lambda: _sample(eng, other, req)))

    # in place: a fused q/k/v source leaf and a leaf the graphs read as it is
    blk = other["unet"]["output_blocks"][-1][1]["blocks"][0]
    blk["attn1"]["to_q"]["w"].mul_(1.5)
    other["unet"]["out_conv"]["b"].add_(0.25)
    before = _counts()
    changed = _sample(eng, other, req)
    assert _moved(before) == {"capture": 0, "replay": STEPS - 1, "eager": 0}
    assert not torch.equal(changed[0], got[0])
    _assert_equal(changed, _eager(monkeypatch, lambda: _sample(eng, other, req)))


class _Keep:
    """The Engine's denoiser, passed through; keeps each network output as
    returned, with a copy of it."""

    def __init__(self, denoiser):
        self._denoiser, self.kept = denoiser, []

    def __call__(self, network, *args, **kwargs):
        def keep(*a, **k):
            out, aux = network(*a, **k)
            self.kept.append((out, out.clone()))
            return out, aux

        return self._denoiser(keep, *args, **kwargs)


def test_a_kept_result_outlives_the_next_replay(dev):
    eng, params, req = Engine(EngineConfig(unet=UNET, compute_dtype="bfloat16"), dev), \
        _params(dev), _request(dev, 4)
    _sample(eng, params, req)
    eng.denoiser = _Keep(eng.denoiser)
    before = _counts()
    _sample(eng, params, req)
    assert _moved(before)["replay"] == STEPS - 1
    kept = eng.denoiser.kept[1:]  # the cached steps'
    assert len(kept) == STEPS - 1
    for out, copy in kept:
        assert torch.equal(out, copy)
    assert not torch.equal(kept[0][0], kept[-1][0])


def test_replays_count_every_launch_as_the_eager_network(dev, monkeypatch):
    eng, params, req = Engine(EngineConfig(unet=UNET, compute_dtype="bfloat16"), dev), \
        _params(dev), _request(dev, 6)
    _sample(eng, params, req)

    def counted(fn):
        for w in unet_graphs._counted():
            w.launches_by_shape.clear()
        fn()
        return {w.__name__: dict(w.launches_by_shape) for w in unet_graphs._counted()}

    graphed = counted(lambda: _sample(eng, params, req))
    eager = counted(lambda: _eager(monkeypatch, lambda: _sample(eng, params, req)))
    assert graphed == eager
    assert graphed["attention_fwd"] and graphed["layer_norm_fused"] and graphed["group_norm_fused"]


def test_capture_replay_and_eager_counts(dev, monkeypatch):
    eng, params, req = Engine(EngineConfig(unet=UNET, compute_dtype="bfloat16"), dev), \
        _params(dev), _request(dev, 7)
    before = _counts()
    _traced(monkeypatch, lambda: _sample(eng, params, req))  # no capture while traced
    assert _moved(before) == {"capture": 0, "replay": 0, "eager": STEPS - 1}
    before = _counts()
    _sample(eng, params, req)
    assert _moved(before) == {"capture": 1, "replay": STEPS - 2, "eager": 0}
    before = _counts()
    _traced(monkeypatch, lambda: _sample(eng, params, req))  # replays while traced
    assert _moved(before) == {"capture": 0, "replay": STEPS - 1, "eager": 0}
    before = _counts()
    _eager(monkeypatch, lambda: _sample(eng, params, req))
    _sample(eng, params, req, "heun_edm")  # two evaluations a step on the same graphs
    assert _moved(before) == {"capture": 0, "replay": 2 * STEPS - 1, "eager": STEPS - 1}

    (graphs,) = eng.graphs._graphs.values()  # one shape, one set of graphs
    calls = sum(depth for _, _, depth in attn_block_meta(UNET).values())  # self-attentions
    assert len(graphs.calls) == calls and len(graphs.segments) == calls + 1
    assert {w.__name__ for w, _, _ in graphs.calls} == {"attention_fwd"}
