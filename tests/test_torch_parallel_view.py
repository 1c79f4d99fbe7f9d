"""The view-sharded render of ``Engine.sample`` (``view_group``, the JAX
package's ``ref_sharding``) on gloo ranks spawned as processes
(tests/torch_parallel_worker.py, with timeouts), CPU, float32: each rank
renders from its own reference views, and the pose blocks' view softmax,
pool, density and ``average`` means all-reduce over the view group. Two
ranks over the N = 2 views (compact delta buffers, the dense ``mask_ref``
expansion, ``average=True``), and a 2 x 2 (cfg, view) grid from
``parallel.new_groups_2d`` with ``cfg_group`` as well, as JAX
tests/test_parallel_sampling.py::test_cfg_x_view_sharded_render_latency_mode
runs it. Plus the guards: a view group that does not divide the views, a
render with autograd on, and the x3 render dedupe off under ``views``.

Tolerances: 1e-5 of max(1, max|ref|) against the unsharded port and
(compact and dense) against the JAX package's unsharded ``Engine.sample``
on the same injected noise, as tests/test_torch_parallel_sample.py (the
sharded render sums the views in another order; nothing else changes).
The ranks of a view group must end with equal latents, bit for bit.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.engine import Engine as JEngine
from custom_diffusion360_tpu.geometry.cameras import Cameras as JCams
from custom_diffusion360_torch.models import nerf, transformer
from custom_diffusion360_torch.models.nerf import CompactRefTokens
from tests.test_torch_common import max_err
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)
from tests.test_torch_engine_samplers import GUIDERS, NREF, STEPS, _cfgs
from tests.test_torch_engine_samplers import setup  # noqa: F401  (module fixture)
from tests.test_torch_parallel_sample import _inputs, _unsharded
from tests.torch_parallel_worker import run_ranks

pytestmark = pytest.mark.usefixtures("torch_threads")


def _average(inp):
    cfg = inp["engine_cfg"]
    return dict(inp, engine_cfg=dataclasses.replace(
        cfg, unet=dataclasses.replace(cfg.unet, average=True)))


def _jax(setup, inp):  # noqa: F811
    """JAX's unsharded Engine.sample on the same inputs."""
    params, refs = setup[:2]
    jcfg = _cfgs()[0]
    mask = inp["kwargs"].get("mask_ref")
    noise = inp["noise"].numpy()
    return np.asarray(JEngine(jcfg).sample(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v.numpy()) for k, v in inp["cond"].items()},
        {k: jnp.asarray(v.numpy()) for k, v in inp["uc"].items()},
        GUIDERS[2][0], jax.random.PRNGKey(0), shape=noise.shape,
        cams=JCams(*(jnp.asarray(f.numpy()) for f in inp["cams"])),
        references=jax.tree.map(jnp.asarray, refs), choices=np.arange(NREF),
        num_steps=STEPS, noise=jnp.asarray(noise),
        mask_ref=None if mask is None else jnp.asarray(mask.numpy())))


def _close(z, want):
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    return z.shape == tuple(want.shape) and max_err(z, want) <= 1e-5 * scale


CASES = {"compact": {}, "dense-mask_ref": dict(mask=True), "average": dict(average=True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_view_sharded_sample_matches_unsharded_and_jax(setup, tmp_path, case):  # noqa: F811
    """x2 guider, one image, its N = 2 reference views over two ranks: the
    compact delta buffers, the dense expansion that a per-row mask_ref
    needs, and the average pooling (no view softmax; against the unsharded
    port only: JAX would compile a second engine, 20 s more)."""
    kw = dict(CASES[case])
    average = kw.pop("average", False)
    inp = _inputs(setup, 2, **kw)
    if average:
        inp = _average(inp)
    out = run_ranks("view_sample", tmp_path, dict(inp, grid=(1, 2)))
    want = _unsharded(inp)
    z_j = None if average else _jax(setup, inp)
    for z in out:
        assert _close(z, want), case
        assert z_j is None or _close(z, z_j), case
    assert torch.equal(out[0], out[1])


def test_cfg_x_view_sharded_sample(setup, tmp_path):  # noqa: F811
    """A 2 x 2 (cfg, view) grid of four ranks: the x2 guider's two rows
    over the cfg axis, the two views over the view axis."""
    inp = _inputs(setup, 2)
    out = run_ranks("view_sample", tmp_path, dict(inp, grid=(2, 2)), world=4)
    want = _unsharded(inp)
    for z in out:
        assert _close(z, want)
    assert torch.equal(out[0], out[1]) and torch.equal(out[2], out[3])


def test_view_group_must_divide_the_views(setup, monkeypatch):  # noqa: F811
    """Two chosen views over a group of three raises, naming both numbers,
    before any collective."""
    from custom_diffusion360_torch.engine import Engine
    from custom_diffusion360_torch.parallel import mesh

    monkeypatch.setattr(mesh, "world_size", lambda group=None: 3)
    monkeypatch.setattr(mesh, "rank", lambda group=None: 0)
    inp = _inputs(setup, 2)
    with pytest.raises(ValueError, match="2 chosen views do not split over a view group of 3"):
        Engine(inp["engine_cfg"], device="cpu").sample(
            inp["params"], inp["cond"], inp["uc"], inp["guider"], noise=inp["noise"],
            cams=inp["cams"], references=inp["references"], choices=inp["choices"],
            num_steps=inp["steps"], view_group=object())


def test_view_sharded_render_refuses_autograd(setup):  # noqa: F811
    """The view all-reduce is not differentiable: a render inside
    view_sharded with autograd on raises before any collective."""
    logits = torch.zeros((1, 2, 4, 3), requires_grad=True)
    with nerf.view_sharded(object()), pytest.raises(RuntimeError, match="not differentiable"):
        nerf._view_softmax(logits)
    with nerf.view_sharded(object()), pytest.raises(RuntimeError, match="not differentiable"):
        nerf._view_mean(logits)
    assert nerf._VIEW_GROUP is None  # restored on the way out


@pytest.mark.parametrize("views", [None, (0, 1)])
def test_cfg3_render_dedupe_is_off_under_views(views, monkeypatch):
    """Under the x3 guider with shared cameras the render runs on the two
    unique copies; with a rank's views it runs on all three, as JAX keeps
    the dedupe off under ref_sharding."""
    seen = []

    class Rendered(Exception):
        pass

    def spy(p, cams, xref, cfg, **kw):
        seen.append(xref.shape)
        raise Rendered

    monkeypatch.setattr(transformer, "nerfsd_apply", spy)
    zero, chosen = torch.zeros((16, 8)), torch.zeros((2, 16, 8))
    tok = CompactRefTokens(zero, chosen, 1, 3, shared_cams=True, views=views)
    cfg = types.SimpleNamespace(nerf=None, use_prev_weights_imp_sample=False,
                                block_imp_sample_next=lambda d: False)
    with pytest.raises(Rendered):
        transformer._reference_attn({"pose_featurenerf": None}, _Rows(), tok, None, None,
                                    cfg, 0)
    assert seen[0] == ((2, 2, 16, 8) if views is None else (3, 1, 16, 8))


class _Rows:
    """A stand-in for the cameras: any row slice is itself."""

    def __getitem__(self, _):
        return self
