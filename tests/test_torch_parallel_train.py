"""Data-parallel training of the port on two gloo ranks (one process each,
tests/torch_parallel_worker.py, with timeouts): ``Trainer(data_group=)``
against one process on the global batch and against the JAX package's
``Trainer.train_step``, ``cli.train --smoke --multihost`` end to end, and
the view-sharded reference capture. CPU, float32.

The equivalence held: two ranks of one row each, every draw the rank's
rows of the global draws, give the update of one process on the two rows
concatenated (the gradient of the global mean, as JAX's grad of the
global-batch loss). Tolerances: against one process 1e-5 (the loss terms
and ``grad_norm`` relative, each trainable leaf's change from the start
relative to its max|change|); against JAX 1e-4, as tests/test_torch_train.py
and test_torch_train_cli.py (the change plus four float32 roundings of the
leaf's largest entry); the capture 1e-6 of max|ref|. AdamW runs with
eps = 1, so an update is smooth in its gradient (tests/test_torch_train_cli.py).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_diffusion360_tpu.engine import Engine as JEngine
from custom_diffusion360_tpu.train import trainer as jtrainer
from custom_diffusion360_torch.draws import Draws
from custom_diffusion360_torch.engine import Engine
from custom_diffusion360_torch.geometry.cameras import Cameras
from custom_diffusion360_torch.train.capture import capture_references
from custom_diffusion360_torch.train.trainer import TrainConfig, Trainer
from tests.test_cameras import random_cameras
from tests.test_torch_common import max_err, random_params, t, to_torch
from tests.test_torch_common import torch_threads  # noqa: F401  (fixture)
from tests.test_torch_train import _batch, _cfgs, replay_draws
from tests.torch_parallel_worker import run_ranks

pytestmark = pytest.mark.usefixtures("torch_threads")

LR, CLIP = 1e-2, 1e-3  # CLIP under the gradient norms: every update clips
ACCUM = dict(lr=LR, eps=1.0, max_grad_norm=CLIP, accumulate_grad_batches=2)
ONE = dict(lr=LR, eps=1.0, max_grad_norm=CLIP)
KEYS = (jax.random.PRNGKey(1), jax.random.PRNGKey(2))
EPS32 = float(np.finfo(np.float32).eps)


def _draws(key):
    return {k: t(np.asarray(v)) for k, v in replay_draws(key, b=2).items()}


def _dropped(batches, drop=(1.0, 0.0)):
    """(JAX batch, port batch) with drop_im set: rank 0's row keeps its
    reference images, rank 1's does not."""
    jb, tb = batches
    d = np.asarray(drop, np.float32)
    return dict(jb, drop_im=jnp.asarray(d)), dict(tb, drop_im=t(d))


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """The two-rank runs (accumulation over two calls; one call; one call
    whose rows differ in drop_im) and their inputs, the global batches of
    two rows."""
    jcfg, tcfg = _cfgs()
    params = random_params(JEngine(jcfg).init_params, seed=3)
    batches = [_batch(B=2, seed=s) for s in (0, 1)]
    batches.append(_dropped(batches[0]))
    calls = [(tb, _draws(k)) for (_, tb), k in zip(batches, KEYS + KEYS[:1])]
    runs = [{"train_cfg": ACCUM, "calls": calls[:2]}, {"train_cfg": ONE, "calls": calls[:1]},
            {"train_cfg": ONE, "calls": calls[2:]}]
    out = run_ranks("ddp_steps", tmp_path_factory.mktemp("ddp"),
                    dict(engine_cfg=tcfg, params=to_torch(params), runs=runs))
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, batches=batches, calls=calls, out=out)


def _one_process(ddp, train_cfg, calls):
    eng = Engine(ddp["tcfg"], device="cpu")
    tr = Trainer(eng, TrainConfig(**train_cfg))
    state = tr.init_state(to_torch(ddp["params"]))._replace(step=1)
    metrics = []
    for batch, draws in calls:
        state, m = tr.train_step(state, batch, Draws(torch.Generator().manual_seed(0), draws))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, [leaf.detach() for leaf in tr.trainable(state)], tr


def _start(ddp, tr):
    return [leaf.detach() for leaf in tr.trainable(tr.init_state(to_torch(ddp["params"])))]


def _check_one_process(ddp, run, train_cfg, calls, ulps=0):
    """Every rank's metrics and updated trainable leaves of ``run`` against
    one process on the global batches of ``calls``; ``ulps`` float32
    roundings of the leaf's largest entry are added to each leaf's
    tolerance."""
    metrics, leaves, tr = _one_process(ddp, train_cfg, calls)
    start = _start(ddp, tr)
    assert all(m["grad_norm"] > CLIP for m in metrics)
    for rank_out in ddp["out"]:
        got = rank_out[run]
        for m_got, m_want in zip(got["metrics"], metrics):
            assert set(m_got) == set(m_want)
            for k, v in m_want.items():
                assert abs(m_got[k] - v) <= 1e-5 * abs(v), (k, m_got[k], v)
        moved = 0
        for g, w, s in zip(got["trainable"], leaves, start):
            dw = (w - s).abs().max()
            moved += bool(dw > 0)
            tol = 1e-5 * max(float(dw), 1e-12) + ulps * EPS32 * float(s.abs().max())
            assert max_err(g - s, w - s) <= tol
        assert moved > 0
    for a, b in zip(ddp["out"][0][run]["trainable"], ddp["out"][1][run]["trainable"]):
        assert torch.equal(a, b)  # the ranks hold the same parameters


def _check_jax(ddp, run, jbatch, key):
    """Rank 0's one-call ``run`` against JAX Trainer.train_step on the
    two-row batch with the replayed key splits."""
    jcfg, params = ddp["jcfg"], ddp["params"]
    jtr = jtrainer.Trainer(JEngine(jcfg), jtrainer.TrainConfig(**ONE))
    jstate = jtr.init_state(jax.tree.map(jnp.asarray, params))
    jstate = jstate._replace(step=jnp.ones((), jnp.int32))
    jnew, jmetrics = jax.jit(jtr.train_step)(jstate, jbatch, key)
    got = ddp["out"][0][run]
    assert set(got["metrics"][0]) == set(jmetrics)
    for k, v in jmetrics.items():
        assert abs(got["metrics"][0][k] - float(v)) <= 1e-4 * abs(float(v)), k
    want = [np.asarray(p) for p, m in zip(jax.tree.leaves(jnew.params),
                                          jax.tree.leaves(jtr.mask)) if m]
    start = [np.asarray(p) for p, m in zip(jax.tree.leaves(params),
                                           jax.tree.leaves(jtr.mask)) if m]
    assert len(want) == len(got["trainable"]) > 0
    for g, w, s in zip(got["trainable"], want, start):
        dw = np.abs(w - s).max()
        tol = 1e-4 * dw + 4 * np.finfo(np.float32).eps * np.abs(s).max()
        assert max_err(g.numpy() - s, w - s) <= tol


def test_ddp_step_equals_one_process_on_the_global_batch(ddp):
    """Two ranks x one row, accumulation over two calls and per-group
    clipping, against one process on the two rows of each call."""
    _check_one_process(ddp, 0, ACCUM, ddp["calls"][:2])


def test_ddp_step_matches_jax_on_the_global_batch(ddp):
    """The same two ranks, one call, against JAX Trainer.train_step on the
    two-row batch with the replayed key splits."""
    _check_jax(ddp, 1, ddp["batches"][0][0], KEYS[0])


def test_ddp_step_with_ranks_that_keep_unequal_references(ddp):
    """drop_im [1, 0]: rank 0's row keeps its reference images, rank 1's
    does not. The fg / bg / rgb terms are divided by the global batch's
    count of kept items (1), not by each rank's (1 and 0), so the ranks'
    mean is one process's step on the two rows, and JAX's. Rank 1's row
    gives the pose leaves no fg / bg / rgb gradient, so some leaves move by
    little more than their weight decay, and the tolerance of a leaf's
    change adds two float32 roundings of its largest entry (the leaf is
    rounded once in each run)."""
    calls = ddp["calls"][2:]
    assert calls[0][0]["drop_im"].tolist() == [1.0, 0.0]
    _check_one_process(ddp, 2, ONE, calls, ulps=2)
    _check_jax(ddp, 2, ddp["batches"][2][0], KEYS[0])
    fg = ddp["out"][0][2]["metrics"][0]["loss_fg"]
    assert fg > 0


def test_train_cli_multihost_smoke(tmp_path):
    """cli.train --smoke --multihost --device cpu on two ranks (3 steps,
    accumulation 2, a full checkpoint and a validation loss at step 2):
    only rank 0 writes config.json, metrics.csv, checkpoints and the delta;
    both ranks end with the same parameters."""
    out = run_ranks("train_cli", tmp_path, {}, timeout=150)
    run0, run1 = tmp_path / "run0", tmp_path / "run1"
    # the checkpoint after the third call (step index 2) and the final one
    # share the call count, 3
    for name in ("config.json", "metrics.csv", "delta_last.npz",
                 "checkpoints/step_00000003/train_state.pt"):
        assert (run0 / name).exists(), name
    assert [f for _, _, files in os.walk(run1) for f in files] == []
    assert out[0]["delta"] and out[1]["delta"] is None
    assert out[0]["steps"] == out[1]["steps"] == 3
    assert len(out[0]["trainable"]) == len(out[1]["trainable"]) > 0
    for a, b in zip(out[0]["trainable"], out[1]["trainable"]):
        assert torch.equal(a, b)
    rows = (run0 / "metrics.csv").read_text().splitlines()
    assert any("val_loss" in r for r in rows[:1])


def test_view_sharded_capture_equals_one_process(tmp_path):
    """capture_references with its 3 + 1 views split over two ranks (the
    views' encode, noising and reference stream each on one rank, the
    buffers all-gathered) equals the one-process capture."""
    jcfg, tcfg = _cfgs()
    params = to_torch(random_params(JEngine(jcfg).init_params, seed=3))
    n = 3
    rng = np.random.default_rng(4)
    images = t(rng.normal(size=(n, 64, 64, 3)).astype(np.float32) * 0.2)
    cams = Cameras(*(t(np.asarray(f)) for f in random_cameras(n + 2, seed=5))).reshape(1, n + 2)
    cond = {"crossattn": t(rng.normal(size=(n + 2, 16, 96)).astype(np.float32) * 0.1),
            "vector": t(rng.normal(size=(n + 2, 72)).astype(np.float32) * 0.1)}
    eng = Engine(tcfg, device="cpu")
    want = capture_references(eng, params, images, cams, cond,
                              Draws(torch.Generator().manual_seed(9)))
    out = run_ranks("capture", tmp_path, dict(engine_cfg=tcfg, params=params, images=images,
                                              cams=cams, cond=cond, seed=9))
    assert want
    for got in out:
        assert got.keys() == want.keys()
        for a, per_d in want.items():
            for d, w in per_d.items():
                assert got[a][d].shape == w.shape and w.shape[0] == n + 1
                assert max_err(got[a][d], w) <= 1e-6 * float(w.abs().max()), (a, d)
