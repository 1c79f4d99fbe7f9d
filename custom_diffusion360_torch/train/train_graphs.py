"""``Trainer.train_step`` replayed as piecewise CUDA graphs on the card
(``utils/graphs.py``): the policy.

A 512² training step is about 30 000 small launches. ``TrainGraphs``, one
per ``Trainer``, captures the whole step (the forward, the backward and the
AdamW update) and replays it.

Splits: the two bilinear wrappers, ``bilinear_sample_fwd`` and
``bilinear_sample_bwd`` (``ops/onehot_sample.py``), and the edges of the
spans in ``SPLIT_SPANS``: the step's phases and the NeRF's chunks. The
chunks are checkpointed, so their spans and bilinear calls recur in the
backward. A profiled replay reopens those spans; other spans (the UNet's
layers, the conditioner, the norms' op spans) are not entered in a replay.

Inputs. Before each replay the step's batch is copied into static buffers,
and every draw is taken eagerly through the step's own ``Draws``, with the
names, shapes and order that the eager step before the capture noted, into
static buffers: a draws recorder sees the numbers the step used, and no
batch value reaches the host. The ``Trainer`` builds the AdamW capturable
with each group's lr a 0-d device tensor, written before each step. The
gradients live in the pool: ``zero_grad`` runs only before a capture, and a
replay overwrites them. The metrics returned are copies out of the pool, so
a kept result outlives the next replay.

When. ``engages``: a CUDA device, no ``data_group`` and no gradient
accumulation; every other step runs as it is. The first step of a batch
shape runs eagerly (its kernels load, cuBLAS and cuDNN set up, the
optimizer's state is made, the draws' order is noted); the next one
captures (and computes its step), and later ones replay. A capture is keyed
on the batch's shapes and non-tensor values and on whether ``state.step`` is
past 0 (the loss's fg / bg terms count from step 1); a new key captures
again, and so does a new parameter tree or optimizer. No capture runs while
a profiler traces: that step runs eagerly.

``steps`` counts the training steps on the card by how they ran:
"capture", "replay", "eager".
"""
from __future__ import annotations

from collections import Counter

import torch

from ..draws import Draws
from ..ops import onehot_sample
from ..utils.graphs import Segments, copy_into, leaves, static

steps = Counter()  # "capture" / "replay" / "eager" -> training steps on the card
SPLITS = frozenset({onehot_sample.bilinear_sample_fwd, onehot_sample.bilinear_sample_bwd})
SPLIT_SPANS = frozenset({"cd360.train.forward", "cd360.train.backward", "cd360.train.update",
                         "cd360.nerf"})


def engages(device, data_group=None, accumulate: int = 1) -> bool:
    """Whether a training step may run as graphs: on a CUDA device, with no
    data-parallel group and no gradient accumulation."""
    return torch.device(device).type == "cuda" and data_group is None and accumulate == 1


def _batch_key(batch) -> tuple:
    """What a capture bakes in of a batch: each tensor's shape, strides,
    dtype and device, and every other leaf's value."""
    return tuple((p, (tuple(x.shape), x.stride(), x.dtype, x.device))
                 if isinstance(x, torch.Tensor) else (p, x) for p, x in leaves(batch))


class _Noting(Draws):
    """The step's draws, passed through; each draw noted in ``order`` as
    (name under the step's draws, shape, device, make)."""

    def __init__(self, inner, order, path=""):
        super().__init__(inner.gen, inner.given, inner.prefix, inner.shard)
        self.inner, self.order, self.path = inner, order, path

    def child(self, name):
        return _Noting(self.inner.child(name), self.order, f"{self.path}{name}/")

    def take(self, name, shape, device, make):
        out = self.inner.take(name, shape, device, make)
        self.order.append((self.path + name, tuple(shape), device, make))
        return out


class _Served(Draws):
    """The static draw buffers, handed out in the noted order; a draw that
    is not the next one noted raises."""

    def __init__(self, buffers, order, prefix="", cursor=None):
        super().__init__(prefix=prefix)
        self.buffers, self.order = buffers, order
        self.cursor = [0] if cursor is None else cursor

    def child(self, name):
        return _Served(self.buffers, self.order, f"{self.prefix}{name}/", self.cursor)

    def take(self, name, shape, device, make):
        i = self.cursor[0]
        want = self.order[i][:2] if i < len(self.order) else None
        if want != (self.prefix + name, tuple(shape)):
            raise RuntimeError(f"the captured step draws {self.prefix + name!r} "
                               f"{tuple(shape)} where the eager step drew {want}")
        self.cursor[0] = i + 1
        return self.buffers[i]


def _take_all(draws, order):
    """Every draw of ``order``, taken eagerly through ``draws``."""
    out = []
    for name, shape, device, make in order:
        prefix, _, leaf = name.rpartition("/")
        out.append((draws.child(prefix) if prefix else draws).take(leaf, shape, device, make))
    return out


class _StepGraphs(Segments):
    """The graphs of one key: the static batch and draws, and the step's
    metrics and gradients in graph memory."""

    def __init__(self, state, batch, order, draws):
        super().__init__(SPLITS, SPLIT_SPANS)
        self.tree, self.optimizer = state.params, state.optimizer
        self.batch, self.order = static(batch), order
        self.draws = static(draws)
        self.metrics = self.leaves = self.grads = None

    def bound_to(self, state) -> bool:
        return state.params is self.tree and state.optimizer is self.optimizer


class TrainGraphs:
    """A ``Trainer``'s graphs of its step, one set a key, and the draws'
    order of each batch shape's eager step."""

    def __init__(self):
        self._graphs = {}  # (batch key, step > 0) -> _StepGraphs
        self._orders = {}  # batch key -> the draws noted in its eager step

    def clear(self):
        if self._graphs:
            torch.cuda.synchronize()
        self._graphs.clear()

    def step(self, trainer, state, batch, draws):
        """One ``trainer`` step on the card: as graphs where ``engages``,
        else ``trainer._step`` as it is."""
        if not engages(trainer.engine.device, trainer.data_group,
                       trainer.cfg.accumulate_grad_batches):
            steps["eager"] += 1
            return trainer._step(state, batch, draws)
        if any(not g.bound_to(state) for g in self._graphs.values()):
            self.clear()  # a new parameter tree or optimizer
        bkey = _batch_key(batch)
        key = (bkey, state.step > 0)
        graphs = self._graphs.get(key)
        if graphs is not None:
            steps["replay"] += 1
            return self._replay(graphs, state, batch, draws)
        order = self._orders.get(bkey)
        if order is None or torch.autograd._profiler_enabled():
            steps["eager"] += 1
            order = []
            out = trainer._step(state, batch, _Noting(draws, order))
            self._orders[bkey] = order
            return out
        steps["capture"] += 1
        graphs = _StepGraphs(state, batch, order, _take_all(draws, order))
        state.optimizer.zero_grad(set_to_none=True)
        state, metrics = graphs.capture(
            lambda: trainer._step(state, graphs.batch, _Served(graphs.draws, order)))
        graphs.metrics = metrics
        graphs.leaves = trainer.trainable(state)
        graphs.grads = [leaf.grad for leaf in graphs.leaves]
        self._graphs[key] = graphs
        return state, {k: v.clone() for k, v in metrics.items()}

    @staticmethod
    def _replay(graphs, state, batch, draws):
        copy_into(graphs.draws, _take_all(draws, graphs.order))
        copy_into(graphs.batch, batch)
        for leaf, grad in zip(graphs.leaves, graphs.grads):
            if leaf.grad is not grad:  # an eager step ran in between
                leaf.grad = grad
        graphs.replay()
        accum = dict(state.accum, mini_step=0, applied=state.accum["applied"] + 1)
        return (state._replace(step=state.step + 1, accum=accum),
                {k: v.clone() for k, v in graphs.metrics.items()})
