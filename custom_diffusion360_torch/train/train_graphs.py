"""Piecewise CUDA-graph replay of ``Trainer.train_step`` on the card.

A 512² training step is about 32 000 small launches over about 300 ms of
device work, and the host's time to make them is most of the step.
``TrainGraphs``, one per ``Trainer``, captures the whole step (the forward,
the backward and the AdamW update) into CUDA graphs and replays them.

Segments. The capture ends a graph and begins the next (all in one memory
pool) at:

* every CUDA call of the two bilinear wrappers (``ops/onehot_sample.py``:
  ``_sample_forward`` and ``bilinear_sample_bwd``, through their
  ``capture_split``). They run eagerly between the segments, inside their
  spans ``cd360.op.bilinear`` / ``cd360.op.bilinear_bwd`` and counted,
  reading their inputs where the previous segment left them and writing
  into the buffer that the next segment was captured to read (``out=``);
* each edge of the spans in ``SPLIT_SPANS`` (``utils/trace.py``'s
  ``recorder``): the step's phases and the NeRF's chunks. The chunks are
  checkpointed, so their spans and bilinear calls recur in the backward.

A replay launches the segments and the eager calls in their order. Under a
profiler each runs inside the ``SPLIT_SPANS`` that enclosed it at capture:
a replayed kernel carries its graph launch's correlation id, so the device
trace puts it in the span open at that launch, as it did eagerly. Other
spans (the UNet's layers, the conditioner, the norms' op spans) are not
entered in a replay.

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
"capture", "replay", "eager". A replay also credits the op wrappers'
``launches_by_shape`` with the launches that its segments captured, so
those counters still count every launch of the program.
"""
from __future__ import annotations

import contextlib
import warnings
from collections import Counter

import torch

from ..draws import Draws
from ..models.unet_graphs import _copy_into, _counted, _static
from ..ops import onehot_sample
from ..utils import trace

steps = Counter()  # "capture" / "replay" / "eager" -> training steps on the card

# the spans at whose edges a segment ends
SPLIT_SPANS = frozenset({"cd360.train.forward", "cd360.train.backward", "cd360.train.update",
                         "cd360.nerf"})


def engages(device, data_group=None, accumulate: int = 1) -> bool:
    """Whether a training step may run as graphs: on a CUDA device, with no
    data-parallel group and no gradient accumulation."""
    return torch.device(device).type == "cuda" and data_group is None and accumulate == 1


def _leaves(tree, path=()):
    """(path, leaf) of every leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _batch_key(batch) -> tuple:
    """What a capture bakes in of a batch: each tensor's shape, strides,
    dtype and device, and every other leaf's value."""
    return tuple((p, (tuple(x.shape), x.stride(), x.dtype, x.device))
                 if isinstance(x, torch.Tensor) else (p, x) for p, x in _leaves(batch))


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


class _Spans:
    """The spans open in a profiled replay: ``enter(stack)`` closes and
    opens ``record_function`` spans until exactly ``stack`` is open."""

    def __init__(self):
        self.open = []  # ((name, instance), record_function)

    def enter(self, stack):
        keep = 0
        while (keep < len(self.open) and keep < len(stack)
               and self.open[keep][0] == stack[keep]):
            keep += 1
        while len(self.open) > keep:
            self.open.pop()[1].__exit__(None, None, None)
        for item in stack[keep:]:
            rf = torch.profiler.record_function(item[0])
            rf.__enter__()
            self.open.append((item, rf))

    def close(self):
        self.enter(())


class _StepGraphs:
    """The graphs of one key: the segments and the eager bilinear calls
    between them, each with the spans that enclosed it, the static batch
    and draws, and the step's metrics and gradients in graph memory."""

    def __init__(self, state, batch, order, draws):
        self.tree, self.optimizer = state.params, state.optimizer
        self.batch = _static(batch)
        self.order = order
        self.draws = [torch.empty_like(d).copy_(d) for d in draws]
        self.items = []  # (graph, None, stack) or (None, (wrapper, args, out), stack)
        self.empty = []  # graphs that captured nothing
        self.credit = {}
        self.pool = self.metrics = self.leaves = self.grads = None
        self._graph = self._before = None
        self._stack, self._seg_stack, self._spans_opened = [], (), 0

    def bound_to(self, state) -> bool:
        return state.params is self.tree and state.optimizer is self.optimizer

    def capture(self, run, stream):
        """``run()`` captured on ``stream``, a segment at each split; each
        segment replays as it ends, so that the eager calls between them
        read real values: ``run()``'s step is computed."""
        self.pool = torch.cuda.graph_pool_handle()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            trace.recorder, onehot_sample.capture_split = self._span, self._split
            try:
                self._begin()
                out = run()
                self._end()
            except BaseException:
                if self._graph is not None:
                    try:
                        self._graph.capture_end()
                    except RuntimeError:
                        pass
                raise
            finally:
                trace.recorder = onehot_sample.capture_split = None
        torch.cuda.current_stream().wait_stream(stream)
        return out

    def _begin(self):
        self._before = {fn: Counter(fn.launches_by_shape) for fn in _counted()}
        self._seg_stack = tuple(self._stack)
        self._graph = torch.cuda.CUDAGraph()
        # relaxed: autograd's device thread ends and begins segments that
        # the main thread began and ends
        self._graph.capture_begin(pool=self.pool, capture_error_mode="relaxed")

    def _end(self):
        graph, self._graph = self._graph, None
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            graph.capture_end()
        for fn, before in self._before.items():
            launched = Counter(fn.launches_by_shape) - before
            if launched:
                self.credit.setdefault(fn, Counter()).update(launched)
        if any("empty" in str(w.message) for w in caught):
            self.empty.append(graph)  # nothing between two splits; kept, as it holds the pool
            return
        graph.replay()
        self.items.append((graph, None, self._seg_stack))

    @contextlib.contextmanager
    def _edge(self, name):
        self._end()
        self._spans_opened += 1
        self._stack.append((name, self._spans_opened))
        self._begin()
        try:
            yield
        finally:  # also when checkpoint's early stop ends a recompute by raising
            self._end()
            self._stack.pop()
            self._begin()

    def _span(self, name):
        """``trace.recorder``: a split at each edge of a ``SPLIT_SPANS``
        span; other spans are not entered."""
        return self._edge(name) if name in SPLIT_SPANS else trace._OFF

    def _split(self, wrapper, *args):
        """``onehot_sample.capture_split``: end the segment, run the
        bilinear call eagerly, begin the next segment."""
        self._end()
        onehot_sample.capture_split = None
        try:
            out = wrapper(*args)
        finally:
            onehot_sample.capture_split = self._split
        self.items.append((None, (wrapper, args, out), tuple(self._stack)))
        self._begin()
        return out

    def replay(self):
        spans = _Spans() if torch.autograd._profiler_enabled() else None
        for graph, call, stack in self.items:
            if spans is not None:
                spans.enter(stack)
            if graph is not None:
                graph.replay()
            else:
                wrapper, args, out = call
                wrapper(*args, out=out)
        if spans is not None:
            spans.close()
        for fn, launched in self.credit.items():
            fn.launches_by_shape.update(launched)


class TrainGraphs:
    """A ``Trainer``'s graphs of its step, one set a key, and the draws'
    order of each batch shape's eager step."""

    def __init__(self):
        self._graphs = {}  # (batch key, step > 0) -> _StepGraphs
        self._orders = {}  # batch key -> the draws noted in its eager step
        self._stream = None

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
        torch.cuda.synchronize()
        state.optimizer.zero_grad(set_to_none=True)
        if self._stream is None:
            self._stream = torch.cuda.Stream()
        state, metrics = graphs.capture(
            lambda: trainer._step(state, graphs.batch, _Served(graphs.draws, order)),
            self._stream)
        graphs.metrics = metrics
        graphs.leaves = trainer.trainable(state)
        graphs.grads = [leaf.grad for leaf in graphs.leaves]
        self._graphs[key] = graphs
        return state, {k: v.clone() for k, v in metrics.items()}

    @staticmethod
    def _replay(graphs, state, batch, draws):
        for buf, d in zip(graphs.draws, _take_all(draws, graphs.order)):
            buf.copy_(d)
        _copy_into(graphs.batch, batch)
        for leaf, grad in zip(graphs.leaves, graphs.grads):
            if leaf.grad is not grad:  # an eager step ran in between
                leaf.grad = grad
        graphs.replay()
        accum = dict(state.accum, mini_step=0, applied=state.accum["applied"] + 1)
        return (state._replace(step=state.step + 1, accum=accum),
                {k: v.clone() for k, v in graphs.metrics.items()})
