"""Piecewise CUDA-graph capture: a stretch of the program whose host time to
make its many small launches is most of its time, captured once into CUDA
graphs and replayed, with a few calls kept eager between the graphs.

Capture. ``Segments.capture(run)`` runs ``run()`` on a side stream, every
graph in one memory pool, which the ``Segments`` owns. It ends a graph and
begins the next:

* at every call of a split point (``split_point``) that is in its
  ``splits``. The call runs eagerly between two graphs, inside its span and
  counted, reading its inputs where the previous graph left them; at a
  replay it writes into the buffer that the next graph was captured to read
  (the wrapper's ``out=``);
* at each edge of a span (``utils/trace.py``) whose name is in its
  ``spans``. A span stopped by an exception (checkpoint's early stop of a
  recompute) ends its graph all the same.

Each graph replays once as it ends, so that the eager calls read real
values: the capture computes ``run()``. A graph that captured nothing is set
aside (it still holds the pool). Captures run in "relaxed" mode, since
autograd's device thread ends and begins graphs that the main thread began
and ends.

Replay. ``Segments.replay()`` launches the graphs and the eager calls in
their order. Under a profiler each runs inside the spans of ``spans`` that
enclosed it at capture: a replayed kernel carries its graph launch's
correlation id, so the device trace puts it in the span open at that launch,
as it did eagerly. No other span is entered in a replay.

Counting. The op wrappers that count their launches by shape in
``launches_by_shape`` register with ``counted``. A capture notes what each
graph added to those counters, and each replay adds it again, so the
counters count every launch of the program.

The hook. ``capture`` is the ``Segments`` capturing now, or None. A split
point's call and ``trace.span`` read it. It is a module global, not a
thread-local: autograd's device thread calls the backward's split points.

A user of this module keeps only its policy: when it captures, what a
capture is keyed on, how its inputs reach the static buffers (``static``,
``copy_into``) and what it copies out of the pool.
"""
from __future__ import annotations

import contextlib
import functools
import warnings
from collections import Counter

import torch

capture = None  # the Segments capturing now
COUNTED = []  # the op wrappers that count their launches by shape


def counted(fn):
    """Decorator: ``fn`` counts its launches by shape in
    ``fn.launches_by_shape``, which each replay credits."""
    fn.launches_by_shape = Counter()
    COUNTED.append(fn)
    return fn


def split_point(fn):
    """Decorator: a split point of a piecewise capture. A call while a
    capture whose ``splits`` hold the wrapper runs is that capture's
    ``split``; every other call goes straight to ``fn``."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if capture is not None and wrapper in capture.splits:
            return capture.split(fn, args, kwargs)
        return fn(*args, **kwargs)

    return wrapper


def leaves(tree, path=()):
    """(path, leaf) of every leaf of a tree of dicts, lists and tuples, in
    order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def tensors(tree):
    """(path, tensor) of every tensor leaf of a tree, in order."""
    return [(p, x) for p, x in leaves(tree) if isinstance(x, torch.Tensor)]


def static(tree):
    """A copy of a tree whose tensors have the same shapes and strides."""
    if isinstance(tree, dict):
        return {k: static(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [static(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tree.shape, tree.stride(), dtype=tree.dtype,
                                   device=tree.device).copy_(tree)
    return tree


def copy_into(dst, tree):
    """Each tensor leaf of ``tree`` copied into the same leaf of ``dst``."""
    for (_, d), (_, s) in zip(tensors(dst), tensors(tree)):
        d.copy_(s)


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


class Segments:
    """The graphs of one capture split at the calls of ``splits`` and the
    edges of the spans named in ``spans``: ``items`` in order, each a graph
    or an eager call, with the stack of those spans that enclosed it, and
    ``credit``, the launches of each counted wrapper that the graphs hold."""

    def __init__(self, splits=frozenset(), spans=frozenset()):
        self.splits, self.spans = splits, spans
        self.items = []  # (graph, None, stack) or (None, (fn, args, kwargs), stack)
        self.empty = []  # graphs that captured nothing; kept, as they hold the pool
        self.credit = {}
        self.pool = None
        self._graph = self._before = None
        self._stack, self._seg_stack, self._spans_opened = [], (), 0

    def capture(self, run):
        """``run()`` captured on a side stream, a graph ending at each split;
        each graph replays as it ends, so that the eager calls between them
        read real values. Returns ``run()``'s result."""
        global capture
        torch.cuda.synchronize()
        self.pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            capture = self
            try:
                self._begin()
                out = run()
                self._end()
            except BaseException:
                if self._graph is not None:
                    with contextlib.suppress(RuntimeError):
                        self._graph.capture_end()
                raise
            finally:
                capture = None
        torch.cuda.current_stream().wait_stream(stream)
        return out

    def _begin(self):
        self._before = {fn: Counter(fn.launches_by_shape) for fn in COUNTED}
        self._seg_stack = tuple(self._stack)
        self._graph = torch.cuda.CUDAGraph()
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
            self.empty.append(graph)
            return
        graph.replay()
        self.items.append((graph, None, self._seg_stack))

    @contextlib.contextmanager
    def edge(self, name):
        """The span ``name``: a split where it opens and where it closes."""
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

    def split(self, fn, args, kwargs):
        """End the graph, run ``fn`` eagerly, begin the next graph."""
        self._end()
        out = fn(*args, **kwargs)
        self.items.append((None, (fn, args, dict(kwargs, out=out)), tuple(self._stack)))
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
                fn, args, kwargs = call
                fn(*args, **kwargs)
        if spans is not None:
            spans.close()
        for fn, launched in self.credit.items():
            fn.launches_by_shape.update(launched)
