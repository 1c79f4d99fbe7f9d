"""Spans at the port's layer boundaries, for ``torch.profiler``.

``span(name)`` is ``torch.profiler.record_function(name)`` while a torch
profiler is running, and one shared no-op context otherwise: with nothing
tracing, a span costs one ``torch.autograd._profiler_enabled()`` call and
enters no ``record_function``. So the spans exist exactly when a profiler
runs (the benchmark's traced runs, the training CLI's ``--profile_steps``),
and they land in that profiler's trace beside the aten ops and the
device's kernels, on its clock.

One other listener: while ``recorder`` is set (a piecewise CUDA-graph
capture of the training step, ``train/train_graphs.py``, which never runs
under a profiler), ``span(name)`` is ``recorder(name)``, a context manager
of the recorder's, so that the capture knows where each span opens and
closes and can reopen it around the replayed work.

Every name starts with ``cd360.``; PERF.md §3 lists them, where each sits
and the metric that reads it.
"""
from __future__ import annotations

import contextlib
import functools

import torch

_OFF = contextlib.nullcontext()

# while set: a callable, name -> a context manager that stands for the span
recorder = None


def span(name: str):
    """A ``record_function`` span named ``name`` while a profiler runs,
    else ``recorder(name)`` while a recorder is set, else the shared null
    context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    if recorder is not None:
        return recorder(name)
    return _OFF


def spanned(name: str):
    """Decorator: every call of the function inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def span_range(name: str, n: int):
    """``range(n)`` whose every iteration (the loop body) runs inside
    ``span(name)``."""
    for i in range(n):
        with span(name):
            yield i
