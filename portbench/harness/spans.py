"""The program's spans folded with the device trace.

The port marks its layer boundaries with ``record_function`` spans named
``cd360.*`` while a torch profiler runs (``utils/trace.py`` in the port;
PERF.md §3 lists them). ``of(ctx)`` runs ``ctx.job.trace_units`` more
units (indices -10, -11, ...) under ``trace.profiler()`` and folds that
one kineto trace, spans and device operations on one clock, into totals a
span name:

    calls, host ms (the span's duration), self host ms (less the time its
    child spans cover), device ms (the device operations launched inside
    it, its children's included), launches (their count), and the device's
    idle ms inside the span's interval.

A device operation (kernel, copy, set) is matched to the runtime or driver
call that launched it by correlation id, and that call to the innermost
``cd360.*`` span open on its own thread; where its thread has none open,
to the innermost span open on any thread at its time (the latest-starting
one): so the launches of autograd's device thread go to the main thread's
``cd360.train.backward``, unless that thread has a span of its own open
(``cd360.nerf`` recomputed, ``cd360.op.bilinear_bwd``). A span's parent is
found the same way from its start. The fold also keeps the device ms that
no launching call matched, the device ms launched inside no span, and each
device idle gap's ms by the span open at its middle.

On a program without spans, or on the CPU, the fold has nothing to read:
the readers of its metrics (metrics/span.*.py, metrics/roofline_span.*.py)
return None. It costs the ``--trace 1`` run one more image or two more
steps; ``Fold.seconds`` says how long."""
from __future__ import annotations

import bisect
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field

from torch.autograd import DeviceType

from . import cell
from . import trace as tracing

PREFIX = "cd360."
STEP, NERF = "cd360.sample.step", "cd360.nerf"
NO_SPAN = "(no span)"


@dataclass
class Span:
    """The totals of one span name over the fold's units."""

    calls: int = 0
    host_ms: float = 0.0
    self_ms: float = 0.0
    device_ms: float = 0.0
    launches: int = 0
    idle_ms: float = 0.0


@dataclass
class Fold:
    units: int
    spans: dict = field(default_factory=dict)  # name -> Span
    steps: list = field(default_factory=list)  # [(host ms, device ms, launches)] of
    #                                            the sampler steps that hold no render
    busy_ms: float = 0.0  # the union of the device operations' intervals
    top_ms: float = 0.0  # device ms of the spans that have no parent
    unmatched_ms: float = 0.0  # device ms whose launching call was not found
    outside_ms: float = 0.0  # device ms launched inside no span
    idle_by_span: dict = field(default_factory=dict)  # innermost span -> idle ms
    launches: dict = field(default_factory=dict)  # wrapper counter -> {shape: n}
    seconds: float = 0.0  # wall seconds of the fold's units and its reading

    def per_unit(self, name: str, what: str):
        """``what`` of span ``name`` a unit, or None with nothing to read."""
        s = self.spans.get(name)
        if self.busy_ms <= 0.0 or s is None or s.calls == 0:
            return None
        return getattr(s, what) / self.units

    def step_mean(self, index: int):
        """Mean host ms (0), device ms (1) or launches (2) of a sampler step
        that holds no render."""
        if self.busy_ms <= 0.0 or not self.steps:
            return None
        return sum(s[index] for s in self.steps) / len(self.steps)


def of(ctx) -> Fold:
    """The fold of ``ctx``'s cell, made once per context."""
    fold = vars(ctx).get("_span_fold")
    if fold is None:
        fold = vars(ctx)["_span_fold"] = run(ctx.job, ctx.job.trace_units)
    return fold


def run(job, units: int) -> Fold:
    """``units`` more units of ``job`` under the profiler, folded; with the
    op wrappers' launch counts of those units."""
    t0 = time.perf_counter()
    counters = cell._counters()
    before = {k: Counter(c.launches_by_shape) for k, c in counters.items()}
    prof = tracing.profiler()
    cell.sync(job.cell.device)
    with prof:
        for k in range(units):
            job.unit(-10 - k)
        cell.sync(job.cell.device)
    fold = read(prof.profiler.kineto_results.events(), units)
    del prof
    fold.launches = {k: dict(Counter(c.launches_by_shape) - before[k])
                     for k, c in counters.items()}
    fold.seconds = time.perf_counter() - t0
    return fold


def _innermost(spans, order, times):
    """For each of ``times`` (ascending), the index of the innermost span of
    ``order`` (indices into ``spans`` of one thread, by start) open then,
    or -1. Spans of one thread nest; one that ends as the next starts is
    not its parent."""
    out, stack, j = [], [], 0
    for t in times:
        while j < len(order) and spans[order[j]][0] <= t:
            s = order[j]
            while stack and spans[stack[-1]][1] <= spans[s][0]:
                stack.pop()
            stack.append(s)
            j += 1
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        out.append(stack[-1] if stack else -1)
    return out


def _locate(spans, by_thread, queries, own_thread=True):
    """For each query (time, thread): the innermost span open on the
    query's thread at that time (unless not ``own_thread``), else the
    latest-starting of the innermost spans open on the other threads; -1
    where none is open."""
    order = sorted(range(len(queries)), key=lambda q: queries[q][0])
    times = [queries[q][0] for q in order]
    found = {tid: _innermost(spans, idx, times) for tid, idx in by_thread.items()}
    out = [-1] * len(queries)
    for k, q in enumerate(order):
        t, tid = queries[q]
        mine = found.get(tid) if own_thread else None
        if mine is not None and mine[k] != -1:
            out[q] = mine[k]
            continue
        best = -1
        for other, hits in found.items():
            s = hits[k]
            if other != tid and s != -1 and (best == -1 or spans[s][0] > spans[best][0]):
                best = s
        out[q] = best
    return out


def read(events, units: int) -> Fold:
    """The fold of one profile's kineto events over ``units`` units."""
    spans, calls, ops = [], {}, []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                ops.append((e.start_ns(), e.end_ns(), e.correlation_id()))
        elif name.startswith(PREFIX):
            spans.append((e.start_ns(), e.end_ns(), e.start_thread_id(), name))
        elif name.startswith("cu"):  # cudaLaunchKernel, cuLaunchKernel, cudaMemcpyAsync, ...
            calls[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
    fold = Fold(units=units)
    by_thread = defaultdict(list)
    for i in sorted(range(len(spans)), key=lambda i: (spans[i][0], -spans[i][1])):
        by_thread[spans[i][2]].append(i)

    # each span's parent: the innermost span open at its start, on its own
    # thread first (a span starting with its parent is listed after it)
    parent = [-1] * len(spans)
    for tid, idx in by_thread.items():
        stack = []
        for i in idx:
            while stack and spans[stack[-1]][1] <= spans[i][0]:
                stack.pop()
            parent[i] = stack[-1] if stack else -1
            stack.append(i)
    orphans = [i for i in range(len(spans)) if parent[i] == -1]
    for i, p in zip(orphans, _locate(spans, by_thread, [(spans[i][0], spans[i][2])
                                                        for i in orphans], own_thread=False)):
        parent[i] = p

    # each device operation to the span its launching call was made in
    dev_ms, launched = [0.0] * len(spans), [0] * len(spans)
    matched, queries = [], []
    for start, end, corr in ops:
        call = calls.get(corr)
        if call is None:
            fold.unmatched_ms += (end - start) * 1e-6
        else:
            matched.append((end - start) * 1e-6)
            queries.append(call)
    for ms, s in zip(matched, _locate(spans, by_thread, queries)):
        if s == -1:
            fold.outside_ms += ms
        else:
            dev_ms[s] += ms
            launched[s] += 1

    # the device's busy intervals, and its idle gaps by the span open at their middle
    busy = []
    for lo, hi, _ in sorted(ops):
        if busy and lo <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], hi)
        else:
            busy.append([lo, hi])
    fold.busy_ms = sum(hi - lo for lo, hi in busy) * 1e-6
    starts, ends, done = [b[0] for b in busy], [b[1] for b in busy], [0.0]
    for lo, hi in busy:
        done.append(done[-1] + (hi - lo))

    def busy_before(t):
        k = bisect.bisect_right(starts, t)
        if k and ends[k - 1] > t:
            return done[k - 1] + (t - starts[k - 1])
        return done[k]

    gaps = [((a + b) // 2, b - a) for a, b in zip(ends, starts[1:])]
    for (_, ns), s in zip(gaps, _locate(spans, by_thread, [(t, None) for t, _ in gaps])):
        key = NO_SPAN if s == -1 else spans[s][3]
        fold.idle_by_span[key] = fold.idle_by_span.get(key, 0.0) + ns * 1e-6

    # roll each span's device time up to its ancestors (children first: a
    # child starts after its parent, or with it and ends sooner)
    children = defaultdict(list)
    nerf = [spans[i][3] == NERF for i in range(len(spans))]
    for i in sorted(range(len(spans)), key=lambda i: (-spans[i][0], spans[i][1])):
        p = parent[i]
        if p == -1:
            fold.top_ms += dev_ms[i]
            continue
        dev_ms[p] += dev_ms[i]
        launched[p] += launched[i]
        nerf[p] = nerf[p] or nerf[i]
        children[p].append(i)
    for i, (lo, hi, _, name) in enumerate(spans):
        covered, reach = 0, lo
        for c_lo, c_hi, _, _ in sorted(spans[c] for c in children[i]):
            c_lo, c_hi = max(c_lo, reach), min(c_hi, hi)
            if c_hi > c_lo:
                covered += c_hi - c_lo
                reach = c_hi
        s = fold.spans.setdefault(name, Span())
        s.calls += 1
        s.host_ms += (hi - lo) * 1e-6
        s.self_ms += (hi - lo - covered) * 1e-6
        s.device_ms += dev_ms[i]
        s.launches += launched[i]
        s.idle_ms += ((hi - lo) - (busy_before(hi) - busy_before(lo))) * 1e-6
        if name == STEP and not nerf[i]:
            fold.steps.append(((hi - lo) * 1e-6, dev_ms[i], launched[i]))
    return fold


def roofline(ctx, groups, names):
    """Share of the roofline of the op wrappers ``groups`` {counter: bound
    function}: the least time of the launches they counted in the fold's
    units over the device time of the spans ``names``, %."""
    fold = of(ctx)
    device_ms = sum(fold.spans[n].device_ms for n in names if n in fold.spans)
    least_s = sum(fn(*key) * count for counter, fn in groups.items()
                  for key, count in fold.launches.get(counter, {}).items())
    if fold.busy_ms <= 0.0 or least_s <= 0.0 or device_ms <= 0.0:
        return None
    return 100.0 * least_s * 1e3 / device_ms
