"""Piecewise CUDA-graph replay of the cached UNet evaluation.

After the render step, ``Engine.sample`` evaluates the same network on the
same shapes at every step (steps 1-49 of a 50-step Euler image): only the
latent, the timesteps and the guider's conditioning change. On the card such
an evaluation is about 2450 small launches, and the host's time to make
them is most of the step. ``CachedUNetGraphs``, one per ``Engine``,
captures that evaluation once per shape into CUDA graphs and replays them.

The capture is split at the two counted attention wrappers
(``ops/block_attention.py``: ``attention_fwd``, ``attention_bnhd_fwd``):
the hand-written attention kernels run eagerly between the replayed
segments, inside their span ``cd360.op.attention`` and counted as ever,
reading q/k/v where the previous segment left them and writing into the
buffer the next segment was captured to read (their ``out=``). Everything
else of the evaluation is replayed: the norms, the GEMMs, the 77-key text
cross-attention, the pose blocks' fuse, the resblocks. The segments share
one memory pool, which the graphs own with their static buffers; so it is
freed with the ``Engine``.

Inputs. A step's (the scaled latent, c_noise, the conditioning tensors) are
copied into static buffers before each replay, a request's (the text K/V
``ctx_kv`` and the render caches ``nerf_caches``) once a request. No step
value reaches a kernel as a Python number. The parameters are read where
they lie: the fused q/k/v leaves keep their addresses from call to call
(``fuse`` writes them into buffers kept here), and the leaves' addresses
are checked once a request against the capture's, a mismatch capturing
again; an in-place change to a leaf is seen by the next replay. The
network's output is copied out of graph memory, so no caller holds a buffer
that a later replay overwrites. The cached phase's aux holds no tensor.

When. ``engages``: a CUDA device, autograd off, the cached phase, and no
process group in the call (cfg, view or tensor-parallel). Every other
evaluation runs the network as it is. A new shape runs once eagerly (so its
kernels load and its libraries set up outside any capture), is captured at
its next evaluation, and replays from then on; no capture runs while a
profiler traces.

``evaluations`` counts the cached-phase evaluations on the card by how they
ran: "capture", "replay", "eager". A replay also credits the op wrappers'
``launches_by_shape`` with the launches that its segments captured, so those
counters still count every launch of the program.
"""
from __future__ import annotations

import os
from collections import Counter

import torch

from ..ops import block_attention, conv3x3, norms, onehot_sample
from ..parallel import tp
from . import nerf
from .transformer import fuse_attention_params

evaluations = Counter()  # "capture" / "replay" / "eager" -> cached-phase evaluations on the card


def _counted():
    """The op wrappers that count their launches by shape."""
    return (block_attention.attention_fwd, block_attention.attention_bnhd_fwd,
            norms.layer_norm_fused, norms.group_norm_fused, conv3x3.conv3x3_fwd,
            onehot_sample.bilinear_sample, onehot_sample.bilinear_sample_bwd)


def engages(device, nerf_caches, group=None) -> bool:
    """Whether a cached-phase evaluation runs as graphs: on a CUDA device,
    with autograd off, in the cached phase (``nerf_caches`` given), and with
    no process group in the call: ``group`` (the call's cfg or view group),
    a ``tp.tensor_parallel`` or ``nerf.view_sharded`` context."""
    return (torch.device(device).type == "cuda" and not torch.is_grad_enabled()
            and nerf_caches is not None and group is None
            and tp._MODEL_GROUP is None and nerf._VIEW_GROUP is None)


def _flat(tree, path=()):
    """(path, tensor) of every tensor leaf of a tree of dicts, lists and
    tuples, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (i,))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def _spec(tree) -> tuple:
    """What a capture is keyed on: each leaf's path, shape, strides, dtype
    and device."""
    return tuple((p, tuple(t.shape), t.stride(), t.dtype, t.device) for p, t in _flat(tree))


def _addresses(tree) -> tuple:
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype) for _, t in _flat(tree))


def _static(tree):
    """A copy of a tree whose tensors have the same shapes and strides."""
    if isinstance(tree, dict):
        return {k: _static(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_static(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tree.shape, tree.stride(), dtype=tree.dtype,
                                   device=tree.device).copy_(tree)
    return tree


def _copy_into(static, tree):
    for (_, dst), (_, src) in zip(_flat(static), _flat(tree)):
        dst.copy_(src)


class _Graphs:
    """The graphs of one shape: the segments, the eager attention calls
    between them, the static inputs (a step's, a request's) and the output
    in graph memory."""

    def __init__(self, step, request, params):
        self.step, self.request, self.params = _static(step), _static(request), params
        self.segments, self.calls, self.credit = [], [], {}
        self.pool = self.out = self.aux = None
        self._graph = self._before = None

    def capture(self, build):
        """Capture ``build(*request)(*step)``, a segment at each attention
        call, replaying each segment once as it ends so that the attention
        between them reads real values: this call's evaluation."""
        network = build(*self.request)
        torch.cuda.synchronize()
        self.pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            try:
                self._begin()
                block_attention.capture_split = self._split
                self.out, self.aux = network(*self.step)
                block_attention.capture_split = None
                self._end()
            except BaseException:
                block_attention.capture_split = None
                if self._graph is not None:
                    try:
                        self._graph.capture_end()
                    except RuntimeError:
                        pass
                raise
        torch.cuda.current_stream().wait_stream(stream)

    def _begin(self):
        self._before = {fn: Counter(fn.launches_by_shape) for fn in _counted()}
        self._graph = torch.cuda.CUDAGraph()
        self._graph.capture_begin(pool=self.pool)

    def _end(self):
        graph, self._graph = self._graph, None
        graph.capture_end()
        for fn, before in self._before.items():
            launched = Counter(fn.launches_by_shape) - before
            if launched:
                self.credit.setdefault(fn, Counter()).update(launched)
        graph.replay()
        self.segments.append(graph)

    def _split(self, wrapper, *args):
        """``block_attention.capture_split``: end the segment, launch the
        attention eagerly, begin the next segment."""
        self._end()
        block_attention.capture_split = None
        try:
            out = wrapper(*args)
        finally:
            block_attention.capture_split = self._split
        self.calls.append((wrapper, args, out))
        self._begin()
        return out

    def replay(self):
        for i, graph in enumerate(self.segments):
            graph.replay()
            if i < len(self.calls):
                wrapper, args, out = self.calls[i]
                wrapper(*args, out=out)
        for fn, launched in self.credit.items():
            fn.launches_by_shape.update(launched)


class CachedUNetGraphs:
    """An ``Engine``'s graphs of its cached UNet evaluation, one set a
    shape, and the fused q/k/v leaves they read."""

    def __init__(self):
        self.fused = {}  # fuse_attention_params' buffers: path -> tensor
        self._graphs = {}  # key -> _Graphs
        self._warm = set()  # keys evaluated eagerly once

    def fuse(self, unet_params):
        """``fuse_attention_params`` into the fused leaves kept here."""
        return fuse_attention_params(unet_params, self.fused)

    def network(self, build, params, nerf_caches, ctx_kv, group=None, settings=()):
        """One request's cached network, network(x, t, cond) -> (eps, aux).
        ``build(nerf_caches, ctx_kv)`` makes the network as it runs eagerly
        (the result's ``eager``); ``params`` is the parameter tree it reads,
        ``group`` the call's process group, ``settings`` whatever else of the
        build a capture is keyed on."""
        return _CachedNetwork(self, build, params, nerf_caches, ctx_kv, group, settings)

    def _run(self, net, x, t, cond):
        step = (x, t, cond)
        key = (_spec(step), net.request_spec, net.settings,
               os.environ.get("CD360_ATTN_BNHD", ""))
        graphs = self._graphs.get(key)
        if graphs is not None and net.bound is not graphs:
            if graphs.params != net.addresses():
                torch.cuda.synchronize()
                del self._graphs[key]
                graphs = None
            else:
                _copy_into(graphs.request, net.request)
                net.bound = graphs
        if graphs is None:
            if key not in self._warm or torch.autograd._profiler_enabled():
                self._warm.add(key)
                evaluations["eager"] += 1
                return net.eager(x, t, cond)
            graphs = _Graphs(step, net.request, net.addresses())
            graphs.capture(net.build)
            self._graphs[key] = net.bound = graphs
            evaluations["capture"] += 1
        else:
            _copy_into(graphs.step, step)
            graphs.replay()
            evaluations["replay"] += 1
        return graphs.out.clone(), graphs.aux


class _CachedNetwork:
    """network(x, t, cond) of one request's cached phase: graphs where
    ``engages``, else ``eager``, the network as built."""

    def __init__(self, owner, build, params, nerf_caches, ctx_kv, group, settings):
        self.owner, self.build, self.params = owner, build, params
        self.request = (nerf_caches, ctx_kv)
        self.request_spec = _spec(self.request)
        self.group, self.settings = group, settings
        self.eager = build(nerf_caches, ctx_kv)
        self.bound = None  # the graphs this request's inputs were copied into
        self._addresses = None

    def addresses(self):
        if self._addresses is None:
            self._addresses = _addresses(self.params)
        return self._addresses

    def __call__(self, x, t, cond, **kwargs):
        if x.device.type != "cuda":
            return self.eager(x, t, cond, **kwargs)
        if kwargs or not engages(x.device, self.request[0], self.group):
            evaluations["eager"] += 1
            return self.eager(x, t, cond, **kwargs)
        return self.owner._run(self, x, t, cond)
