"""The cached UNet evaluation replayed as piecewise CUDA graphs
(``utils/graphs.py``): the policy.

After the render step, ``Engine.sample`` evaluates the same network on the
same shapes at every step (steps 1-49 of a 50-step Euler image): only the
latent, the timesteps and the guider's conditioning change. On the card such
an evaluation is about 2450 small launches, and the host's time to make
them is most of the step. ``CachedUNetGraphs``, one per ``Engine``,
captures that evaluation once per shape and replays it; the pool is freed
with the ``Engine``.

Splits: the two counted attention wrappers, ``attention_fwd`` and
``attention_bnhd_fwd``, and no span. Everything else of the evaluation is
replayed: the norms, the GEMMs, the 77-key text cross-attention, the pose
blocks' fuse, the resblocks.

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
evaluation runs the network as it is. A capture is keyed on the tensors'
paths, shapes, strides, dtypes and devices of a step's and a request's
inputs, the build's settings and ``CD360_ATTN_BNHD``. A new key runs once
eagerly (so its kernels load and its libraries set up outside any capture),
is captured at its next evaluation, and replays from then on; no capture
runs while a profiler traces.

``evaluations`` counts the cached-phase evaluations on the card by how they
ran: "capture", "replay", "eager".
"""
from __future__ import annotations

import os
from collections import Counter

import torch

from ..ops import block_attention
from ..parallel import tp
from ..utils.graphs import Segments, copy_into, static, tensors
from . import nerf
from .transformer import fuse_attention_params

evaluations = Counter()  # "capture" / "replay" / "eager" -> cached-phase evaluations on the card
SPLITS = frozenset({block_attention.attention_fwd, block_attention.attention_bnhd_fwd})


def engages(device, nerf_caches, group=None) -> bool:
    """Whether a cached-phase evaluation runs as graphs: on a CUDA device,
    with autograd off, in the cached phase (``nerf_caches`` given), and with
    no process group in the call: ``group`` (the call's cfg or view group),
    a ``tp.tensor_parallel`` or ``nerf.view_sharded`` context."""
    return (torch.device(device).type == "cuda" and not torch.is_grad_enabled()
            and nerf_caches is not None and group is None
            and tp.model_group() is None and nerf.view_group() is None)


def _spec(tree) -> tuple:
    """What a capture is keyed on: each tensor leaf's path, shape, strides,
    dtype and device."""
    return tuple((p, tuple(t.shape), t.stride(), t.dtype, t.device) for p, t in tensors(tree))


def _addresses(tree) -> tuple:
    return tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype) for _, t in tensors(tree))


class _Graphs(Segments):
    """The graphs of one key: the static inputs (a step's, a request's), the
    parameters' addresses at capture and the output in graph memory."""

    def __init__(self, step, request, params):
        super().__init__(SPLITS)
        self.step, self.request, self.params = static(step), static(request), params
        self.out = self.aux = None


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
                copy_into(graphs.request, net.request)
                net.bound = graphs
        if graphs is None:
            if key not in self._warm or torch.autograd._profiler_enabled():
                self._warm.add(key)
                evaluations["eager"] += 1
                return net.eager(x, t, cond)
            graphs = _Graphs(step, net.request, net.addresses())
            network = net.build(*graphs.request)
            graphs.out, graphs.aux = graphs.capture(lambda: network(*graphs.step))
            self._graphs[key] = net.bound = graphs
            evaluations["capture"] += 1
        else:
            copy_into(graphs.step, step)
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
