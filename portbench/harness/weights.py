"""Seeded random weights, made on the device in a few large calls.

The tree's layout and each leaf's initializer come from the reference's
own init functions run against a recording ``Init`` on the meta device (no
memory, no draws). The leaves are then laid out in one flat buffer per
call, grouped by initializer, and each group is filled by a handful of
large ``torch.rand`` / ``torch.randn`` calls on a generator on the card,
in the type the weights are served in. A leaf is a view of that buffer.

Initializers: Kaiming-uniform U(-b, b) and N(0, std^2) as the port's init
draws them; ones for norm scales; the identity for the pose embedding
layers; and every leaf the port initializes to zero (output convs,
``proj_out``, the NeRF decoder, norm biases, the V* rows) is drawn from
N(0, 0.02^2) instead, so that a random UNet's eps is not identically 0.
"""
from __future__ import annotations

import contextlib
import sys

import torch
from torch.overrides import TorchFunctionMode

CHUNK = 1 << 26  # elements drawn per call
ALIGN = 256  # bytes: every leaf starts where an allocation of its own would


class _Recorder:
    """Duck-types the reference's ``models.nn.Init`` on the meta device and
    notes each leaf's initializer."""

    def __init__(self, kinds, dtype):
        self.device = torch.device("meta")
        self.dtype = dtype
        self.kinds = kinds

    def _leaf(self, shape, kind):
        t = torch.empty(tuple(shape), device="meta", dtype=self.dtype)
        self.kinds[id(t)] = (t, kind)
        return t

    def uniform(self, shape, bound):
        return self._leaf(shape, ("uniform", float(bound), 0.0, False))

    def normal(self, shape, std):
        return self._leaf(shape, ("normal", float(std), 0.0, False))

    def zeros(self, shape):
        return self._leaf(shape, ("normal", 0.02, 0.0, False))

    def ones(self, shape):
        return self._leaf(shape, ("const", 1.0, 0.0, False))

    def eye(self, shape):
        return self._leaf(shape, ("eye", 1.0, 0.0, False))


class _StackKinds(TorchFunctionMode):
    """A stack or concatenation of leaves of one initializer (the CLIP
    towers' layer-stacked blocks) is a leaf of that initializer; a
    ``torch.full`` (the autoencoder's ``logvar``) is a constant; a draw
    plus a number (the PatchGAN's BatchNorm scales, 1 + N(0, 0.02^2)) or
    its absolute value (the LPIPS heads) is noted as such."""

    def __init__(self, kinds):
        super().__init__()
        self.kinds = kinds

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.full:
            self.kinds[id(out)] = (out, ("const", float(args[1]), 0.0, False))
        elif (func in (torch.Tensor.__add__, torch.Tensor.add) and id(args[0]) in self.kinds
              and isinstance(args[1], (int, float))):
            what, scale, shift, absolute = self.kinds[id(args[0])][1]
            self.kinds[id(out)] = (out, (what, scale, shift + float(args[1]), absolute))
        elif func in (torch.Tensor.abs, torch.abs) and id(args[0]) in self.kinds:
            what, scale, shift, _ = self.kinds[id(args[0])][1]
            if shift:
                raise ValueError("abs of a shifted draw")
            self.kinds[id(out)] = (out, (what, scale, 0.0, True))
        elif func in (torch.stack, torch.cat) and args:
            got = {self.kinds[id(t)][1] for t in args[0] if id(t) in self.kinds}
            if len(got) == 1 and all(id(t) in self.kinds for t in args[0]):
                self.kinds[id(out)] = (out, got.pop())
        return out


@contextlib.contextmanager
def recording_init(kinds, dtype):
    """Within: every reference module's ``Init(seed, device, dtype)`` makes
    a recorder."""
    mods = [m for name, m in list(sys.modules.items())
            if name.startswith("cd360ref.") and hasattr(m, "Init")]
    saved = [m.Init for m in mods]

    def make(*args, **kwargs):
        return _Recorder(kinds, dtype)

    for m in mods:
        m.Init = make
    try:
        with _StackKinds(kinds):
            yield
    finally:
        for m, old in zip(mods, saved):
            m.Init = old


def _walk(tree, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn) for v in tree]
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


def leaves(tree):
    out = []
    _walk(tree, out.append)
    return out


def paths(tree, prefix=""):
    """The leaves' paths ("unet/input_blocks/1/0/w"), in ``leaves`` order."""
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in paths(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]] if isinstance(tree, torch.Tensor) else []


def meta_tree(init_fn, dtype):
    """(tree of meta tensors, {id: kind}) of ``init_fn()``, a reference init
    call (its device and dtype arguments are ignored)."""
    kinds = {}
    with recording_init(kinds, dtype):
        tree = init_fn()
    for t in leaves(tree):
        if id(t) not in kinds:
            raise ValueError(f"a leaf of shape {tuple(t.shape)} has no recorded initializer")
    return tree, kinds


def _fill(seg, kind, gen):
    what, scale, shift, absolute = kind
    if what == "const":
        seg.fill_(scale)
        return
    if what == "eye":
        seg.zero_()
        return
    for lo in range(0, seg.numel(), CHUNK):
        n = min(CHUNK, seg.numel() - lo)
        if what == "uniform":
            t = torch.rand(n, generator=gen, device=seg.device).mul_(2 * scale).sub_(scale)
        else:
            t = torch.randn(n, generator=gen, device=seg.device).mul_(scale)
        if absolute:
            t.abs_()
        seg[lo:lo + n].copy_(t.add_(shift))


def materialize(tree, kinds, seed: int, device, dtype):
    """The tree with every meta leaf replaced by a seeded view of one flat
    ``dtype`` buffer on ``device``, each leaf ALIGN-byte aligned (the
    port's norm kernels read their scale and bias in 16-byte vectors)."""
    metas = leaves(tree)
    groups = {}
    for t in metas:
        groups.setdefault(kinds[id(t)][1], []).append(t)
    step = ALIGN // torch.empty((), dtype=dtype).element_size()

    def padded(n):
        return -(-n // step) * step

    total = sum(padded(t.numel()) for t in metas)
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    made, offset = {}, 0
    for kind in sorted(groups):
        n = sum(padded(t.numel()) for t in groups[kind])
        _fill(flat[offset:offset + n], kind, gen)
        for t in groups[kind]:
            view = flat[offset:offset + t.numel()].view(t.shape)
            if kind[0] == "eye":
                view.diagonal().fill_(1.0)
            made[id(t)] = view
            offset += padded(t.numel())
    return _walk(tree, lambda t: made[id(t)])


def make(init_fn, seed: int, device, dtype):
    """Seeded weights with the layout ``init_fn()`` gives (a reference init
    call), made on ``device`` in ``dtype``."""
    tree, kinds = meta_tree(init_fn, dtype)
    return materialize(tree, kinds, seed, device, dtype)


def to_float(tree):
    """The same tree in float32 (the reference's copy of the weights)."""
    return _walk(tree, lambda t: t.float() if t.is_floating_point() else t)
