"""Tensor parallelism of the transformer projections (port of
custom_diffusion360_tpu/parallel/tp.py on ``torch.distributed``).

Megatron-style: column-parallel (output axis over the model group)
attention to_q / to_k / to_v (and the inference-fused to_qkv / to_kv) and
the GEGLU ff "proj"; row-parallel (input axis over the model group)
attention to_out and ff "out". Everything else (convs, norms, embeddings,
the NeRF MLPs) is replicated, and so is any leaf whose split dimension the
model-group size does not divide. ``tp_param_specs`` keeps the JAX
package's routing, with a spec written as a tuple: (None, "model") splits
the columns, ("model", None) the rows, ("model",) a column bias, () none.

The JAX package leaves the collectives to XLA. Here each rank holds its
local slices (``shard_params_tp``), the transformer runs on its local heads,
and every row-parallel product ends with one all-reduce over the model
group (``reduce_from_model``), summed in float32, the bias inside the
first rank's partial product (``bias_on_first``). The model
group is set around the forward with ``with tensor_parallel(group):``. A
packed weight is cut part by part: to_qkv as [q | k | v], to_kv as
[k | v] and the GEGLU proj as [a | gate], each part's columns split the
same way, so a rank's local to_qkv is [q_r | k_r | v_r].

In training the two autograd functions are Megatron's f and g: the input
of a column-parallel product all-reduces its gradient (``copy_to_model``),
the output of a row-parallel product all-reduces its value and passes its
gradient through.
"""
from __future__ import annotations

import contextlib
import torch
import torch.distributed as dist

_COL = {"to_q", "to_k", "to_v", "to_qkv", "to_kv"}  # + ff "proj"
_ROW = {"to_out"}  # + ff "out"
# packed column-parallel weights: how many parts each is a concatenation of
_PACKED = {"to_qkv": 3, "to_kv": 2, "proj": 2}

# the model group of the forward running inside ``tensor_parallel``: set
# and restored by that context manager alone, so the UNet's layers need no
# group argument
_MODEL_GROUP = None


def _names(path):
    return [p for p in path if isinstance(p, str)]


def _spec(path, leaf, n_model: int, axis: str = "model"):
    names = _names(path)
    if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0 or len(names) < 2:
        return ()
    name, last = names[-2], names[-1]
    parent = names[-3] if len(names) >= 3 else ""
    col = name in _COL or (name == "proj" and parent == "ff")
    row = name in _ROW or (name == "out" and parent == "ff")
    if last == "w" and leaf.dim() == 2:
        if col and leaf.shape[1] % n_model == 0:
            return (None, axis)
        if row and leaf.shape[0] % n_model == 0:
            return (axis, None)
    if last == "b" and leaf.dim() == 1 and col and leaf.shape[0] % n_model == 0:
        return (axis,)
    return ()


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def tp_param_specs(params, n_model: int):
    """The spec tree of a params tree (same structure): (None, "model")
    for a column-parallel weight, ("model", None) for a row-parallel one,
    ("model",) for a column-parallel bias, () for a replicated leaf,
    including every leaf whose split dimension ``n_model`` does not
    divide."""
    return _map_with_path(lambda p, x: _spec(p, x, n_model), params)


def _local(path, leaf, spec, rank: int, n_model: int):
    if not spec:
        return leaf
    names = _names(path)
    name, parent = names[-2], names[-3] if len(names) >= 3 else ""
    parts = _PACKED.get(name, 1) if name != "proj" or parent == "ff" else 1
    dim = 0 if spec[0] is not None else leaf.dim() - 1  # (axis,) is a bias: dim 0
    if parts > 1 and dim == leaf.dim() - 1:
        chunks = leaf.chunk(parts, dim=dim)
        if any(c.shape[dim] % n_model for c in chunks):
            raise ValueError(f"{'/'.join(names)}: a part of {chunks[0].shape[dim]} columns does "
                             f"not split over {n_model} ranks")
        return torch.cat([c.chunk(n_model, dim=dim)[rank] for c in chunks], dim=dim).contiguous()
    return leaf.chunk(n_model, dim=dim)[rank].contiguous()


def shard_params_tp(params, n_model: int, rank: int):
    """This rank's local params: each column-parallel leaf cut to its
    ``rank``-th column slice (a packed one part by part), each row-parallel
    weight to its row slice, everything else shared with ``params``.
    Attention LoRA adapters are not sharded and are refused."""
    specs = tp_param_specs(params, n_model)

    def walk(tree, spec, path=()):
        if isinstance(tree, dict):
            if "lora" in tree and any(spec[k].get("w") for k in _COL | _ROW if k in spec):
                raise NotImplementedError("tensor parallelism of attention LoRA adapters is not "
                                          "ported; merge them first (fuse_attention_params)")
            return {k: walk(v, spec[k], path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, s, path + (i,)) for i, (v, s) in enumerate(zip(tree, spec))]
        return _local(path, tree, spec, rank, n_model)

    return walk(params, specs)


@contextlib.contextmanager
def tensor_parallel(group):
    """Run the transformer's row-parallel products with an all-reduce over
    ``group`` (a process group, or ``dist.group.WORLD``) inside the block."""
    global _MODEL_GROUP
    prev = _MODEL_GROUP
    _MODEL_GROUP = group
    try:
        yield group
    finally:
        _MODEL_GROUP = prev


def model_group():
    """The active model group; None outside ``tensor_parallel``."""
    return _MODEL_GROUP


def model_size() -> int:
    """The size of the active model group; 1 outside ``tensor_parallel``."""
    return 1 if _MODEL_GROUP is None else dist.get_world_size(_MODEL_GROUP)


def is_split(local: int, full: int) -> bool:
    """Whether a dimension of ``full`` entries, held as ``local`` on this
    rank, is split over the active model group. It is when
    local * model_size == full; a leaf left whole (the split did not divide
    it) is not. Raises for local params outside ``tensor_parallel``."""
    if local == full and _MODEL_GROUP is None:
        return False
    if _MODEL_GROUP is None:
        raise RuntimeError("tensor-parallel params (a local slice of a projection) need "
                           "`with tensor_parallel(group):` around the forward")
    n = model_size()
    if local * n == full:
        return True
    if local == full:
        return False
    raise RuntimeError(f"a local slice of {local} of {full} does not match a model group of {n}")


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _BiasOnFirst(torch.autograd.Function):
    @staticmethod
    def forward(ctx, b, first):
        return b.view_as(b) if first else torch.zeros_like(b)

    @staticmethod
    def backward(ctx, g):
        return g, None


def bias_on_first(b):
    """A row-parallel product's bias as one rank's partial product takes it:
    the bias itself on the model group's first rank, zeros on the others, so
    the sum adds it once. Its gradient reaches every rank whole, as that of
    a bias added after the sum (Megatron's)."""
    return _BiasOnFirst.apply(b, dist.get_rank(_MODEL_GROUP) == 0)


def reduce_from_model(x):
    """The sum of the model group's partial products (g: all-reduce forward,
    identity backward)."""
    return _ReduceFromModel.apply(x, _MODEL_GROUP)


def copy_to_model(x):
    """The input of a column-parallel product (f: identity forward,
    all-reduce of the gradient backward). Identity when no gradient flows."""
    if not torch.is_grad_enabled() or not x.requires_grad:
        return x
    return _CopyToModel.apply(x, _MODEL_GROUP)
