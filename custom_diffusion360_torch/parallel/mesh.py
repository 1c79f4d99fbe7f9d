"""Process groups, rank gates and the collectives of data parallelism (port
of custom_diffusion360_tpu/parallel/mesh.py on ``torch.distributed``).

The JAX package runs one SPMD program over a device mesh, and XLA inserts
the collectives. The port runs one process per card (started by
``torchrun`` or by ``--coordinator/--num_processes/--process_id``) and
calls each collective itself: NCCL on the card, gloo on the CPU.

``make_mesh`` has no counterpart: in a process-per-card world the data
axis is the process group, and ``world_size()`` gives its size. Each rank
holds its LOCAL batch rows; the global batch is the local rows
concatenated in rank order (``shard_batch`` cuts a global batch that every
rank holds the same way). Parameters must be equal on every rank
(``replicate`` broadcasts rank 0's and checks that they were). A failed
collective raises; nothing carries on alone.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from .. import resolve_device

# a lost peer fails a collective after this long instead of hanging the run
# (the two-rank tests shorten it)
DEFAULT_TIMEOUT_S = 600.0
# replicate's broadcast and check go through flat buffers of at most this size
_BUCKET_BYTES = 256 << 20


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device="cuda") -> torch.device:
    """Join the process group; returns this rank's device.

    ``coordinator`` ("host:port") with ``num_processes`` and ``process_id``
    gives the rendezvous explicitly (tcp://); without them torchrun's
    environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE) is read
    (env://). The backend is NCCL for a CUDA ``device`` and gloo otherwise;
    on CUDA the rank binds cuda:<LOCAL_RANK> (else the rank modulo the
    card count). A collective waits DEFAULT_TIMEOUT_S for a lost rank,
    then fails. A group that is already up is reused if its backend
    matches."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", -1))
        if local < 0:
            r = process_id if process_id is not None else int(os.environ.get("RANK", 0))
            local = r % torch.cuda.device_count()
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} process group is up; {backend} needed "
                               f"for device {dev}")
        return dev
    timeout = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S)
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator needs --num_processes and --process_id")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id, timeout=timeout)
    else:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    if backend == "nccl":
        # bind the communicator to this card now: the first collective
        # otherwise guesses the device
        dist.barrier(device_ids=[dev.index])
    return dev


def rank(group=None) -> int:
    """This process's rank in ``group`` (the world by default); 0 without a
    process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def world_size(group=None) -> int:
    """The size of ``group`` (the world by default); 1 without a process
    group. The data-parallel width: where the JAX package reads
    ``jax.device_count()``."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def is_main_process() -> bool:
    """The rank-0 gate of every write (the reference's @rank_zero_only)."""
    return rank() == 0


def _split_rows(x, r: int, n: int):
    if isinstance(x, torch.Tensor) and x.dim() == 0:
        return x
    rows = x.shape[0]
    if rows % n:
        raise ValueError(f"a leading axis of {rows} rows does not split over {n} ranks")
    k = rows // n
    return x[r * k:(r + 1) * k]


def shard_batch(batch, group=None):
    """This rank's rows of a global batch that every rank holds: each leaf's
    leading axis cut into ``world_size`` equal parts, part ``rank`` kept
    (0-dim tensors stay whole; None stays None). Leaves with
    sample-major rows (the ``*_ref`` rows, B * N) split the same way. The
    global batch is then the local rows concatenated in rank order, as the
    JAX package assembles it from each process's rows."""
    r, n = rank(group), world_size(group)

    def cut(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if hasattr(x, "_fields"):  # Cameras and other named tuples of tensors
            return type(x)(*(cut(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(cut(v) for v in x)
        if isinstance(x, (torch.Tensor,)) or hasattr(x, "shape"):
            return _split_rows(x, r, n)
        return x

    return cut(batch)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _buckets(tensors, limit=_BUCKET_BYTES):
    """Runs of same-dtype, same-device tensors of at most ``limit`` bytes
    together (a larger tensor is a run of its own; None: no limit)."""
    run, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if run and (t.dtype != run[0].dtype or t.device != run[0].device
                    or (limit is not None and size + nbytes > limit)):
            yield run
            run, size = [], 0
        run.append(t)
        size += nbytes
    if run:
        yield run


@torch.no_grad()
def replicate(tree, group=None):
    """Make every tensor leaf of ``tree`` equal to rank 0's, in place (a
    broadcast from rank 0, in flat buckets), and raise on every rank when
    any rank held other values before: parameters must come out of the same
    seeded init or the same checkpoint on every rank, as the JAX package
    requires. Returns ``tree``."""
    src = dist.get_global_rank(group, 0) if group is not None else 0
    differs = None
    for run in _buckets(list(_leaves(tree))):
        flat = torch.cat([t.detach().reshape(-1) for t in run])
        mine = flat.clone()
        dist.broadcast(flat, src, group=group)
        d = torch.ne(mine, flat).any().to(torch.int32).reshape(1)
        differs = d if differs is None else torch.maximum(differs, d)
        off = 0
        for t in run:
            n = t.numel()
            t.detach().copy_(flat[off:off + n].view_as(t))
            off += n
    if differs is not None:
        dist.all_reduce(differs, op=dist.ReduceOp.MAX, group=group)
        if int(differs.item()):
            raise RuntimeError("replicate: the ranks held different values; parameters must "
                               "come from the same seed or checkpoint on every rank")
    return tree


@torch.no_grad()
def all_reduce_mean(tensors, group=None):
    """Replace each tensor by its mean over the ranks of ``group``, in
    place: one flat all-reduce (sum) per run of same-dtype tensors, then a
    division by the group size. Returns the list. In a world of one the
    values do not change."""
    tensors = list(tensors)
    n = world_size(group)
    for run in _buckets(tensors, limit=None):
        flat = torch.cat([t.reshape(-1) for t in run])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        off = 0
        for t in run:
            k = t.numel()
            t.copy_(flat[off:off + k].view_as(t))
            off += k
    return tensors


def all_gather_rows(x, group=None):
    """The ranks' ``x`` concatenated along axis 0 in rank order (every rank
    passes the same shape)."""
    parts = [torch.empty_like(x) for _ in range(world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)


def barrier(group=None):
    """Wait for every rank of ``group`` (NCCL: on this rank's card)."""
    if dist.get_backend(group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)
