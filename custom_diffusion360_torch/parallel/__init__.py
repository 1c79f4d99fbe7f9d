"""Parallelism on ``torch.distributed`` (port of custom_diffusion360_tpu/
parallel/): one process per card, explicit collectives.

Data parallelism: every rank holds the same parameters (``replicate``) and
its own batch rows (``shard_batch``); ``Trainer`` all-reduces the gradient
mean over the ranks right after the backward (``all_reduce_mean``). The
JAX package's single SPMD program over a mesh, with XLA's collectives,
becomes one program per rank with NCCL (on the card) or gloo (on the CPU).
Latency sharding of sampling (``Engine.sample(cfg_group=)``), view-sharded
capture (``capture_references(view_group=)``) and tensor parallelism
(``tp``) use the same process groups.
"""
from .mesh import (
    all_gather_rows,
    all_reduce_mean,
    barrier,
    init_distributed,
    is_main_process,
    rank,
    replicate,
    shard_batch,
    world_size,
)
from .tp import (
    shard_params_tp,
    tensor_parallel,
    tp_param_specs,
)
