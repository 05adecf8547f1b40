"""Data parallelism over ``torch.distributed`` (the port's counterpart of
``lintransunet_tpu/parallel``)."""

from lintransunet_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    all_reduce_mean,
    distributed_requested,
    make_mesh,
    rank_seed,
    replicate,
    shard_batch,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "distributed_requested",
    "rank_seed",
    "replicate",
    "shard_batch",
    "all_reduce_mean",
    "all_reduce_sum",
]
