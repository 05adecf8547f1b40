"""Data parallelism over ``torch.distributed`` (port of
``lintransunet_tpu/parallel/mesh.py``).

The reference distributes with single-process ``nn.DataParallel``
(train3D.py:119); the JAX package with SPMD over a ``jax.sharding.Mesh``,
where XLA inserts the gradient psum. Here one process drives one card, as
``torchrun`` starts them, and the collectives are explicit:

* ``make_mesh`` joins (or, from ``torchrun``'s environment, forms) the
  process group and names this rank's device;
* ``shard_batch`` gives this rank its contiguous slice of a global batch;
* ``replicate`` makes every rank's parameters and buffers rank 0's;
* ``all_reduce_mean`` averages gradients, losses and logs in one bucket
  (``engine.make_train_step(..., mesh=)``);
* ``all_reduce_sum`` sums, and so gathers what each rank wrote of a
  zero-filled buffer (``SlidingWindowRunner.run_batch``).

``batch_sharding`` and ``data_parallel_jit`` have no meaning here: they are
jit shardings, and a rank holds its shard as an ordinary tensor.

NCCL serves CUDA devices and gloo the CPU. gloo also runs ``all_reduce`` and
``broadcast`` on CUDA tensors (not ``all_gather``), which lets two ranks
share one card, as NCCL refuses: every collective here is one of those two.
A group that fails to form raises; nothing falls back to one process.
"""

import dataclasses
import os
from typing import Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1D data-parallel mesh over the default process group: this
    process's rank in it, its size and this rank's device."""

    rank: int
    size: int
    device: torch.device


def distributed_requested() -> bool:
    """True under ``torchrun`` with more than one process (``WORLD_SIZE``
    > 1), or inside a process group that the caller initialised."""
    return dist.is_available() and (
        dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) > 1)


def _rank_device(device: Union[str, torch.device]) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def make_mesh(n_devices: Optional[int] = None,
              device: Union[str, torch.device] = "cuda") -> Mesh:
    """This rank's mesh over the default process group: the one the caller
    initialised, or one formed from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) on NCCL for a CUDA
    ``device`` and gloo for the CPU. ``device`` "cuda" means
    ``cuda:LOCAL_RANK``, which becomes the current CUDA device.
    ``n_devices``, if given, must be the group's size."""
    device = _rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"the process group has {size} ranks, not {n_devices}")
    return Mesh(dist.get_rank(), size, device)


def rank_seed(seed: int, mesh: Optional[Mesh]) -> int:
    """The seed of this rank's own random stream, from (seed, rank); ``seed``
    itself without a mesh, so that one process draws as it always did."""
    if mesh is None:
        return seed
    return int(np.random.SeedSequence((seed, mesh.rank)).generate_state(1)[0])


def shard_batch(mesh: Mesh, batch) -> torch.Tensor:
    """This rank's contiguous slice of dim 0 of a global batch (a tensor or a
    numpy array) on its device; the batch must split evenly."""
    n = batch.shape[0]
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not split over {mesh.size} ranks")
    per = n // mesh.size
    part = batch[mesh.rank * per:(mesh.rank + 1) * per]
    if isinstance(part, np.ndarray):
        part = torch.from_numpy(np.ascontiguousarray(part))
    return part.to(mesh.device)


def _buckets(tensors: Sequence[torch.Tensor]):
    """The tensors grouped by dtype: [(dtype, [tensor, ...])]."""
    groups = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.items())


def replicate(mesh: Mesh, module: nn.Module) -> nn.Module:
    """Overwrite every rank's parameters and buffers with rank 0's, one
    broadcast per dtype."""
    with torch.no_grad():
        for _, group in _buckets(list(module.parameters()) + list(module.buffers())):
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.broadcast(flat, src=0)
            for t, part in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(part.view_as(t))
    return module


def all_reduce_mean(mesh: Mesh, tensors: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
    """Average each tensor over the group, in place: one flattened
    ``all_reduce`` per dtype."""
    with torch.no_grad():
        for _, group in _buckets(tensors):
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat)
            flat /= mesh.size
            for t, part in zip(group, flat.split([t.numel() for t in group])):
                t.copy_(part.view_as(t))
    return tensors


def all_reduce_sum(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """Sum ``tensor`` over the group, in place. It gathers, exactly, a buffer
    in which each rank wrote its own entries and left the others 0
    (x + 0 == x)."""
    dist.all_reduce(tensor)
    return tensor
