"""Device-mesh helpers: the port's counterparts of the JAX package's
``parallel/mesh.py``.

The JAX package shards the global batch over a ``data`` mesh axis and lets
XLA insert the gradient psum. The port runs one process per card (NCCL on
CUDA, gloo on the CPU) over a 1-D ``torch.distributed`` device mesh named
``data``; each rank keeps its own rows of the global batch and
DistributedDataParallel (or fully_shard) averages the gradients.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist


class RankLocal(tuple):
    """A batch that already holds this rank's rows (what each process's
    loader yields under the launcher); ``shard_batch`` passes it through."""


def make_mesh(device_type: Optional[str] = None):
    """A 1-D DeviceMesh over the default process group's ranks, its one axis
    named ``data``. The process group must exist (``launch.init_distributed``).
    device_type: "cuda" when the backend is NCCL, else "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "launch.init_distributed first")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=("data",))


def data_sharding(mesh, axis: int = 0):
    """DTensor placements that shard tensor axis `axis` over the mesh."""
    from torch.distributed.tensor import Shard

    return [Shard(axis)]


def replicated(mesh):
    """DTensor placements of a tensor every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return [Replicate()]


def shard_batch(mesh, batch, axis: int = 0):
    """This rank's rows of a global host batch: each array split into
    equal contiguous blocks along `axis`, one per rank in rank order (the
    JAX package's ``NamedSharding`` over ``data``). No mesh: the batch
    itself. A ``RankLocal`` batch is already this rank's."""
    if mesh is None or isinstance(batch, RankLocal):
        return tuple(batch) if isinstance(batch, RankLocal) else batch
    group = mesh.get_group()
    n, rank = dist.get_world_size(group), dist.get_rank(group)

    def rows(x):
        size = x.shape[axis]
        if size % n:
            raise ValueError(f"batch axis {axis} of size {size} does not split "
                             f"over {n} ranks")
        k = size // n
        idx = [slice(None)] * x.ndim
        idx[axis] = slice(rank * k, (rank + 1) * k)
        return x[tuple(idx)]

    if isinstance(batch, (tuple, list)):
        return type(batch)(rows(x) for x in batch)
    return rows(batch)

