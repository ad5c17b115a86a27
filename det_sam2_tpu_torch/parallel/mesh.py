"""Device-mesh helpers: the port's counterparts of the JAX package's
``parallel/mesh.py``.

The JAX package shards the global batch over a ``data`` mesh axis and lets
XLA insert the gradient psum. The port runs one process per card (NCCL on
CUDA, gloo on the CPU) over a ``torch.distributed`` device mesh, by default
1-D and named ``data``; each rank keeps its own rows of the global batch and
DistributedDataParallel (or fully_shard) averages the gradients. Inference
sharding names its axis ``objects`` (``inference_sharding``) or ``spatial``
(``spatial``) and joins the ranks' pieces with ``all_gather_cat``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


class RankLocal(tuple):
    """A batch that already holds this rank's rows (what each process's
    loader yields under the launcher); ``shard_batch`` passes it through."""


def make_mesh(device_type: Optional[str] = None, axis_names: Sequence[str] = ("data",)):
    """A 1-D DeviceMesh over the default process group's ranks, its one axis
    named ``axis_names[0]`` (``data`` by default; the JAX package's
    ``make_mesh``). The process group must exist
    (``launch.init_distributed``). device_type: "cuda" when the backend is
    NCCL, else "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "launch.init_distributed first")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=tuple(axis_names))


def all_gather_cat(mesh, x: torch.Tensor, dim: int = 0,
                   sizes: Optional[Sequence[int]] = None,
                   axis_name: Optional[str] = None) -> torch.Tensor:
    """Every rank's x joined along `dim` in rank order, on every rank (the
    global array of a sharded JAX value). sizes: each rank's extent along
    `dim` when they differ (the pieces travel padded to the largest); None =
    all equal to x's. gloo (the CPU, or several ranks on one card) takes
    CUDA tensors in torch 2.11 as NCCL does, so the pieces stay where they
    are."""
    group = mesh.get_group(axis_name) if axis_name else mesh.get_group()
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if sizes is None:
        sizes = [x.shape[dim]] * n
    pad = max(sizes) - x.shape[dim]
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_zeros(shape)], dim)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat([p.narrow(dim, 0, s) for p, s in zip(parts, sizes)], dim)


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

