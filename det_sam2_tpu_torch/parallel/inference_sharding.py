"""Multi-card inference over objects: shard the memory bank's object axis.

Counterpart of the JAX package's ``parallel/inference_sharding.py``. Each
object row of the tracking step attends only its own memory, so the step is
parallel over objects with no communication on the hot path: every rank
holds its own contiguous block of the bank's object rows
(``shard_bank``), is handed the frame's features whole, feeds
``prompt_step`` its own rows of the boxes and labels (``object_rows``), and
runs the engine's ordinary step on them. ``gather_objects`` joins a step's
per-object outputs in rank order, so every rank holds ``[O, ...]`` as JAX's
global arrays are. This is throughput scaling (more objects a frame);
``spatial.py`` is its latency counterpart.

Like the JAX package, sharding drops the banked-attention caches, so the
sharded step reads memory by the gather path: K1 with a bias over the
gathered keys. One card runs two ranks over gloo (NCCL refuses two ranks on
one GPU); several cards run NCCL. The model must keep objects independent:
``non_overlap_masks_for_mem_enc`` (off in SAM 2.1) couples them.

Usage::

    mesh = make_mesh(axis_names=("objects",))
    bank = shard_bank(mesh, init_bank(cfg, num_objects=8), "objects")
    rows = object_rows(mesh, 8, "objects")
    out = engine.prompt_step(feats, bank, 0, n, boxes[rows], labels[rows], is_init=True)
    ...
    bank, out = engine.track_step(feats, bank, t, n)
    masks = gather_objects(mesh, out, "objects")["pred_masks"]   # [8, 1, h, w]
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.distributed as dist

from det_sam2_tpu_torch.parallel.mesh import all_gather_cat
from det_sam2_tpu_torch.state import MemoryBank


def bank_shardings(mesh, bank: MemoryBank, axis_name: str = "objects") -> Dict[str, list]:
    """DTensor placements of a MemoryBank, by field: slot-major tensors
    shard their OBJECT axis (axis 1), the index and pin vectors replicate.
    Fields that are None are left out."""
    from torch.distributed.tensor import Replicate, Shard

    o = bank.num_objects
    out = {}
    for f in dataclasses.fields(bank):
        x = getattr(bank, f.name)
        if torch.is_tensor(x):
            out[f.name] = [Shard(1)] if x.ndim >= 2 and x.shape[1] == o else [Replicate()]
    return out


def object_rows(mesh, num_objects: int, axis_name: str = "objects") -> slice:
    """This rank's contiguous block of the object rows."""
    group = mesh.get_group(axis_name)
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    if num_objects % size:
        raise ValueError(f"object axis {num_objects} not divisible by mesh axis {size}")
    k = num_objects // size
    return slice(rank * k, (rank + 1) * k)


def shard_bank(mesh, bank: MemoryBank, axis_name: str = "objects") -> MemoryBank:
    """This rank's object rows of the bank (copies): the sharded fields of
    ``bank_shardings`` cut to ``object_rows``, the index and pin vectors
    whole. The object count must divide evenly over the mesh axis (the
    video predictor's power-of-two object buckets do over power-of-two
    axes). The banked-attention caches are dropped, so the sharded step
    takes the gather path, as in the JAX package."""
    rows = object_rows(mesh, bank.num_objects, axis_name)
    if bank.mem_k is not None:
        bank = dataclasses.replace(bank, mem_k=None, mem_v=None)
    placements = bank_shardings(mesh, bank, axis_name)
    cut = {}
    for name, (p,) in placements.items():
        x = getattr(bank, name)
        cut[name] = (x[:, rows] if p.is_shard() else x).clone()
    return dataclasses.replace(bank, **cut)


def gather_objects(mesh, outputs: Dict, axis_name: str = "objects") -> Dict:
    """A step's per-object outputs (tensors with the object axis first)
    joined over the ranks in rank order: every rank gets ``[O, ...]``.
    Other values pass through."""
    return {k: all_gather_cat(mesh, v, 0, axis_name=axis_name) if torch.is_tensor(v) else v
            for k, v in outputs.items()}
