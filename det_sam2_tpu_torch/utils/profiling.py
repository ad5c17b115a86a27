"""Observability helpers: device memory, state-size accounting, profiler.

Counterpart of the JAX package's ``utils/profiling.py``, on torch: device
memory comes from the CUDA caching allocator (no fallback: without a card
there is no device memory to report), state sizes sum tensor and ndarray
bytes, and the trace context is ``torch.profiler``. Constant device memory
over an endless stream is the product's core claim, so the session size
report is first-class here.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict

import numpy as np
import torch


def device_memory_stats(device=None) -> Dict[str, float]:
    """Allocated and peak allocated bytes of the CUDA device (GiB), as the
    caching allocator counts them (live tensors, not reserved blocks).
    device: None = the current CUDA device; raises without a card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("device_memory_stats needs a CUDA device")
        device = torch.cuda.current_device()
    return {
        "bytes_in_use_gib": torch.cuda.memory_allocated(device) / 2**30,
        "peak_bytes_gib": torch.cuda.max_memory_allocated(device) / 2**30,
    }


def host_memory_stats() -> Dict[str, float]:
    try:
        import psutil

        mem = psutil.Process().memory_info()
        return {"rss_gib": mem.rss / 2**30}
    except ImportError:  # pragma: no cover
        return {}


def pytree_nbytes(tree) -> int:
    """Total bytes of the tensors and ndarrays in nested dicts, lists,
    tuples and dataclasses."""
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    if isinstance(tree, dict):
        return sum(pytree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_nbytes(v) for v in tree)
    if hasattr(tree, "__dataclass_fields__"):
        return sum(pytree_nbytes(getattr(tree, f)) for f in tree.__dataclass_fields__)
    return 0


def session_size_report(session) -> Dict[str, float]:
    """Break down an InferenceSession's memory (MiB)."""
    return {
        "bank_device_mib": (
            pytree_nbytes(session.bank) / 2**20 if session.bank is not None
            else 0.0
        ),
        "frames_host_mib": sum(f.nbytes for f in session.frames.values()) / 2**20,
        "frames_device_mib": pytree_nbytes(
            list(getattr(session, "frames_dev", {}).values())
        ) / 2**20,
        "num_frames_dev_held": len(getattr(session, "frames_dev", {})),
        "cond_outputs_mib": pytree_nbytes(list(session.cond_outputs.values()))
        / 2**20,
        "noncond_outputs_mib": pytree_nbytes(
            list(session.noncond_outputs.values())
        ) / 2**20,
        "num_frames_held": len(session.frames),
        "num_cond_outputs": len(session.cond_outputs),
        "num_noncond_outputs": len(session.noncond_outputs),
    }


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler over the block (CPU and, with a card, CUDA activity);
    writes a Chrome trace ``trace.json`` into log_dir. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
