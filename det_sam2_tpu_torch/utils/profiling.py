"""Observability: device memory, state-size accounting, spans, profiler.

Counterpart of the JAX package's ``utils/profiling.py``, on torch: device
memory comes from the CUDA caching allocator (no fallback: without a card
there is no device memory to report), state sizes sum tensor and ndarray
bytes, and the trace context is ``torch.profiler``. Constant device memory
over an endless stream is the product's core claim, so the session size
report is first-class here.

Spans name the parts of the streaming step (``span``): the streamer's
window, the engine's window and, inside it, the encode, the bank's
selection and writes, memory attention, the SAM heads, the memory encoder
and hole filling. A span records only while a ``torch.profiler`` records
(or inside ``recording()``); otherwise ``span`` returns one shared object
that does nothing. A recorded span is also a ``record_function`` range, so
it sits in the profiler's Chrome trace beside its operators and kernels, on
the same clock; the recorder keeps its host interval, its device interval
(CUDA events on the current stream) and the host-device synchronisations
made while it was the innermost open span (``spans``, ``span_summary``,
``sync_sites``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import sys
import threading
import time
import warnings
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


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
    writes a Chrome trace ``trace.json`` into log_dir, the block's spans
    among its ranges (and in ``spans()`` after it). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

# the text torch.cuda's sync debug mode "warn" raises for each host-device
# synchronisation (blocking copies, .item(), nonzero and boolean indexing,
# stream and event synchronises)
SYNC_MESSAGE = "called a synchronizing CUDA operation"
# a span of these names opened with no span around it starts a step
STEP_SPANS = ("streamer.window", "engine.window")


@dataclasses.dataclass
class SpanRecord:
    """One recorded span. Times are nanoseconds on ``time.time_ns``'s clock,
    the clock of a torch.profiler Chrome trace (``ts`` in microseconds plus
    the file's ``baseTimeNanoseconds``). The device interval runs from the
    CUDA event recorded on the current stream at entry to the one at exit,
    put on the same clock when the recording is read: it includes any time
    the card waited for the host inside the span (None without CUDA, and
    the end None for a span still open). ``parent`` is the index of the
    enclosing span in the same list; ``syncs`` counts the synchronisations
    made while this span was the innermost one open on its thread."""

    name: str
    parent: Optional[int]
    step: int
    thread: int
    host_start_ns: int
    host_end_ns: Optional[int] = None
    device_start_ns: Optional[int] = None
    device_end_ns: Optional[int] = None
    syncs: int = 0

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        if self.device_start_ns is None or self.device_end_ns is None:
            return None
        return (self.device_end_ns - self.device_start_ns) / 1e6


class _Recording:
    """The spans of one recording, their events and sync sites."""

    def __init__(self, explicit: bool):
        self.explicit = explicit
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self.records: List[SpanRecord] = []
        self.events: list = []  # (record, entry event, exit event)
        self.sites: Counter = Counter()  # (span name, site) -> syncs
        self.next_step = 0
        self.calibrated = False


_lock = threading.Lock()
_local = threading.local()  # .stack: the open spans of this thread
_explicit = 0  # open recording() blocks
_open: Optional[_Recording] = None
_last: Optional[_Recording] = None
_counting = 0  # outermost spans open with CUDA: the sync counter is on
_restore = None  # (previous sync debug mode, warnings state) while counting


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _site(filename: str, lineno: int) -> str:
    """"file.py:line (function)" of the Python frame that made a
    synchronising call, the file's path inside the package."""
    f = sys._getframe(2)
    while f is not None and not (f.f_code.co_filename == filename and f.f_lineno == lineno):
        f = f.f_back
    fn = f" ({f.f_code.co_name})" if f is not None else ""
    path = filename.replace(os.sep, "/")
    path = path.split("/det_sam2_tpu_torch/")[-1] if "/det_sam2_tpu_torch/" in path \
        else "/".join(path.rsplit("/", 2)[-2:])
    return f"{path}:{lineno}{fn}"


def _on_warning(previous, message, category, filename, lineno, file=None, line=None):
    if not str(message).startswith(SYNC_MESSAGE):
        return previous(message, category, filename, lineno, file, line)
    st = getattr(_local, "stack", None)
    if st and not getattr(_local, "quiet", False):
        sp = st[-1]
        sp.record.syncs += 1  # this thread's own record
        site = _site(filename, lineno)
        with _lock:
            sp.rec.sites[(sp.name, site)] += 1


def _count_syncs(on: bool) -> None:
    """The sync counter on (torch.cuda's sync debug mode "warn", every such
    warning shown to ``_on_warning`` and none printed) from the first open
    outermost span to the last one's exit, then the previous state back. A
    mode of "error" is left as it is."""
    global _counting, _restore
    with _lock:
        _counting += 1 if on else -1
        if on and _counting == 1:
            mode = torch.cuda.get_sync_debug_mode()
            caught = warnings.catch_warnings()
            caught.__enter__()
            warnings.filterwarnings("always", message=SYNC_MESSAGE)
            warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
            warnings.showwarning = functools.partial(_on_warning, warnings.showwarning)
            if mode == 0:
                torch.cuda.set_sync_debug_mode("warn")
            _restore = (mode, caught)
        elif not on and _counting == 0:
            mode, caught = _restore
            _restore = None
            torch.cuda.set_sync_debug_mode(mode)
            caught.__exit__(None, None, None)


class _Off:
    """What ``span`` returns when nothing records: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "rec", "record", "index", "rf", "exit_event", "outer")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        global _open
        rec = _open
        if rec is None:
            with _lock:
                if _open is None:
                    _open = _Recording(explicit=_explicit > 0)
                rec = _open
        self.rec = rec
        st = _stack()
        parent = st[-1] if st and st[-1].rec is rec else None
        if parent is not None:
            step = parent.record.step
        else:
            with _lock:
                if self.name in STEP_SPANS:
                    rec.next_step += 1
                step = rec.next_step - 1
        self.outer = not st and rec.cuda
        if self.outer:
            _count_syncs(True)
        # the host start before the range's: the range's first entry is slow
        self.record = SpanRecord(self.name, None if parent is None else parent.index, step,
                                 threading.get_ident(), time.time_ns())
        self.rf = _autograd_profiler.record_function(self.name)
        self.rf.__enter__()
        with _lock:
            self.index = len(rec.records)
            rec.records.append(self.record)
        self.exit_event = None
        if rec.cuda:
            entry = torch.cuda.Event(enable_timing=True)
            entry.record()
            self.exit_event = torch.cuda.Event(enable_timing=True)
            rec.events.append((self.record, entry, self.exit_event))
        st.append(self)
        return self

    def __exit__(self, *exc):
        if self.exit_event is not None:
            self.exit_event.record()
        self.record.host_end_ns = time.time_ns()
        self.rf.__exit__(*exc)
        _stack().pop()
        if self.outer:
            _count_syncs(False)
        return False


def _close() -> None:
    """The open recording becomes the last one."""
    global _open, _last
    with _lock:
        if _open is not None:
            _last, _open = _open, None


def span(name: str):
    """A context manager naming a part of the program. Off (no profiler
    recording and no ``recording()`` block): one shared object that does
    nothing, after one flag check; no record, event or synchronisation. On:
    a ``record_function`` range named ``name`` and a ``SpanRecord``.

    A span of ``STEP_SPANS`` with no span around it starts a new step; any
    other span takes its parent's step, or the last step started."""
    if _explicit or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    if _open is not None:
        _close()
    return _OFF


def spanned(name: str):
    """A decorator: the function's whole call inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


@contextlib.contextmanager
def recording():
    """Record spans in the block without a profiler; ``spans()`` reads them
    after it."""
    global _explicit
    _close()
    with _lock:
        _explicit += 1
    try:
        yield
    finally:
        with _lock:
            _explicit -= 1
        if not _explicit:
            _close()


def _calibrate(rec: _Recording) -> None:
    """Put the recording's device events on the host clock: one event
    recorded now and waited for, ``time_ns`` read, and each event's
    ``elapsed_time`` to it subtracted. Its synchronisations count nowhere."""
    if not rec.cuda or rec.calibrated:
        return
    _local.quiet = True
    try:
        torch.cuda.synchronize()
        ref = torch.cuda.Event(enable_timing=True)
        ref.record()
        ref.synchronize()
        now = time.time_ns()
        for r, entry, exit_event in rec.events:
            r.device_start_ns = now - round(entry.elapsed_time(ref) * 1e6)
            if r.host_end_ns is not None:
                r.device_end_ns = now - round(exit_event.elapsed_time(ref) * 1e6)
    finally:
        _local.quiet = False
    rec.calibrated = True


def spans() -> List[SpanRecord]:
    """The spans of the last recording, in the order they were entered (a
    profiler's recording ends when it stops; ``recording()``'s at the
    block's end). Empty when nothing was recorded."""
    if _open is not None and not _open.explicit and not _autograd_profiler._is_profiler_enabled:
        _close()
    rec = _last
    if rec is None:
        return []
    _calibrate(rec)
    return list(rec.records)


def span_summary() -> Dict[str, dict]:
    """By span name over the last recording: ``count``, ``host_ms``,
    ``device_ms`` (None without CUDA) and ``syncs``."""
    out: Dict[str, dict] = {}
    for r in spans():
        s = out.setdefault(r.name, {"count": 0, "host_ms": 0.0, "device_ms": None,
                                    "syncs": 0})
        s["count"] += 1
        s["syncs"] += r.syncs
        if r.host_end_ns is not None:
            s["host_ms"] += r.host_ms
        if r.device_ms is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + r.device_ms
    return out


def sync_sites() -> Counter:
    """(span name, "file.py:line (function)") -> synchronisations over the
    last recording."""
    spans()
    return Counter() if _last is None else Counter(_last.sites)
