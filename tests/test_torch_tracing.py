"""Spans of the port's streaming step (``utils/profiling.py``) and the
benchmark's readers of them, on the CPU at a tiny size; one ``cuda``-marked
test counts the step's host-device synchronisations on the card.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch with CUDA:

    python -m pytest --noconftest -q tests/test_torch_tracing.py
"""

import importlib.util
import json
import sys
import threading
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from det_sam2_tpu_torch.batched import BatchedVideoStreamer
from det_sam2_tpu_torch.configs import tiny_test_config
from det_sam2_tpu_torch.ops.mask_resize import resize_masks_cv2
from det_sam2_tpu_torch.track import SAM2Engine
from det_sam2_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]

NUM_FRAMES = 1000
COUNTS = (1, 2)
VIDEO_HW = (48, 80)
BOXES = {0: np.asarray([[[20.0, 24.0], [90.0, 100.0]]], np.float32),
         1: np.asarray([[[40.0, 10.0], [110.0, 80.0]], [[5.0, 60.0], [60.0, 120.0]]],
                       np.float32)}
# the spans of one live step in the order they open: (name, parent's name)
STEP_SPANS = [
    ("streamer.window", None),
    ("engine.window", "streamer.window"),
    ("engine.encode", "engine.window"),
    ("bank.select", "engine.window"),
    ("engine.memattn", "engine.window"),
    ("engine.heads", "engine.window"),
    ("engine.memenc", "engine.window"),
    ("bank.write", "engine.window"),
    ("engine.fill", "engine.window"),
    ("ops.mask_resize", None),
]
NEW_METRICS = ("streamer.host_ms", "streamer.syncs", "streamer.lead_ms", "fill.device_ms",
               "bank.device_ms")
# the host-device synchronisations of one streamer window (T = 1, banked)
# by "file (function)"; PERF.md lists them with their lines
SYNC_SITES = {
    "batched.py (propagate_window)": 2,
    "track.py (propagate_window_batched)": 2,
    "modeling/hiera.py (normalize)": 2,
    "state.py (select_memory)": 2,
    "modeling/position_encoding.py (get_1d_sine_pe)": 1,
    "modeling/position_encoding.py (random_pe_points)": 1,
    "state.py (_set_row)": 1,
    "ops/connected_components.py (fill_holes_in_mask_scores)": 1,
}


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    cfg = tiny_test_config(fill_hole_area=8, max_objects=4, max_obj_ptrs_in_encoder=8)
    return SAM2Engine(cfg, device="cpu", banked=True, seed=3)


def _frames(k, size, device="cpu"):
    g = torch.Generator().manual_seed(k)
    x = torch.randint(0, 256, (1, len(COUNTS), size, size, 3), generator=g, dtype=torch.uint8)
    return x.to(device)


def _streamer(eng):
    st = BatchedVideoStreamer(eng, COUNTS)
    size = eng.cfg.image_size
    labels = {v: np.tile(np.asarray([[2, 3]], np.int32), (c, 1)) for v, c in enumerate(COUNTS)}
    prompts = {v: (BOXES[v] * size / 128.0, labels[v]) for v in range(len(COUNTS))}
    st.add_prompts(0, NUM_FRAMES, _frames(0, size, eng.device)[0], prompts)
    return st


def _step(st, k):
    """One live step: the streamer's window at frame k, then the masks at
    the video's size."""
    frames = _frames(k, st.cfg.image_size, st.engine.device)
    low, ptr, logits, _ = st.propagate_window(frames, [k], NUM_FRAMES)
    return low, ptr, logits, resize_masks_cv2(low[0], VIDEO_HW, group=1)


def _reader(name):
    path = REPO / "port_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"tracing_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _tree(recs):
    return [(r.name, None if r.parent is None else recs[r.parent].name) for r in recs]


def test_a_span_is_one_shared_object_and_records_nothing_when_off(engine, monkeypatch):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("engine.encode") is profiling.span("bank.write")
    st = _streamer(engine)
    before = profiling.spans()
    filters, show = list(warnings.filters), warnings.showwarning

    def refuse(*_a, **_k):
        raise AssertionError("a span that is off touched the card")

    for name in ("Event", "set_sync_debug_mode", "get_sync_debug_mode", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    for k in (1, 2):
        _step(st, k)
    assert profiling._open is None
    assert profiling.spans() == before
    assert warnings.filters == filters and warnings.showwarning is show


def test_a_profiled_window_records_the_span_tree_on_the_trace_clock(engine, tmp_path):
    st = _streamer(engine)
    with profiling.profile_trace(str(tmp_path)):
        for k in (1, 2):
            _step(st, k)
    recs = profiling.spans()
    assert _tree(recs) == STEP_SPANS * 2
    assert [r.step for r in recs] == [0] * len(STEP_SPANS) + [1] * len(STEP_SPANS)
    for r in recs:
        assert r.host_start_ns <= r.host_end_ns and r.syncs == 0
        if not torch.cuda.is_available():
            assert r.device_start_ns is None and r.device_end_ns is None
        if r.parent is not None:
            p = recs[r.parent]
            assert p.host_start_ns <= r.host_start_ns <= r.host_end_ns <= p.host_end_ns
    trace = json.loads((tmp_path / "trace.json").read_text())
    base = trace["baseTimeNanoseconds"]
    starts = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            starts.setdefault(e["name"], []).append(e["ts"] * 1000 + base)
    for name, _ in STEP_SPANS:
        mine = sorted(r.host_start_ns for r in recs if r.name == name)
        theirs = sorted(starts.get(name, []))
        assert len(theirs) == len(mine), name
        for a, b in zip(mine, theirs):
            assert abs(a - b) < 1e6, (name, a - b)


def test_recording_records_without_a_profiler(engine):
    st = _streamer(engine)
    with profiling.recording():
        _step(st, 1)
    assert not torch.autograd.profiler._is_profiler_enabled
    assert _tree(profiling.spans()) == STEP_SPANS
    summary = profiling.span_summary()
    assert sorted(summary) == sorted(n for n, _ in STEP_SPANS)
    for s in summary.values():
        assert s["count"] == 1 and s["host_ms"] > 0 and s["syncs"] == 0
        # events on the card's stream wherever CUDA is up, even for a CPU engine
        assert (s["device_ms"] is None) == (not torch.cuda.is_initialized())
    assert profiling.sync_sites() == Counter()


def test_spans_on_many_threads_keep_their_own_tree_and_steps():
    """Threads that open windows at once (the server's handler threads):
    every record's parent is on its own thread, and no step id is lost or
    given twice."""
    threads, windows = 12, 50
    switch = sys.getswitchinterval()

    def work():
        for _ in range(windows):
            with profiling.span("engine.window"):
                with profiling.span("bank.select"):
                    pass
                with profiling.span("bank.write"):
                    pass

    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(switch)
    recs = profiling.spans()
    assert len(recs) == 3 * threads * windows
    roots = [r for r in recs if r.parent is None]
    assert sorted(r.step for r in roots) == list(range(threads * windows))
    for r in recs:
        if r.parent is not None:
            p = recs[r.parent]
            assert (p.name, p.thread, p.step) == ("engine.window", r.thread, r.step)


def test_outputs_and_bank_are_the_same_with_recording_on_and_off(engine):
    off, on = _streamer(engine), _streamer(engine)
    for k in (1, 2):
        a = _step(off, k)
        with profiling.recording():
            b = _step(on, k)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for field in ("cond_mem", "cond_ptr", "cond_frame_idx", "cond_obj_valid", "noncond_mem",
                  "noncond_ptr", "noncond_frame_idx", "noncond_obj_valid", "mem_k", "mem_v"):
        assert torch.equal(getattr(off.bank, field), getattr(on.bank, field)), field


def test_the_readers_of_the_spans_on_a_traced_window(engine, monkeypatch):
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in bench["workloads"]]
    entries = {m["name"]: m for m in bench["per_layer"] if m["name"] in NEW_METRICS}
    assert sorted(entries) == sorted(NEW_METRICS)
    for m in entries.values():
        assert m["workloads"] == cells
    st = _streamer(engine)
    steps = 2
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        t0 = time.perf_counter()
        for k in range(1, steps + 1):
            _step(st, k)
        window_ms = 1e3 * (time.perf_counter() - t0)
    trace = type("Trace", (), {"steps": steps})()
    got = {name: _reader(name)(trace) for name in NEW_METRICS}
    host = [r.host_ms for r in profiling.spans() if r.name == "streamer.window"]
    assert got["streamer.host_ms"] == pytest.approx(sum(host) / steps)
    assert 0 < got["streamer.host_ms"] < window_ms / steps
    assert got["streamer.syncs"] == 0
    # no device interval without CUDA
    for name in ("streamer.lead_ms", "fill.device_ms", "bank.device_ms"):
        assert (got[name] is None) == (not torch.cuda.is_initialized()), name
    # a program without spans (the parent of this change) reads nothing
    monkeypatch.delattr(profiling, "spans")
    for name in NEW_METRICS:
        assert _reader(name)(trace) is None, name


@pytest.mark.cuda
def test_the_streamer_window_synchronises_at_the_listed_sites_on_cuda():
    """Hiera-S at 1024², bf16, banked, 2 videos of 1 and 2 objects: every
    traced step makes the same synchronisations, at SYNC_SITES; every span
    has a device interval and the five readers read numbers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from det_sam2_tpu_torch.configs import sam2_1_hiera_s

    dev = torch.device("cuda")
    eng = SAM2Engine(sam2_1_hiera_s(), dtype=torch.bfloat16, device=dev, seed=0)
    st = _streamer(eng)
    for k in (1, 2):
        _step(st, k)
    torch.cuda.synchronize()
    steps = 3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]):
        for k in range(3, 3 + steps):
            _step(st, k)
            torch.cuda.synchronize()
    assert torch.cuda.get_sync_debug_mode() == 0
    recs = profiling.spans()
    assert _tree(recs) == STEP_SPANS * steps
    inside = []
    for r in recs:
        inside.append(r.name == "streamer.window"
                      or (r.parent is not None and inside[r.parent]))
    per_step = Counter()
    for r, i in zip(recs, inside):
        assert r.device_start_ns is not None and r.device_end_ns >= r.device_start_ns
        if i:
            per_step[r.step] += r.syncs
    assert list(per_step.values()) == [sum(SYNC_SITES.values())] * steps
    sites = Counter()
    for (name, site), n in profiling.sync_sites().items():
        if name == "ops.mask_resize":  # outside the window
            continue
        path, rest = site.split(":", 1)
        sites[f"{path} {rest.split(' ', 1)[1]}"] += n
    assert {k: v // steps for k, v in sites.items()} == SYNC_SITES
    assert all(v % steps == 0 for v in sites.values())
    trace = type("Trace", (), {"steps": steps})()
    got = {name: _reader(name)(trace) for name in NEW_METRICS}
    assert got["streamer.syncs"] == sum(SYNC_SITES.values())
    for name, v in got.items():
        assert v is not None, name
