"""The traced window: ranges around the program's modules, the profiler's
device timeline, and what the per-layer readers read from them.

The ranges come from this benchmark's own files: public forward hooks on the
modules that the cell's family names (for SAM 2.1, RANGES: submodules whose
names the state-dict layout pins) open and close ``record_function``
ranges. Kernels are given to the range whose interval holds their launch on
the host (the profiler's correlation id ties a kernel to its launch). The trace is exported to a file under TMPDIR and
read back with json, then removed.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import List, Optional

RANGES = ("image_encoder", "memory_attention", "sam_mask_decoder", "memory_encoder")


def add_ranges(ranges) -> list:
    """Forward hooks that open a profiler range named ``name`` while
    ``module`` runs, for each (name, module) of ``ranges``. Returns the hook
    handles."""
    from torch.autograd.profiler import record_function

    handles = []
    for name, mod in ranges:
        stack: list = []

        def pre(_m, _a, _name=name, _stack=stack):
            rf = record_function(_name)
            rf.__enter__()
            _stack.append(rf)

        def post(_m, _a, _out, _stack=stack):
            _stack.pop().__exit__(None, None, None)

        handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    return handles


class Trace:
    """What a traced window left: device operations (kernels, copies,
    fills) with their durations and the range their launch fell in, the
    host's operator intervals, and the window's own numbers. ``ranges``:
    the names of the module ranges."""

    def __init__(self, events: List[dict], steps: int, window_s: float,
                 dispatch_s: List[float], cell: dict, ranges):
        self.range_names = tuple(ranges)
        self.steps = steps
        self.window_s = window_s
        self.dispatch_s = dispatch_s
        self.cell = cell
        launch_ts = {}
        ranges = defaultdict(list)
        self.host_ops = []
        device = []
        for e in events:
            cat = e.get("cat", "")
            if e.get("ph") != "X":
                continue
            if cat in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch_ts[corr] = e["ts"]
            elif cat == "user_annotation" and e["name"] in self.range_names:
                ranges[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
            elif cat == "cpu_op":
                self.host_ops.append((e["ts"], e["ts"] + e["dur"], e["name"]))
            elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
                device.append(e)
        for v in ranges.values():
            v.sort()
        self.ops = []  # (name, start us, dur us, range or None, is kernel)
        for e in device:
            ts = launch_ts.get(e.get("args", {}).get("correlation"))
            tag = None
            if ts is not None:
                for name, iv in ranges.items():
                    i = bisect.bisect_right(iv, (ts, float("inf"))) - 1
                    if i >= 0 and iv[i][0] <= ts <= iv[i][1]:
                        tag = name
                        break
            self.ops.append((e["name"], float(e["ts"]), float(e["dur"]), tag,
                             e.get("cat") == "kernel"))
        self.ops.sort(key=lambda r: r[1])
        self.host_ops.sort()

    def kernels(self, fragment: str):
        """(name, us) of every kernel whose name holds ``fragment``."""
        return [(n, d) for n, _, d, _, k in self.ops if k and fragment in n]

    def range_device_s(self, tag: str) -> Optional[float]:
        us = [d for _, _, d, t, _ in self.ops if t == tag]
        return sum(us) / 1e6 if us else None

    def merged(self):
        out = []
        for _, ts, dur, _, _ in self.ops:
            end = ts + dur
            if out and ts <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([ts, end])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) / 1e6

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps between device work summed by the host operator running at the
        gap's middle (``_no_host_op_`` where none was)."""
        by_name = defaultdict(float)
        for name, _, dur, _, _ in self.ops:
            by_name[name[:96]] += dur / 1e6
        gaps = defaultdict(float)
        merged = self.merged()
        # sweep the gaps in time order beside a stack of the host operators
        # open at that time (one thread's operators nest)
        stack, j, ops = [], 0, self.host_ops
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            mid = (e0 + s1) / 2
            while j < len(ops) and ops[j][0] <= mid:
                while stack and stack[-1][1] < ops[j][0]:
                    stack.pop()
                stack.append(ops[j])
                j += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            name = stack[-1][2] if stack else "_no_host_op_"
            gaps[name[:96]] += (s1 - e0) / 1e6
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]  # noqa: E731
        return {"device_ops": top(by_name), "idle_gaps": top(gaps)}


def traced(live, steps: int, cell: dict, ranges) -> Trace:
    """``steps`` live steps under torch.profiler (CPU and CUDA activities)
    with the module ranges on (``ranges``: (name, module) pairs); returns
    their Trace."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from port_bench.live import sync

    handles = add_ranges(ranges)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sync(live.device)
            dispatch = []
            t0 = time.perf_counter()
            for _ in range(steps):
                dispatch.append(live.step())
            window_s = time.perf_counter() - t0
    finally:
        for h in handles:
            h.remove()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Trace(events, steps, window_s, dispatch, cell, [name for name, _ in ranges])
