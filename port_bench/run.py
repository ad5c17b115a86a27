"""The benchmark of det_sam2_tpu_torch on one H100: one run of one cell.

    python3 port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as setup_s, from the process's start): the kernels built or
loaded from the checkout's build/, then what the cell's family
(families/<family>.py) makes: the weights and traffic from the seed and the
program (for SAM 2.1 the engine and the streamer), its prompts and the warm
steps. Then, with --trace 0, live steps for --seconds (the end-to-end
metrics); with --trace 1, a fixed number of live steps under the profiler
(the per-layer metrics). Then the program's state is freed and the family's
plain reference decides ``correct`` (for SAM 2.1 check.py). The last line of standard output
is the result, one JSON object; the compared numbers and their limits are
the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded in the process that prints a
# result: the JAX package is not the system under test, and nothing here
# may pull JAX in
FORBIDDEN = ("jax", "jaxlib", "flax", "det_sam2_tpu")
KERNELS = ("flash_fwd", "flash_banked_keys", "flash_banked_fwd", "mask_resize")


def process_start() -> float:
    """The epoch second this process started (from /proc), or the time
    this module was loaded where /proc does not say."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = os.sysconf("SC_CLK_TCK")
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - uptime + int(fields[19]) / ticks
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


# steps after the warm ones that the fp8 control follows
CONTROL_STEPS = 64


def run_control(cell, seed: int, device) -> dict:
    """The comparison's lower-precision control in the program's place (the
    family's ``control_record``): the compared numbers it reads, which have
    to fail their limits."""
    import torch

    from port_bench import cells

    device = torch.device(device)
    fam = cells.family(cell)
    traffic = fam.make_traffic(cell.config, cell.traffic, seed, device)
    steps = int(cell.traffic["warm_steps"]) + CONTROL_STEPS
    rec = fam.control_record(cell.config, cell.traffic, traffic, seed, steps, device)
    numbers = fam.compare(cell.config, cell.traffic, traffic, rec, seed, device)
    print("[check] " + ", ".join(f"{k} {v!r}" for k, v in numbers.items()), file=sys.stderr)
    checks = {k: {"value": v, "limit": float(cell.limits[k])} for k, v in numbers.items()}
    return {"check": checks, "correct": all(v["value"] <= v["limit"] for v in checks.values())}


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             int8: bool = False) -> dict:
    """One run of ``cell`` on ``device``: the result object without its
    checks of the card and of the loaded modules. The cell's family builds
    the program and its inputs and decides ``correct``. int8: the program
    with its W8A8 int8 trunk (a lower-precision path of its own)."""
    import numpy as np
    import torch

    from port_bench import cells, live
    from port_bench import trace as tracing

    device = torch.device(device)
    cuda = device.type == "cuda"
    conf, tr = cell.config, cell.traffic
    fam = cells.family(cell)
    if cuda:
        import det_sam2_tpu_torch.ops.mask_resize  # noqa: F401  (registers its kernel)
        from det_sam2_tpu_torch.ops import attention as att

        att.build_kernels(KERNELS)
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats()
    traffic = fam.make_traffic(conf, tr, seed, device)
    lv = fam.setup(conf, tr, traffic, seed, device, int8=int8)
    lv.prompt()
    for _ in range(int(tr["warm_steps"])):
        lv.step()
    live.sync(device)
    setup_s = time.time() - t_start
    b = lv.b
    first = lv.k + 1
    out = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if not trace:
        lat, win = live.window(lv, seconds)
        out["attempted"] = int(len(lat) * b)
        out["metrics"] = {
            "stream_fps": {"value": len(lat) * b / win, "unit": "frames/s"},
            "frame_p95_ms": {"value": float(np.percentile(lat, 95)) * 1e3, "unit": "ms"},
            "peak_mem_gib": {"value": (torch.cuda.max_memory_allocated() if cuda else 0)
                             / 2 ** 30, "unit": "GiB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
        print(f"[run] {len(lat)} steps in {win:.3f} s: median step "
              f"{float(np.median(lat)) * 1e3:.3f} ms", file=sys.stderr)
    else:
        n = int(tr["trace_steps"])
        tc = tracing.traced(lv, n, fam.trace_cell(conf, lv, first, n), fam.ranges(lv))
        out["attempted"] = n * b
        units = {m["name"]: m["unit"] for m in
                 json.loads((cell.root / "BENCHMARK.json").read_text())["per_layer"]}
        for name, read in cells.layer_metrics(cell.name, cell.root).items():
            v = read(tc)
            if v is not None:
                out["metrics"][name] = {"value": float(v), "unit": units[name]}
        out["trace"] = {"busy_s": tc.busy_s, "window_s": tc.window_s,
                        "breakdown": tc.breakdown()}
        print(f"[trace] {n} steps in {tc.window_s:.3f} s ({n * b / tc.window_s:.3f} "
              f"stream-frames/s traced); device ms a step by range: "
              + ", ".join(f"{r} {1e3 * (tc.range_device_s(r) or 0) / n:.3f}"
                          for r in tc.range_names)
              + "; launches: " + ", ".join(f"{f} {len(tc.kernels(f))}" for f in (
                  "::flash_fwd_bf16<", "::flash_banked_bf16<", "flash_banked_keys_kernel",
                  "mask_resize_kernel", "flash_fwd_kernel")),
              file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rec = lv.close()
    del lv
    if cuda:
        torch.cuda.empty_cache()
    numbers = fam.compare(conf, tr, traffic, rec, seed, device)
    print("[check] " + ", ".join(f"{k} {v!r}" for k, v in numbers.items()), file=sys.stderr)
    out["check"] = {k: {"value": v, "limit": float(cell.limits[k])} for k, v in numbers.items()}
    out["correct"] = all(v["value"] <= v["limit"] for v in out["check"].values())
    out["peak"] = peak
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("none", "int8", "fp8"), default="none",
                    help="a lower-precision run the comparison has to refuse, never a "
                         "benchmark run: int8, the program with its W8A8 int8 trunk; fp8, "
                         "the reference in fp8 in the program's place (prints the "
                         "compared numbers only)")
    args = ap.parse_args(argv)
    t_start = process_start()

    import torch

    from port_bench import cells

    cell = cells.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("port_bench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"port_bench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    if args.control == "fp8":
        res = run_control(cell, args.seed, torch.device("cuda", 0))
        for k, v in res["check"].items():
            print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
        print(json.dumps({"control": "fp8", "correct": res["correct"], "check": res["check"]}))
        return 0
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                   t_start, int8=args.control == "int8")
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: modules loaded that the benchmark may not load: {bad}",
              file=sys.stderr)
        return 3
    result = {"correct": res["correct"], "attempted": res["attempted"],
              "failed": res["failed"], "metrics": res["metrics"],
              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                         "count": cell.chips, "memory_peak_bytes": int(res["peak"])}}
    if args.trace:
        result["device"]["busy_s"] = res["trace"]["busy_s"]
        result["device"]["window_s"] = res["trace"]["window_s"]
        result["breakdown"] = res["trace"]["breakdown"]
    result["check"] = res["check"]
    print(f"[card] {card_line()}", file=sys.stderr)
    for k, v in res["check"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
