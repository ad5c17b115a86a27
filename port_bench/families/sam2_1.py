"""The SAM 2.1 family: B camera streams of O objects tracked in lockstep by
the port's BatchedVideoStreamer (``live.py``), held against the plain fp32
reference in ``reference/`` (``check.py``). Glue only: every function here
calls the harness's SAM 2.1 code where it is."""

from __future__ import annotations

import dataclasses
import sys
import time

from det_sam2_tpu_torch import configs as port_configs
from port_bench import cells, check, flops, live
from port_bench import trace as tracing
from port_bench.reference import configs as ref_configs

NUMBERS = check.NUMBERS
REFERENCE = "reference"
control_record = check.control_record


def make_traffic(conf: dict, traffic_conf: dict, seed: int, device) -> cells.Traffic:
    """The run's frames, box prompts and samples from the seed."""
    ref_cfg = cells.model_config(ref_configs, conf)
    return cells.make_traffic(traffic_conf, ref_cfg.image_size, seed, device)


def setup(conf: dict, traffic_conf: dict, traffic: cells.Traffic, seed: int, device,
          int8: bool = False) -> live.LiveStreams:
    """The seeded weights, the engine over them (int8: the port's W8A8 int8
    trunk) and the streamer over the traffic's streams."""
    dtype = cells.DTYPES[conf["engine"]["dtype"]]
    sd = cells.seeded_weights(cells.model_config(ref_configs, conf), seed, device, dtype,
                              conf["assumed"])
    engine = live.build_engine(cells.model_config(port_configs, conf), sd, dtype, device,
                               bool(conf["engine"]["banked"]), int8=int8)
    del sd
    return live.LiveStreams(engine, traffic, traffic_conf, device)


def ranges(lv: live.LiveStreams) -> list:
    """The four SAM 2.1 modules whose launches the trace sorts by range."""
    return [(name, getattr(lv.engine.model, name)) for name in tracing.RANGES]


def trace_cell(conf: dict, lv: live.LiveStreams, first: int, n: int) -> dict:
    """What the readers read beside the trace: the reference's config, the
    frames and object rows a step, the traced frame indices and each step's
    model FLOPs (one count for each distinct memory the steps attend to)."""
    cfg = cells.model_config(ref_configs, conf)
    frames, rows = lv.b, lv.b * lv.o
    per_memory = {}

    def step_flops(k: int) -> float:
        key = flops.memory_live(cfg, k)
        if key not in per_memory:
            per_memory[key] = flops.step_model_flops(cfg, frames, rows, k)
        return per_memory[key]

    return {"cfg": cfg, "frames": frames, "rows": rows,
            "frame_indices": list(range(first, first + n)), "step_flops": step_flops}


def compare(conf: dict, traffic_conf: dict, traffic: cells.Traffic, rec: dict, seed: int,
            device) -> dict:
    """``check.compare``, with the reference's reach and time on stderr."""
    t0 = time.time()
    numbers = check.compare(conf, traffic_conf, traffic, rec, seed, device)
    print(f"[check] reference over {rec['steps']} steps x {len(traffic.rows)} rows "
          f"(rows {traffic.rows.tolist()}), {len(rec['kept'])} kept steps: "
          f"{time.time() - t0:.3f} s", file=sys.stderr)
    return numbers


def published(conf: dict):
    """(the configuration as the program builds it, as the reference builds
    it, the reference's published preset of the same name), as dicts: the
    three have to be equal (published widths, whole depth)."""
    preset = getattr(ref_configs, conf["name"].replace(".", "_"))()
    return tuple(dataclasses.asdict(c) for c in (cells.model_config(port_configs, conf),
                                                 cells.model_config(ref_configs, conf),
                                                 preset))
