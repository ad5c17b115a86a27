"""A tiny cell written as files under a temporary root, for the CPU tests:
the harness drives it end to end with the kernels' plain versions."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

from port_bench.reference import configs as ref_configs

HERE = Path(__file__).resolve().parents[1]
NAME = "tiny.cell"

TRAFFIC = {
    "streams": 2, "objects_per_stream": 2, "video_hw": [48, 80], "pool_frames": 6,
    "num_frames": 1000000, "warm_steps": 9, "trace_steps": 3, "radius_px": [10, 16],
    "path_amplitude": 0.2, "pan_px": 4, "sample_rows": 2, "keep_share": 0.5,
    "max_steps": 1000,
}


def tiny_config(dtype: str = "float32") -> dict:
    """The reference's tiny test model with SAM 2.1's postprocessing and a
    bank that holds every memory the selection reads."""
    cfg = ref_configs.tiny_test_config(fill_hole_area=8, cond_bank_size=4,
                                       noncond_bank_size=32, max_obj_ptrs_in_encoder=8)
    conf = json.loads((HERE / "configs" / "sam2.1_hiera_s.json").read_text())
    conf = {k: conf[k] for k in ("name", "source", "reduced", "engine", "assumed")}
    conf["name"] = "tiny"
    conf["engine"] = {"dtype": dtype, "banked": True}
    conf.update(dataclasses.asdict(cfg))
    return conf


def write_root(root: Path, limits=None, dtype: str = "float32", traffic=None) -> Path:
    """A checkout-like root holding BENCHMARK.json with the tiny cell and its
    files; the metric readers are copied from the benchmark."""
    base = root / "port_bench"
    for d in ("configs", "traffic", "limits"):
        (base / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(HERE / "metrics", base / "metrics", dirs_exist_ok=True)
    (base / "configs" / "tiny.json").write_text(json.dumps(tiny_config(dtype)))
    (base / "traffic" / "tiny_mix.json").write_text(json.dumps(dict(TRAFFIC, **(traffic or {}))))
    # fp32 against fp32: the pointers differ by summation order alone
    lim = {"ptr_err": 1e-4, "feat_err": 1e-5, "holes_left": 0, "resize_exact": 0}
    (base / "limits" / f"{NAME}.json").write_text(json.dumps(dict(lim, **(limits or {}))))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "tiny", "file": "port_bench/configs/tiny.json",
                         "reduced": [], "why": "tests"}]
    bench["workloads"] = [{"name": NAME, "config": "tiny", "traffic": "tiny_mix", "chips": 1,
                           "why": "tests"}]
    for m in bench["per_layer"]:
        m["workloads"] = [NAME]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
