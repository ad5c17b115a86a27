"""The benchmark's files: every cell, configuration, traffic mix, limit and
per-layer metric is found by its name; a cell added as files alone is
found; nothing imports JAX or the JAX package, and the reference imports
nothing of the program."""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path

import pytest

from port_bench import cells, check
from port_bench.reference import configs as ref_configs
from port_bench.tests import tiny

HERE = Path(__file__).resolve().parents[1]
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_with_its_files(name):
    from det_sam2_tpu_torch import configs as port_configs

    cell = cells.load_cell(name)
    assert set(cell.limits) == set(check.NUMBERS)
    assert cell.limits["resize_exact"] == 0
    port = dataclasses.asdict(cells.model_config(port_configs, cell.config))
    ref = dataclasses.asdict(cells.model_config(ref_configs, cell.config))
    assert port == ref
    preset = {"sam2.1_hiera_l": ref_configs.sam2_1_hiera_l,
              "sam2.1_hiera_s": ref_configs.sam2_1_hiera_s}[cell.config_name]()
    assert ref == dataclasses.asdict(preset)  # published widths, whole depth
    readers = cells.layer_metrics(name)
    assert set(readers) == {m["name"] for m in BENCH["per_layer"]}
    for key in ("streams", "objects_per_stream", "video_hw", "warm_steps", "trace_steps"):
        assert key in cell.traffic


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    root = tiny.write_root(tmp_path)
    cell = cells.load_cell(tiny.NAME, root)
    assert cell.traffic["streams"] == tiny.TRAFFIC["streams"]
    assert cell.config["engine"]["dtype"] == "float32"
    assert set(cells.layer_metrics(tiny.NAME, root)) == {m["name"] for m in BENCH["per_layer"]}


def test_the_traffic_repeats_for_a_seed_and_moves_with_it():
    t = json.loads((HERE / "traffic" / "live_objects.json").read_text())
    t = dict(t, streams=2, objects_per_stream=3, pool_frames=3)
    a = cells.make_traffic(t, 64, 2 ** 33 + 5, "cpu")
    b = cells.make_traffic(t, 64, 2 ** 33 + 5, "cpu")
    c = cells.make_traffic(t, 64, 2 ** 33 + 6, "cpu")
    assert bool((a.pool == b.pool).all()) and (a.boxes == b.boxes).all()
    assert not bool((a.pool == c.pool).all())
    assert a.pool.shape == c.pool.shape == (3, 2, 64, 64, 3)
    assert len(a.rows) == t["sample_rows"] and all(0 <= r < 6 for r in a.rows)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        tops = set(_imports(path))
        assert not tops & {"jax", "jaxlib", "flax", "det_sam2_tpu"}, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "det_sam2_tpu_torch" not in set(_imports(path)), path
