"""The benchmark's files: every cell, configuration, family, traffic mix,
limit and per-layer metric is found by its name; a cell added as files
alone is found, of the SAM 2.1 family or of a family added as files alone;
nothing imports JAX or the JAX package, and no family's reference imports
anything of the program."""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import json
from pathlib import Path

import pytest

from port_bench import cells
from port_bench.reference import configs as ref_configs
from port_bench.tests import tiny

HERE = Path(__file__).resolve().parents[1]
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
FAMILIES = sorted(p.stem for p in (HERE / "families").glob("*.py"))
# the published presets of the SAM 2.1 family's configurations
SAM2_1_PRESETS = {"sam2.1_hiera_l": ref_configs.sam2_1_hiera_l,
                  "sam2.1_hiera_s": ref_configs.sam2_1_hiera_s}


def listed_readers(workload: str, bench: dict = BENCH) -> set:
    return {m["name"] for m in bench["per_layer"] if workload in m.get("workloads", [workload])}


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_with_its_files(name):
    cell = cells.load_cell(name)
    fam = cells.family(cell)
    assert set(cell.limits) == set(fam.NUMBERS)
    port, ref, preset = fam.published(cell.config)
    assert port == ref == preset  # published widths, whole depth
    if cell.config.get("family", "sam2_1") == "sam2_1":
        assert ref == dataclasses.asdict(SAM2_1_PRESETS[cell.config_name]())
        assert cell.limits["resize_exact"] == 0
        for key in ("streams", "objects_per_stream", "video_hw"):
            assert key in cell.traffic
    assert set(cells.layer_metrics(name)) == listed_readers(name)
    for key in ("warm_steps", "trace_steps"):
        assert key in cell.traffic


@pytest.mark.parametrize("name,family", [(tiny.NAME, "sam2_1"), (tiny.FAMILY_NAME, tiny.FAMILY)])
def test_a_cell_added_as_files_alone_is_found(tmp_path, name, family):
    root = tiny.write_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = cells.load_cell(name, root)
    assert cell.config.get("family", "sam2_1") == family
    assert cell.config["engine"]["dtype"] == "float32"
    assert set(cells.layer_metrics(name, root)) == listed_readers(name, bench)
    with tiny.family_on_path(root):
        assert set(cell.limits) == set(cells.family(cell).NUMBERS)
    if family == "sam2_1":
        assert cell.traffic["streams"] == tiny.TRAFFIC["streams"]
        assert set(cells.layer_metrics(name, root)) == {m["name"] for m in BENCH["per_layer"]}
    else:
        assert set(cells.layer_metrics(name, root)) == set(tiny.FAMILY_READERS)


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


def _reference_package(base: Path, family: str) -> Path:
    spec = importlib.util.spec_from_file_location(f"f_{family}",
                                                  base / "families" / f"{family}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return base / mod.REFERENCE


@pytest.mark.parametrize("family", FAMILIES + [tiny.FAMILY])
def test_the_reference_imports_nothing_of_the_program(tmp_path, family):
    base = HERE
    if family == tiny.FAMILY:
        base = tiny.write_root(tmp_path) / "port_bench"
    with tiny.family_on_path(base.parent):
        package = _reference_package(base, family)
    paths = list(package.rglob("*.py"))
    assert paths, package
    for path in paths:
        assert "det_sam2_tpu_torch" not in set(_imports(path)), path


def test_no_module_of_the_harness_names_the_test_family():
    for path in HERE.rglob("*.py"):
        if path.relative_to(HERE).parts[0] != "tests":
            assert tiny.FAMILY not in path.read_text(), path
