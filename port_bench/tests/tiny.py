"""Tiny cells written as files under a temporary root, for the CPU tests:
the harness drives them end to end with the kernels' plain versions.

``NAME`` is a SAM 2.1 cell. ``FAMILY_NAME`` is a cell of a second family,
``tiny_encoder``, that exists only as the files written here (its family
module, its reference package, a configuration that names the family, its
traffic, limits and BENCHMARK.json entries): the port's image encoder on
seeded frames against the reference's, one compared number, ``feat_err``.
No module of the harness names it."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import shutil
import sys
from pathlib import Path

from port_bench.reference import configs as ref_configs

HERE = Path(__file__).resolve().parents[1]
NAME = "tiny.cell"
FAMILY = "tiny_encoder"
FAMILY_NAME = "tiny.encoder"
# the per-layer metrics that the second family's cell lists
FAMILY_READERS = ("step.mfu", "device.idle_share", "encoder.device_ms")

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


FAMILY_MODULE = '''"""A family of one module: the port's image encoder (Hiera trunk and FPN
neck) on a seeded pool of frames, a batch of frames a step, against the
image encoder of the reference package tiny_encoder_ref."""

import time

import torch

from det_sam2_tpu_torch import configs as port_configs
from det_sam2_tpu_torch.modeling.image_encoder import ImageEncoder
from port_bench import cells, check
from port_bench import tiny_encoder_ref as ref

NUMBERS = ("feat_err",)
REFERENCE = "tiny_encoder_ref"


def make_traffic(conf, traffic_conf, seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    s = int(conf["image_size"])
    shape = (int(traffic_conf["pool_frames"]), int(traffic_conf["frames"]), s, s, 3)
    return torch.randint(0, 256, shape, generator=g, device=device, dtype=torch.uint8)


def weights(conf, seed, device):
    """N(0, 0.05) for every entry of the encoder's state dict, one call."""
    shapes = ref.shapes(conf)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63) + 1)
    sizes = [s.numel() for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=g, device=device).mul_(0.05)
    return {k: v.view(shapes[k]) for k, v in zip(shapes, flat.split(sizes))}


class Frames:
    def __init__(self, encoder, pool, device):
        self.encoder, self.pool, self.device = encoder, pool, torch.device(device)
        self.b, self.k, self.feats = pool.shape[1], 0, []

    def prompt(self):
        pass

    @torch.no_grad()
    def step(self):
        self.k += 1
        t0 = time.perf_counter()
        self.feats.append(self.encoder(self.pool[self.k % len(self.pool)])[-1])
        return time.perf_counter() - t0

    def close(self):
        rec = {"feats": [f.float().cpu() for f in self.feats], "steps": self.k}
        self.encoder, self.feats = None, []
        return rec


def setup(conf, traffic_conf, pool, seed, device, int8=False):
    if int8:
        raise NotImplementedError("the tiny_encoder family has no int8 path")
    cfg = cells.model_config(port_configs, conf)
    with torch.device(device):
        enc = ImageEncoder(cfg.hiera, cfg.neck, cfg.scalp)
    enc.load_state_dict(weights(conf, seed, device))
    return Frames(enc.eval(), pool, device)


def ranges(live):
    return [("image_encoder", live.encoder)]


def trace_cell(conf, live, first, n):
    per_step = ref.flops(conf, live.b)
    return {"frame_indices": list(range(first, first + n)), "step_flops": lambda k: per_step}


def _reference_feats(conf, pool, seed, device, steps):
    enc = ref.encoder(conf, weights(conf, seed, device), device)
    by_frame = {}
    with torch.no_grad():
        for k in range(1, steps + 1):
            i = k % len(pool)
            if i not in by_frame:
                by_frame[i] = enc(pool[i])[-1].float().cpu()
            yield by_frame[i]


def compare(conf, traffic_conf, pool, rec, seed, device):
    diff = mag = 0.0
    with check.fp32_exact():
        for got, want in zip(rec["feats"], _reference_feats(conf, pool, seed, device,
                                                            rec["steps"])):
            diff += float((got - want).abs().sum())
            mag += float(want.abs().sum())
    return {"feat_err": diff / mag}


def control_record(conf, traffic_conf, pool, seed, steps, device):
    with check.fp32_exact(), check.fp8_operands():
        return {"feats": list(_reference_feats(conf, pool, seed, device, steps)),
                "steps": steps}


def published(conf):
    import dataclasses

    ours = dataclasses.asdict(cells.model_config(port_configs, conf))
    return ours, dataclasses.asdict(ref.config(conf)), ours
'''

REFERENCE_PACKAGE = '''"""The tiny_encoder family's reference: the plain image encoder of
port_bench.reference, in fp32."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import cells
from port_bench.reference import configs as ref_configs
from port_bench.reference.image_encoder import ImageEncoder


def config(conf):
    return cells.model_config(ref_configs, conf)


def _module(conf):
    cfg = config(conf)
    return ImageEncoder(cfg.hiera, cfg.neck, cfg.scalp)


def shapes(conf):
    with torch.device("meta"):
        return {k: v.shape for k, v in _module(conf).state_dict().items()}


def encoder(conf, sd, device):
    with torch.device(device):
        enc = _module(conf)
    enc.load_state_dict({k: v.float() for k, v in sd.items()})
    return enc.eval()


def flops(conf, frames):
    """Model FLOPs of one step over ``frames`` frames (shapes only)."""
    s = int(conf["image_size"])
    with torch.device("meta"):
        enc = _module(conf).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        enc(torch.empty((frames, s, s, 3), dtype=torch.uint8, device="meta"))
    return float(counter.get_total_flops())
'''

FAMILY_TRAFFIC = {"frames": 2, "pool_frames": 3, "warm_steps": 2, "trace_steps": 3}


def write_root(root: Path, limits=None, dtype: str = "float32", traffic=None) -> Path:
    """A checkout-like root holding BENCHMARK.json with the two tiny cells
    and their files; the metric readers and the family modules are copied
    from the benchmark. The second family's files are all new: importing
    its reference package as ``port_bench.tiny_encoder_ref`` needs the
    root's ``port_bench`` on the package's path (``family_on_path``)."""
    base = root / "port_bench"
    for d in ("configs", "traffic", "limits", "tiny_encoder_ref"):
        (base / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(HERE / "metrics", base / "metrics", dirs_exist_ok=True)
    shutil.copytree(HERE / "families", base / "families", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (base / "families" / f"{FAMILY}.py").write_text(FAMILY_MODULE)
    (base / "tiny_encoder_ref" / "__init__.py").write_text(REFERENCE_PACKAGE)
    (base / "configs" / f"{FAMILY}.json").write_text(json.dumps(
        dict(tiny_config(), name=FAMILY, family=FAMILY)))
    (base / "traffic" / "tiny_frames.json").write_text(json.dumps(FAMILY_TRAFFIC))
    # fp32 against fp32, the same modules
    (base / "limits" / f"{FAMILY_NAME}.json").write_text(json.dumps({"feat_err": 1e-5}))
    (base / "configs" / "tiny.json").write_text(json.dumps(tiny_config(dtype)))
    (base / "traffic" / "tiny_mix.json").write_text(json.dumps(dict(TRAFFIC, **(traffic or {}))))
    # fp32 against fp32: the pointers differ by summation order alone
    lim = {"ptr_err": 1e-4, "feat_err": 1e-5, "holes_left": 0, "resize_exact": 0}
    (base / "limits" / f"{NAME}.json").write_text(json.dumps(dict(lim, **(limits or {}))))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "tiny", "file": "port_bench/configs/tiny.json",
                         "reduced": [], "why": "tests"},
                        {"name": FAMILY, "source": "tiny",
                         "file": f"port_bench/configs/{FAMILY}.json", "reduced": [],
                         "why": "tests"}]
    bench["workloads"] = [{"name": NAME, "config": "tiny", "traffic": "tiny_mix", "chips": 1,
                           "why": "tests"},
                          {"name": FAMILY_NAME, "config": FAMILY, "traffic": "tiny_frames",
                           "chips": 1, "why": "tests"}]
    for m in bench["per_layer"]:
        m["workloads"] = [NAME] + ([FAMILY_NAME] if m["name"] in FAMILY_READERS else [])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@contextlib.contextmanager
def family_on_path(root: Path):
    """The root's ``port_bench`` on the package's path while the second
    family runs, as its files would be in a checkout; its reference package
    is forgotten afterwards."""
    import port_bench

    saved = list(port_bench.__path__)
    port_bench.__path__.append(str(root / "port_bench"))
    try:
        yield
    finally:
        port_bench.__path__[:] = saved
        for name in [m for m in sys.modules if m.startswith("port_bench.tiny_encoder_ref")]:
            del sys.modules[name]
