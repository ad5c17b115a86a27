"""A cell of BENCHMARK.json and what it is made of, found by name.

  * a configuration: ``configs/<name>.json``, the model's sizes as they are
    run (for SAM 2.1 every field of the model's config dataclasses) and the
    engine's settings;
  * a traffic mix: ``traffic/<name>.json``, the parameters of its family's
    generator (for SAM 2.1 the one below: streams, objects, video size,
    frame pool, shapes) and the warm and traced steps;
  * the limits of the comparison that decides ``correct``:
    ``limits/<workload>.json``;
  * a per-layer metric: ``metrics/<name>.py`` (see ``layer_metrics``);
  * a model family: ``families/<name>.py``, named by the configuration's
    ``family`` key (``sam2_1`` where it has none): how the cell's program,
    weights, traffic, reference, compared numbers, control, traced ranges
    and model FLOPs are made (see ``family``).

The generator below is SAM 2.1's (its family module calls it). It makes,
from the run's seed, the frames every stream hands over (a cycled pool of
moving discs on a panning texture, at the model's input size) and one box
prompt an object. A new cell, or a new family, needs new files and
BENCHMARK.json entries, and no edit of a file that is there.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import importlib.util
import json
import math
from pathlib import Path
from typing import Dict

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    chips: int
    root: Path


def load_cell(workload: str, root: Path = HERE.parent) -> Cell:
    """The cell named ``workload`` in ``root``/BENCHMARK.json, with its
    configuration, traffic and limits files (under ``root``/port_bench)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    conf = configs[w["config"]]
    base = root / "port_bench"
    return Cell(
        name=workload, config_name=w["config"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic_name=w["traffic"],
        traffic=json.loads((base / "traffic" / f"{w['traffic']}.json").read_text()),
        limits=json.loads((base / "limits" / f"{workload}.json").read_text()),
        chips=int(w["chips"]), root=root)


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(cell: Cell):
    """The module ``families/<name>.py`` of the cell's root for the family
    that the cell's configuration names. It provides ``NUMBERS`` (the
    compared numbers, the keys of the cell's limits), ``REFERENCE`` (its
    reference package under ``port_bench/``, which imports nothing of the
    program), ``make_traffic`` (the run's inputs from the seed), ``setup``
    (the program over them: an object with ``prompt()``, ``step()``,
    ``close()`` giving the record ``compare`` reads, ``b`` stream-frames a
    step, ``k`` the last step and ``device``), ``ranges`` (the traced
    (name, module) pairs), ``trace_cell`` (the readers' ``trace.cell``, with
    ``step_flops(k)``), ``compare``, ``control_record`` (the control's
    record in the program's place) and ``published`` (the configuration as
    the program and the reference build it, and its published preset)."""
    name = cell.config.get("family", "sam2_1")
    return _load(f"port_bench_family_{name}",
                 cell.root / "port_bench" / "families" / f"{name}.py")


def layer_metrics(workload: str, root: Path = HERE.parent) -> Dict[str, object]:
    """name -> the ``read(trace)`` function of metrics/<name>.py, for every
    per-layer metric of BENCHMARK.json that lists this workload (or lists
    none)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    out = {}
    for m in bench["per_layer"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        path = root / "port_bench" / "metrics" / f"{m['name']}.py"
        out[m["name"]] = _load(f"port_bench_metric_{len(out)}", path).read
    return out


def _tuples(x):
    if isinstance(x, list):
        return tuple(_tuples(v) for v in x)
    if isinstance(x, dict):
        return {k: _tuples(v) for k, v in x.items()}
    return x


def model_config(configs_module, conf: dict):
    """The configuration file's model as ``configs_module``'s SAM2Config
    (the program's or the reference's: the same dataclasses and fields).
    Keys of the file that are no field of the config are its notes."""
    m = configs_module
    nested = {"hiera": m.HieraConfig, "neck": m.FpnNeckConfig,
              "memory_attention": m.MemoryAttentionConfig,
              "memory_encoder": m.MemoryEncoderConfig}
    fields = {f.name for f in dataclasses.fields(m.SAM2Config)}
    kw = {}
    for k, v in conf.items():
        if k in nested:
            kw[k] = nested[k](**_tuples(v))
        elif k in fields:
            kw[k] = _tuples(v)
    return m.SAM2Config(**kw)


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def seeded_weights(ref_cfg, seed: int, device, dtype, assumed: dict) -> Dict[str, torch.Tensor]:
    """Random weights in the SAM 2.1 state-dict layout, made on ``device``
    in ``dtype`` from the seed in two generator calls: the port's init rule
    (ones for LayerNorm weights and layer scales, zeros for biases, N(0,
    0.02) for the rest), then the changes the configuration file lists
    under ``assumed``: the object-score head's output bias, so that every
    object counts as present; the IoU head's output bias, so that the mask a
    frame keeps is a decision and no tie; the temporal encodings drawn
    N(0, 1), so that the memory's time positions weigh."""
    from port_bench.reference.layers import LayerNorm
    from port_bench.reference.sam2_base import SAM2Model

    with torch.device("meta"):
        template = SAM2Model(ref_cfg)
    ln = {f"{n}.weight" for n, mod in template.named_modules() if isinstance(mod, LayerNorm)}
    shapes = {k: tuple(t.shape) for k, t in template.state_dict().items()}
    normal = [k for k in shapes
              if not (k in ln or k.endswith(("gamma", "bias")) or k == "maskmem_tpos_enc")]
    g = _generator(seed, device)
    sizes = [math.prod(shapes[k]) for k in normal]
    flat = torch.randn(sum(sizes), generator=g, device=device).mul_(0.02).to(dtype)
    sd = {k: v.view(shapes[k]) for k, v in zip(normal, flat.split(sizes))}
    tpos = shapes["maskmem_tpos_enc"]
    sd["maskmem_tpos_enc"] = (torch.randn(tpos, generator=g, device=device)
                              * float(assumed["maskmem_tpos_enc_std"])).to(dtype)
    for k, shape in shapes.items():
        if k in sd:
            continue
        one = k in ln or k.endswith("gamma")
        sd[k] = (torch.ones if one else torch.zeros)(shape, device=device, dtype=dtype)
    sd[assumed["object_score_bias_key"]].fill_(float(assumed["object_score_bias"]))
    iou = sd[assumed["iou_head_bias_key"]]
    iou.copy_(torch.tensor(assumed["iou_head_bias"], dtype=dtype).to(iou.device))
    for pattern, scale in assumed.get("weight_scales", {}).items():
        for k in fnmatch.filter(sd, pattern):
            sd[k].mul_(float(scale))
    return sd


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Traffic:
    """One run's inputs: the frame pool [P, B, S, S, 3] uint8 (host memory,
    pinned when a card is present), the box prompts [B, O, 4] (x0, y0, x1,
    y1 in model pixels), the sampled object rows the comparison follows, and
    the window steps whose video-size masks it keeps."""

    pool: torch.Tensor
    boxes: np.ndarray
    rows: np.ndarray
    keep_steps: np.ndarray


def make_traffic(traffic: dict, image_size: int, seed: int, device) -> Traffic:
    """The generator. Every stream is a texture (smooth colour noise) panned
    periodically, with ``objects_per_stream`` discs of seeded colour and
    radius moving on periodic paths, so that pool frame P follows frame
    P - 1 smoothly. The same seed gives the same frames, boxes and samples;
    another seed, other positions, colours and paths of the same sizes."""
    b, o = int(traffic["streams"]), int(traffic["objects_per_stream"])
    p, s = int(traffic["pool_frames"]), int(image_size)
    rng = np.random.default_rng(int(seed) % (1 << 63))
    g = _generator(int(rng.integers(1 << 62)), device)
    r_lo, r_hi = traffic["radius_px"]
    radius = rng.uniform(r_lo, r_hi, (b, o))
    amp = rng.uniform(0.05, float(traffic["path_amplitude"]), (b, o, 2)) * s
    centre = rng.uniform(0.25, 0.75, (b, o, 2)) * s
    phase = rng.uniform(0, 2 * np.pi, (b, o, 2))
    cycles = rng.integers(1, 3, (b, o, 2))
    colour = rng.integers(40, 256, (b, o, 3))
    pan = rng.integers(-int(traffic["pan_px"]), int(traffic["pan_px"]) + 1, (b, 2))

    t = np.arange(p)[:, None, None, None]
    pos = centre + amp * np.sin(2 * np.pi * cycles * t / p + phase)  # [P, B, O, 2]
    pinned = torch.device(device).type == "cuda"
    pool = torch.empty((p, b, s, s, 3), dtype=torch.uint8, pin_memory=pinned)
    yy = torch.arange(s, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(s, device=device, dtype=torch.float32)[None, :]
    for v in range(b):
        tex = torch.rand((1, 3, 16, 16), generator=g, device=device)
        tex = torch.nn.functional.interpolate(tex, size=(s, s), mode="bilinear",
                                              align_corners=False)[0]
        tex = tex * 90 + torch.rand((3, s, s), generator=g, device=device) * 40
        for i in range(p):
            shift = [int(round(float(pan[v, a]) * np.sin(2 * np.pi * i / p))) for a in (0, 1)]
            frame = torch.roll(tex, shifts=shift, dims=(1, 2)).clone()
            for j in range(o):
                x, y = float(pos[i, v, j, 0]), float(pos[i, v, j, 1])
                disc = (xx - x) ** 2 + (yy - y) ** 2 <= float(radius[v, j]) ** 2
                c = torch.tensor(colour[v, j], device=device, dtype=torch.float32)
                frame = torch.where(disc[None], c[:, None, None], frame)
            pool[i, v].copy_(frame.clamp_(0, 255).to(torch.uint8).permute(1, 2, 0))
    x0 = pos[0, :, :, 0] - radius
    y0 = pos[0, :, :, 1] - radius
    boxes = np.stack([x0, y0, x0 + 2 * radius, y0 + 2 * radius], -1).clip(0, s - 1)
    # one sampled row in each of `sample_rows` equal slices of the object axis
    n = b * o
    k = int(traffic["sample_rows"])
    edges = np.linspace(0, n, k + 1).astype(int)
    rows = np.array([rng.integers(lo, hi) for lo, hi in zip(edges[:-1], edges[1:])])
    keep = np.nonzero(rng.random(int(traffic["max_steps"])) < float(traffic["keep_share"]))[0]
    return Traffic(pool=pool, boxes=boxes.astype(np.float32), rows=rows,
                   keep_steps=keep)
