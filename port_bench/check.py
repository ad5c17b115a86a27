"""The comparison that decides ``correct``, and its lower-precision control.

Once the window has closed and the program's state is freed, the plain fp32
reference (``reference/``, TF32 off) is given the run's weights, frames and
box prompts, tracks the sampled object rows from frame 0 through the last
step the program ran, and rebuilds its own memory as it goes. Against what
the program produced for those rows and their streams it computes:

  ptr_err        sum |program - reference| / sum |reference| of the object
                 pointers, over every sampled row and step: the trunk and
                 neck, memory attention over the bank the program wrote and
                 selected (the memory encoder's memories of the frames
                 before, their pointers), the SAM heads and the pointer
                 projection all feed it, step after step.
  feat_err       the same ratio for the image encoder's stride-16 features
                 (the FPN level memory attention reads) of the sampled rows'
                 streams, at the kept steps: the trunk and neck alone.
  holes_left     pixels of the program's low-res logits that SAM 2's hole
                 filling would still change (background components of at
                 most fill_hole_area pixels): 0 where the fill ran, over
                 every sampled row and step.
  resize_exact   at the kept steps: pixels where the program's bool mask
                 differs from the program's own low-res logits resized by
                 cv2's arithmetic, > 0. The kernel computes cv2's bits, so
                 the limit is 0.

Printed beside them and not compared: the same ratio for the hole-filled
low-res mask logits, per sampled row (``logit_err``), and the share of
video-size pixels where the program's and the reference's bool masks differ
at the kept steps (``mask_disagree``). With random weights the mask logits
are sums that cancel to a few hundredths, and how deeply they cancel is set
by the weight draw: the logits' relative error in one precision moves
six-fold from seed to seed, alike in every row of a seed, and how many
pixels sit within rounding of 0 moves with it, more than the precisions
differ (PERF.md gives the readings).

The control (``control_record``) is the reference itself put in the
program's place with every matrix product and convolution taking operands
rounded to fp8 (e4m3, one scale a tensor): the precision below the
configuration's bf16.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from port_bench import cells
from port_bench.reference import configs as ref_configs
from port_bench.reference import cv2_resize
from port_bench.reference.holes import fill_holes
from port_bench.reference.sam2_base import SAM2Model
from port_bench.reference.tracker import RowTracker

# the compared numbers, each with a limit in limits/<workload>.json
NUMBERS = ("ptr_err", "feat_err", "holes_left", "resize_exact")


def resize_bool(low: np.ndarray, out_hw, group: int) -> np.ndarray:
    """cv2.resize of one mask's logits [h, w] to out_hw, as cv2 computes it
    for a call of ``group`` channels (IPP at 1, its generic path from 5; a
    channel's result does not depend on the others there), > 0."""
    if group in (3, 4):
        raise NotImplementedError("IPP's 3- and 4-channel border rule depends on the channel")
    x = torch.from_numpy(np.ascontiguousarray(low, np.float32))[None]
    out = torch.empty((1, int(out_hw[0]), int(out_hw[1])), dtype=torch.float32)
    path = cv2_resize._ipp_chw if group == 1 else cv2_resize._generic_chw
    return path(x, out)[0].numpy() > 0


def reference_model(conf: dict, seed: int, device):
    """The reference's fp32 model over the run's weights, made again from the
    seed (the program's copy was freed with its state)."""
    ref_cfg = cells.model_config(ref_configs, conf)
    dtype = cells.DTYPES[conf["engine"]["dtype"]]
    sd = cells.seeded_weights(ref_cfg, seed, device, dtype, conf["assumed"])
    with torch.device(device):
        model = SAM2Model(ref_cfg, dtype=torch.float32)
    model.load_state_dict({k: v.float() for k, v in sd.items()})
    return ref_cfg, model.eval()


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for the reference's products."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def sample_streams(traffic: cells.Traffic):
    """The sorted streams of the sampled rows."""
    o = traffic.boxes.shape[1]
    return sorted(set(int(r) // o for r in traffic.rows))


@torch.no_grad()
def follow(model, cfg, traffic: cells.Traffic, num_frames: int, steps: int, device):
    """Track the sampled rows with the reference from frame 0 through frame
    ``steps``. Yields (k, hole-filled low-res logits [R, h, w] and object
    pointers [R, C] on the host, the streams' stride-16 features [n, s, s,
    C])."""
    p, b = traffic.pool.shape[:2]
    o = traffic.boxes.shape[1]
    streams = sample_streams(traffic)
    which = torch.as_tensor([streams.index(int(r) // o) for r in traffic.rows], device=device)
    cache: Dict[int, tuple] = {}

    def feats(i: int):
        if i not in cache:
            f = model.forward_image(traffic.pool[i][streams].to(device))
            cache[i] = (tuple(x.index_select(0, which) for x in f), f[2])
        return cache[i]

    tracker = RowTracker(model, cfg, num_frames)
    tracker.prompt(feats(0)[0], traffic.boxes.reshape(b * o, 4)[traffic.rows])
    for k in range(1, steps + 1):
        rows_f, stream_f = feats(k % p)
        low, ptr = tracker.track(k, rows_f)
        yield k, low[:, 0].cpu().numpy(), ptr.float().cpu().numpy(), stream_f


def compare(conf: dict, traffic_conf: dict, traffic: cells.Traffic, rec: dict,
            seed: int, device) -> Dict[str, float]:
    """The four numbers of the module docstring for one run's record."""
    with fp32_exact():
        cfg, model = reference_model(conf, seed, device)
        hw, group = traffic_conf["video_hw"], traffic.boxes.shape[1]
        rows = len(traffic.rows)
        diff, mag = np.zeros(rows), np.zeros(rows)
        pdiff = pmag = fdiff = fmag = 0.0
        disagree = mismatch = pixels = holes = 0
        area = cfg.fill_hole_area
        for k, ref, ref_ptr, stream_f in follow(
                model, cfg, traffic, int(traffic_conf["num_frames"]), rec["steps"], device):
            got = rec["low"][k - 1]
            diff += np.abs(got - ref).sum((1, 2))
            mag += np.abs(ref).sum((1, 2))
            holes += sum(np.count_nonzero(fill_holes(g, area) != g) for g in got)
            pdiff += float(np.abs(rec["ptrs"][k - 1] - ref_ptr).sum())
            pmag += float(np.abs(ref_ptr).sum())
            if k in rec["feats"]:
                f = rec["feats"][k].to(device).float()
                fdiff += float((f - stream_f).abs().sum())
                fmag += float(stream_f.abs().sum())
            if k in rec["kept"]:
                masks = rec["kept"][k]
                for i in range(rows):
                    disagree += np.count_nonzero(resize_bool(ref[i], hw, group) != masks[i])
                    mismatch += np.count_nonzero(resize_bool(got[i], hw, group) != masks[i])
                    pixels += masks[i].size
    print(f"[check] not compared: mask_disagree {float(disagree / max(pixels, 1))!r}, "
          f"logit_err by row {(diff / mag).round(5).tolist()}", file=sys.stderr)
    return {"ptr_err": pdiff / pmag, "feat_err": fdiff / max(fmag, 1e-30),
            "holes_left": float(holes), "resize_exact": float(mismatch)}


# ---------------------------------------------------------------------------
# the control: the reference in fp8 in the program's place
# ---------------------------------------------------------------------------

E4M3_MAX = 448.0


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 with one scale for the tensor (its largest
    magnitude maps to e4m3's largest finite value), back in x's dtype."""
    x32 = x.float()
    scale = x32.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return ((x32 / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


@contextlib.contextmanager
def fp8_operands():
    """Every matrix product, convolution and attention of the code run
    inside takes fp8-rounded operands (torch's functions are swapped for the
    duration and put back)."""
    saved = (F.linear, F.conv2d, F.conv_transpose2d, torch.matmul,
             F.scaled_dot_product_attention)
    lin, conv, convt, mm, sdpa = saved

    def q(x):
        return to_e4m3(x) if torch.is_tensor(x) and x.is_floating_point() else x

    F.linear = lambda x, w, b=None: lin(q(x), q(w), b)
    F.conv2d = lambda x, w, b=None, *a, **k: conv(q(x), q(w), b, *a, **k)
    F.conv_transpose2d = lambda x, w, b=None, *a, **k: convt(q(x), q(w), b, *a, **k)
    torch.matmul = lambda a, b, **k: mm(q(a), q(b), **k)
    F.scaled_dot_product_attention = lambda qq, kk, vv, *a, **k: sdpa(q(qq), q(kk), q(vv), *a, **k)
    try:
        yield
    finally:
        (F.linear, F.conv2d, F.conv_transpose2d, torch.matmul,
         F.scaled_dot_product_attention) = saved


def control_record(conf: dict, traffic_conf: dict, traffic: cells.Traffic, seed: int,
                   steps: int, device) -> dict:
    """What the control produces in the program's place over ``steps``
    steps of the sampled rows: the record ``compare`` reads."""
    hw, group = traffic_conf["video_hw"], traffic.boxes.shape[1]
    keep = set(int(k) for k in traffic.keep_steps)
    rec = {"low": [], "ptrs": [], "kept": {}, "feats": {}, "steps": steps}
    with fp32_exact(), fp8_operands():
        cfg, model = reference_model(conf, seed, device)
        for k, low, ptr, stream_f in follow(model, cfg, traffic,
                                            int(traffic_conf["num_frames"]), steps, device):
            rec["low"].append(low)
            rec["ptrs"].append(ptr)
            if k in keep:
                rec["kept"][k] = np.stack([resize_bool(m, hw, group) for m in low])
                rec["feats"][k] = stream_f.cpu()
    return rec
