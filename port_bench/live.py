"""The system under test, driven as a live server: B camera streams tracked
in lockstep by det_sam2_tpu_torch's BatchedVideoStreamer, one closed-loop
step a frame.

A step hands over each stream's next frame [1, B, S, S, 3] uint8 (copied
from the host pool to the card), runs ``propagate_window`` (T = 1: one
batched trunk call, memory attention, the SAM heads, memory encoding and the
bank write for every object row, then hole filling), resizes the low-res
mask logits to the video's size with the port's cv2-exact ``mask_resize``
kernel (a stream's objects as the channels of one cv2 call), thresholds
them at 0 on the card and reads the masks back to the host as bool. The
next step starts once they are there.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from port_bench import cells


def build_engine(port_cfg, sd, dtype, device, banked: bool, int8: bool = False):
    """A SAM2Engine over the given state dict, built on ``device`` (no host
    copy of the weights), with banked memory attention (K2) or not. int8:
    the port's W8A8 int8 trunk (``ops.quant.quantize_trunk``), its own
    lower-precision path."""
    import dataclasses

    from det_sam2_tpu_torch.ops import quant
    from det_sam2_tpu_torch.track import SAM2Engine

    if int8:
        port_cfg = dataclasses.replace(
            port_cfg, hiera=dataclasses.replace(port_cfg.hiera, quantize_int8=True))
        sd = quant.quantize_trunk(sd, skip=port_cfg.hiera.quant_skip)
    with torch.device(device):
        return SAM2Engine(port_cfg, params=sd, dtype=dtype, device=device, banked=banked)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class LiveStreams:
    """The streamer over B streams of O objects, prompted on frame 0 and
    stepped frame by frame. Records, for the comparison, the sampled rows'
    low-res logits and object pointers at every step, and at the steps of
    ``traffic.keep_steps`` their bool masks and their streams' features
    (a forward hook on the image encoder)."""

    def __init__(self, engine, traffic: cells.Traffic, conf: dict, device):
        from det_sam2_tpu_torch.batched import BatchedVideoStreamer

        self.engine = engine
        self.device = torch.device(device)
        self.t = traffic
        self.num_frames = int(conf["num_frames"])
        self.video_hw = tuple(int(x) for x in conf["video_hw"])
        p, b = traffic.pool.shape[:2]
        o = traffic.boxes.shape[1]
        self.b, self.o, self.p = b, o, p
        self.streamer = BatchedVideoStreamer(engine, [o] * b)
        s = traffic.pool.shape[2]
        self.frames = torch.empty((1, b, s, s, 3), dtype=torch.uint8, device=self.device)
        cuda = self.device.type == "cuda"
        self.masks = torch.empty((b * o, *self.video_hw), dtype=torch.bool, pin_memory=cuda)
        self.rows = torch.as_tensor(traffic.rows, device=self.device)
        self.keep = set(int(k) for k in traffic.keep_steps)
        self.low: List[torch.Tensor] = []
        self.ptrs: List[torch.Tensor] = []
        self.kept = {}
        self.feats = {}
        self.k = 0
        o_streams = sorted(set(int(r) // o for r in traffic.rows))
        self._streams = torch.as_tensor(o_streams, device=self.device)
        self._hook = engine.model.image_encoder.register_forward_hook(self._keep_feats)

    def _keep_feats(self, _module, _args, fpn):
        """At a kept step: the sampled streams' stride-16 FPN features (the
        level memory attention reads) as the trunk and neck produced them."""
        if self.k in self.keep:
            self.feats[self.k] = fpn[-1].index_select(0, self._streams)

    def prompt(self) -> None:
        """Frame 0: one box an object, every stream (``add_prompts``)."""
        frames = self.t.pool[0].to(self.device)
        labels = np.tile(np.array([[2, 3]], np.int32), (self.o, 1))
        prompts = {v: (self.t.boxes[v].reshape(self.o, 2, 2), labels) for v in range(self.b)}
        self.streamer.add_prompts(0, self.num_frames, frames, prompts)

    def step(self) -> float:
        """One live step at the next frame index; returns the host seconds
        from the hand-over to propagate_window's return."""
        from det_sam2_tpu_torch.ops.mask_resize import resize_masks_cv2

        self.k += 1
        k = self.k
        t0 = time.perf_counter()
        self.frames[0].copy_(self.t.pool[k % self.p], non_blocking=True)
        low, ptr, _, _ = self.streamer.propagate_window(self.frames, [k], self.num_frames)
        dispatch = time.perf_counter() - t0
        masks = resize_masks_cv2(low[0], self.video_hw, group=self.o)
        self.masks.copy_(masks[:, 0] > 0, non_blocking=True)
        self.low.append(low[0].index_select(0, self.rows))
        self.ptrs.append(ptr[0].index_select(0, self.rows))
        sync(self.device)
        if k in self.keep:
            self.kept[k] = self.masks[self.t.rows].numpy().copy()
        return dispatch

    def close(self) -> dict:
        """The records the comparison reads, on the host, and the program's
        state freed."""
        self._hook.remove()
        rec = dict(low=torch.stack(self.low)[:, :, 0].float().cpu().numpy(),
                   ptrs=torch.stack(self.ptrs).float().cpu().numpy(),
                   kept=self.kept, feats={k: v.cpu() for k, v in self.feats.items()},
                   steps=self.k)
        self.streamer = self.engine = None
        self.feats = {}
        self.low, self.ptrs = [], []
        return rec


def window(live: LiveStreams, seconds: float):
    """Steps until ``seconds`` have passed (the step under way finishes).
    Returns (each step's seconds from hand-over to masks on the host, the
    window's seconds)."""
    lat = []
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        live.step()
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if t1 - start >= seconds:
            return np.array(lat), t1 - start
