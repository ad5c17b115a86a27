"""BatchedVideoStreamer: lockstep tracking of B independent video streams.

Counterpart of the JAX package's ``batched.py``. Instead of running B videos
as B single-video sessions (B times the launches and the per-operation
floors), the streamer owns ONE merged MemoryBank whose object axis is every
video's objects concatenated (video v owns the contiguous rows
``sum(counts[:v]) .. + counts[v]``) and drives
``SAM2Engine.propagate_window_batched``: each step encodes the B frames in
one batched trunk call, and the per-(slot, object) validity of the bank
keeps each video's memory reads and writes its own.

The reference serves one video per predictor session; this module is an
extension for serving many streams on one card, not a parity item.

Lockstep contract:
  * all videos share one frame clock: step t of a window is frame
    ``frame_indices[t]`` of EVERY video;
  * prompts are init prompts (``is_init=True``); correction clicks on
    tracked frames are not supported batched: run those videos in their
    own session;
  * ``non_overlap_masks_for_mem_enc`` must be off (it is off in every
    reference config): it would couple objects across videos.

The streamer runs on its engine's device; its bank lives there and is
updated in place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from det_sam2_tpu_torch import state as bank_ops
from det_sam2_tpu_torch.configs import SAM2Config
from det_sam2_tpu_torch.track import SAM2Engine
from det_sam2_tpu_torch.utils.profiling import spanned


class BatchedVideoStreamer:
    """Drives B videos through one merged-bank engine in lockstep.

    counts: per-video object counts (fixed). The merged bank has
    ``sum(counts)`` object rows; per-video outputs are recovered with
    :meth:`split`.
    """

    def __init__(self, engine: SAM2Engine, counts: Sequence[int]):
        cfg: SAM2Config = engine.cfg
        if cfg.non_overlap_masks_for_mem_enc and len(counts) > 1:
            raise NotImplementedError(
                "non_overlap_masks_for_mem_enc couples objects across "
                "videos; disable it for batched streaming"
            )
        self.engine = engine
        self.cfg = cfg
        self.counts: Tuple[int, ...] = tuple(int(c) for c in counts)
        if any(c <= 0 for c in self.counts):
            raise ValueError(f"every video needs >=1 object: {self.counts}")
        self.num_videos = len(self.counts)
        self.num_objects = int(sum(self.counts))
        self.row_offsets = np.concatenate(
            [[0], np.cumsum(self.counts)]
        ).astype(int)
        self.bank = bank_ops.init_bank(
            cfg, self.num_objects, dtype=engine.dtype, attend_cond_tiles=1,
            banked_layers=engine.banked_layers, device=engine.device,
        )
        # distinct prompted frame indices, per video; the cond tiles attended
        # are selected across the videos by frame distance, so their count
        # must cover the union of the live prompt frames
        self.prompt_frames: List[set] = [set() for _ in self.counts]

    # ------------------------------------------------------------------

    def _rows(self, video: int) -> slice:
        return slice(self.row_offsets[video], self.row_offsets[video + 1])

    def _refresh_cond_tiles(self) -> None:
        live = len(set().union(*self.prompt_frames)) or 1
        self.bank.attend_cond_tiles = bank_ops.cond_tile_bucket(self.cfg, live)

    def encode_frames(self, frames):
        """frames [B, H, W, 3] uint8 at model resolution -> the batched
        feature tuple (one trunk call for all B videos)."""
        if frames.shape[0] != self.num_videos:
            raise ValueError(
                f"expected {self.num_videos} frames, got {frames.shape[0]}"
            )
        return self.engine.encode_image(frames)

    def add_prompts(
        self,
        frame_idx: int,
        num_frames: int,
        frames,
        prompts: Dict[int, Tuple[np.ndarray, np.ndarray]],
        feats=None,
    ) -> Dict[int, dict]:
        """Init-prompt a subset of the videos at one shared frame index.

        frames [B, H, W, 3] uint8 (every video's frame at ``frame_idx``; the
        frames of videos not prompted only fill inert feature rows of the
        masked cond write). prompts maps video -> (points [O_v, P, 2] in
        model pixels, labels [O_v, P]); boxes use the corner labels (2, 3),
        pad rows label -1. Returns the prompt outputs per video.

        prompt_step runs PER VIDEO so the multimask choice by that video's
        point count stays the single-session behaviour; the cond-bank write
        is one merged ``encode_cond_memory`` with only the prompted videos'
        rows valid.
        """
        if not prompts:
            # an empty call would still take a cond slot (all rows invalid)
            # that the frame-distance selection could pick over a real cond
            # frame when tiles are tight
            raise ValueError(
                "add_prompts called with an empty prompts dict; prompt at "
                "least one video or skip the call"
            )
        bad = set(prompts) - set(range(self.num_videos))
        if bad:
            raise ValueError(f"unknown video ids {sorted(bad)}")
        for v, (pts, labels) in prompts.items():
            if pts.shape[0] != self.counts[v]:
                raise ValueError(
                    f"video {v}: {pts.shape[0]} prompt rows for "
                    f"{self.counts[v]} objects"
                )
        # the cond tiles attended are chosen across the videos by frame
        # distance, at most min(cond_attn_size, cond_bank_size) of them: a
        # union of live prompt frames beyond that would silently drop a
        # video's only cond frame
        cap = min(self.cfg.cond_attn_size, self.cfg.cond_bank_size)
        union = set().union(*self.prompt_frames) | {int(frame_idx)}
        if len(union) > cap:
            raise ValueError(
                f"{len(union)} distinct prompt frames across videos exceed "
                f"the {cap} cond tiles this bank can attend/store "
                f"(min(cond_attn_size={self.cfg.cond_attn_size}, "
                f"cond_bank_size={self.cfg.cond_bank_size})); split the "
                f"videos across sessions"
            )
        if feats is None:
            feats = self.encode_frames(frames)

        cfg, dev = self.cfg, self.engine.device
        s4 = cfg.image_size // 4
        low = torch.zeros((self.num_objects, 1, s4, s4), dtype=torch.float32, device=dev)
        logits = torch.zeros((self.num_objects, 1), dtype=torch.float32, device=dev)
        ptr = torch.zeros((self.num_objects, cfg.hidden_dim), dtype=torch.float32,
                          device=dev)
        valid = np.zeros((self.num_objects,), bool)
        outs: Dict[int, dict] = {}
        for v, (pts, labels) in sorted(prompts.items()):
            feats_v = tuple(f[v:v + 1] for f in feats)
            out = self.engine.prompt_step(
                feats_v, self.bank, frame_idx, num_frames,
                np.asarray(pts, np.float32), np.asarray(labels, np.int32),
                is_init=True,
            )
            rows = self._rows(v)
            low[rows] = out["pred_masks"].float()
            logits[rows] = out["object_score_logits"].float()
            ptr[rows] = out["obj_ptr"].float()
            valid[rows] = True
            outs[v] = out
            self.prompt_frames[v].add(int(frame_idx))

        # Calls at the SAME frame for different video subsets must not undo
        # each other: write_cond matches the existing cond slot and replaces
        # its rows wholesale, so the rows of videos prompted at this frame
        # before (and not now) are copied out and put back after the write.
        keep_rows = np.zeros((self.num_objects,), bool)
        for v in range(self.num_videos):
            if v not in prompts and int(frame_idx) in self.prompt_frames[v]:
                keep_rows[self._rows(v)] = True
        old_slot = None
        bank = self.bank
        if keep_rows.any():
            hits = np.where(bank.cond_frame_idx.cpu().numpy() == int(frame_idx))[0]
            if hits.size:  # guaranteed by the cap check above
                s = int(hits[0])
                # copies: the write below overwrites the slot in place
                old_slot = (
                    bank.cond_mem[s].clone(),
                    bank.cond_ptr[s].clone(),
                    bank.cond_obj_valid[s].clone(),
                    None if bank.mem_k is None else bank.mem_k[s].clone(),
                    None if bank.mem_v is None else bank.mem_v[s].clone(),
                )

        feat_rows = feats  # one video: a batch of 1, broadcast over its rows
        if self.num_videos > 1:
            rows = torch.as_tensor(np.repeat(np.arange(self.num_videos), self.counts),
                                   device=dev)
            feat_rows = tuple(f.index_select(0, rows) for f in feats)
        self._refresh_cond_tiles()
        self.engine.encode_cond_memory(
            feat_rows, bank, frame_idx, low, logits, ptr,
            is_mask_from_pts=True, obj_valid=valid,
        )
        if old_slot is not None:
            old_mem, old_ptr, old_valid, old_mk, old_mv = old_slot
            sel = torch.as_tensor(keep_rows, device=dev)
            # cond slot s is row s of the banked-attention caches (state.py)
            if old_mk is not None:
                bank.mem_k[s] = torch.where(sel[:, None, None, None], old_mk,
                                            bank.mem_k[s])
                bank.mem_v[s] = torch.where(sel[:, None, None], old_mv, bank.mem_v[s])
            bank.cond_mem[s] = torch.where(sel[:, None, None], old_mem, bank.cond_mem[s])
            bank.cond_ptr[s] = torch.where(sel[:, None], old_ptr, bank.cond_ptr[s])
            bank.cond_obj_valid[s] |= sel & old_valid
        return outs

    # ------------------------------------------------------------------

    @spanned("streamer.window")
    def propagate_window(
        self,
        frames,
        frame_indices: Sequence[int],
        num_frames: int,
        reverse: bool = False,
        obj_valid: Optional[np.ndarray] = None,
    ):
        """Track one lockstep window.

        frames [T, B, H, W, 3] uint8; frame_indices [T] the shared clock.
        A step that is a prompted frame of a video is skipped for THAT video
        (zero rows in its output: reuse the stored prompt outputs); a step
        prompted for EVERY video uploads nothing and runs nothing. Returns
        (pred_masks [T, O_total, 1, s4, s4] fp16, obj_ptr [T, O_total, C],
        object_score_logits [T, O_total, 1], skips [T, B]) on the engine's
        device (skips on the host); split the object axis with
        :meth:`split`. The whole call is the ``streamer.window`` span, a
        step of its own when no span is around it.
        """
        frame_indices = np.asarray(frame_indices, np.int32)
        t = len(frame_indices)
        if tuple(frames.shape[:2]) != (t, self.num_videos):
            raise ValueError(
                f"frames {tuple(frames.shape[:2])} != (T={t}, B={self.num_videos})"
            )
        skips = np.zeros((t, self.num_videos), bool)
        for v in range(self.num_videos):
            for i, f in enumerate(frame_indices):
                if int(f) in self.prompt_frames[v]:
                    skips[i, v] = True
        run = ~skips.all(axis=1)  # steps where at least one video runs
        img_idx = np.zeros((t,), np.int32)
        img_idx[run] = np.arange(int(run.sum()), dtype=np.int32)
        images = frames[torch.as_tensor(run, device=frames.device)
                        if torch.is_tensor(frames) else run]
        self.bank, (low, ptr, logits) = self.engine.propagate_window_batched(
            images, self.bank, frame_indices, skips, num_frames,
            self.counts, reverse=reverse, obj_valid=obj_valid,
            img_idx=img_idx,
        )
        return low, ptr, logits, skips

    def split(self, stacked, axis: int = 1):
        """Split the merged object axis into per-video views. Window outputs
        are [T, O_total, ...] (axis=1, the default); pass axis=0 for
        single-frame [O_total, ...] arrays."""
        if stacked.shape[axis] != self.num_objects:
            raise ValueError(
                f"axis {axis} has {stacked.shape[axis]} rows, expected "
                f"{self.num_objects}"
            )
        lead = (slice(None),) * axis
        return [stacked[lead + (self._rows(v),)] for v in range(self.num_videos)]
