"""SAM2VideoPredictor: the host-side streaming state machine.

Counterpart of the JAX package's ``video_predictor.py``, with the same API:
init_state (with async_loading_frames), update_state, reset_state,
add_new_points_or_box, add_new_mask, propagate_in_video (+ preflight),
release_old_frames, save_session / load_session_as_preload (the preload
memory bank), remove_object, clear_all_prompts_in_frame.

  * device state = one fixed-shape MemoryBank (``state.py``) on the engine's
    device, updated in place by the SAM2Engine steps;
  * host state = numpy dicts of per-frame outputs (low-res mask logits fp16,
    pointers, scores) for consolidation and the user-facing results;
  * frames = resized uint8 host frames, each uploaded once to the device
    (``frames_dev``), both evicted by release_old_frames;
  * object slots are padded to a power-of-two bucket; a new object
    mid-stream grows the bucket and re-consolidates recent cond frames.

Propagation reads the device back once a pass: the window (or the per-frame
loop) queues every step on the device and the outputs come back in one
download, then are stored and yielded frame by frame.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import pickle
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from det_sam2_tpu_torch import state as bank_ops
from det_sam2_tpu_torch.configs import SAM2Config
from det_sam2_tpu_torch.modeling.sam2_base import (
    NO_OBJ_SCORE,
    apply_non_overlapping_constraints,
    resize_bilinear,
)
from det_sam2_tpu_torch.ops.mask_resize import resize_masks_cv2
from det_sam2_tpu_torch.track import SAM2Engine
from det_sam2_tpu_torch.utils.cv2_resize import MASK_GROUP
from det_sam2_tpu_torch.utils.misc import (
    AsyncFrameLoader,
    concat_points,
    list_frame_dir,
    load_video_frames,
    to_host,
)


def _bucket(n: int) -> int:
    return bank_ops.next_pow2(n)


class _LazyFrames(dict):
    """session.frames backed by an AsyncFrameLoader: every index is a member
    from the start (propagation's availability checks see the whole video),
    but the pixels materialise on first access, blocking only until the
    background decode catches up."""

    def __init__(self, loader):
        super().__init__((i, None) for i in range(len(loader)))
        self._loader = loader

    def _materialize(self, k):
        v = dict.get(self, k)
        if v is None and k in self:
            v = self._loader[k]
            dict.__setitem__(self, k, v)
        return v

    def get(self, k, default=None):
        if k not in self:
            return default
        return self._materialize(k)

    def __getitem__(self, k):
        if k not in self:
            raise KeyError(k)
        return self._materialize(k)

    def values(self):  # only materialised frames have bytes
        return [v for v in dict.values(self) if v is not None]

    def materialized(self) -> dict:
        """Plain dict with every remaining frame decoded (for pickling)."""
        return {k: self._materialize(k) for k in list(self.keys())}


class InferenceSession:
    """All per-video state (SAM 2's ``inference_state``)."""

    def __init__(self, cfg: SAM2Config, video_height: int, video_width: int):
        self.cfg = cfg
        self.video_height = video_height
        self.video_width = video_width
        self.frames: Dict[int, np.ndarray] = {}
        # device-resident frames: each uploads once and serves every window
        # that covers it
        self.frames_dev: Dict[int, torch.Tensor] = {}
        self.num_frames = 0
        self.obj_id_to_idx: "collections.OrderedDict[int, int]" = (
            collections.OrderedDict()
        )
        self.obj_idx_to_id: Dict[int, int] = {}
        self.bank: Optional[bank_ops.MemoryBank] = None  # made at the first object
        self.bank_objs = 0
        # frame -> {"pred_masks" [O,1,s4,s4] fp16, "obj_ptr" [O,C] fp32,
        #           "object_score_logits" [O,1], "valid" [O] bool}
        self.cond_outputs: Dict[int, dict] = {}
        self.noncond_outputs: Dict[int, dict] = {}
        # obj_idx -> frame -> single-row dict (same keys, leading dim 1)
        self.temp_cond: Dict[int, Dict[int, dict]] = collections.defaultdict(dict)
        self.temp_noncond: Dict[int, Dict[int, dict]] = collections.defaultdict(dict)
        self.point_inputs_per_obj: Dict[int, Dict[int, dict]] = (
            collections.defaultdict(dict)
        )
        self.mask_inputs_per_obj: Dict[int, Dict[int, np.ndarray]] = (
            collections.defaultdict(dict)
        )
        self.frames_already_tracked: Dict[int, dict] = {}
        # released tracked frames as merged (start, end, reverse, seq)
        # intervals: a correction on an old frame must still count as
        # tracked, at O(1) memory on endless streams; seq (a compaction
        # stamp) lets a newer overlapping range win in tracked_info
        self.tracked_ranges: List[Tuple[int, int, bool, int]] = []
        self._compact_seq = 0
        # prompted non-cond frames whose outputs propagation reuses
        self.consolidated_noncond: set = set()
        self.tracking_has_started = False
        self.pre_frames = 0  # preload memory bank frame count
        self.preload_cond_indices: List[int] = []
        self._feat_cache: Optional[Tuple[int, tuple]] = None
        # frame_idx -> empty-mask pointer computed from that frame's features
        self._empty_ptr: Dict[int, np.ndarray] = {}

    def tracked_info(self, frame_idx: int) -> Optional[dict]:
        """{'reverse': bool} if frame_idx was ever tracked (live dict or a
        compacted released range), else None."""
        row = self.frames_already_tracked.get(frame_idx)
        if row is not None:
            return row
        best = None
        for s, e, rev, seq in self.tracked_ranges:
            if s <= frame_idx <= e and (best is None or seq > best[1]):
                best = (rev, seq)
        return None if best is None else {"reverse": best[0]}

    def compact_tracked(self, upto_idx: int) -> None:
        """Move frames_already_tracked entries with idx <= upto_idx into
        merged tracked_ranges (called by release_old_frames)."""
        moved = [t for t in self.frames_already_tracked if t <= upto_idx]
        if not moved:
            return
        self._compact_seq += 1
        for t in moved:
            rev = bool(self.frames_already_tracked.pop(t)["reverse"])
            self.tracked_ranges.append((t, t, rev, self._compact_seq))
        self.tracked_ranges.sort(key=lambda r: r[:2])
        merged: List[Tuple[int, int, bool, int]] = []
        for s, e, rev, seq in self.tracked_ranges:
            if merged and merged[-1][2] == rev and s <= merged[-1][1] + 1:
                ps, pe, prev, pseq = merged[-1]
                merged[-1] = (ps, max(pe, e), prev, max(pseq, seq))
            else:
                merged.append((s, e, rev, seq))
        self.tracked_ranges = merged

    @property
    def obj_ids(self) -> List[int]:
        return list(self.obj_id_to_idx.keys())

    @property
    def num_objects(self) -> int:
        return len(self.obj_id_to_idx)


class SAM2VideoPredictor:
    def __init__(
        self,
        engine: SAM2Engine,
        non_overlap_masks: bool = False,
        clear_non_cond_mem_around_input: bool = False,
        clear_non_cond_mem_for_multi_obj: bool = False,
        add_all_frames_to_correct_as_cond: bool = False,
        max_update_length_for_new_obj_id: int = 100,
        mask_resize: str = "host",  # 'host' (cv2's bits) | 'device'
    ):
        """The predictor runs on the engine's device (the engine defaults
        to CUDA). mask_resize names the JAX package's two ways to resize
        masks to video resolution: "host" is its cv2.resize, whose bits the
        port computes on the engine's device (``ops.mask_resize``: the
        hand-written kernel on CUDA, the numpy rebuild on the CPU); "device"
        is its on-device bilinear (F.interpolate's weights)."""
        self.engine = engine
        self.cfg = engine.cfg
        self.image_size = engine.cfg.image_size
        self.non_overlap_masks = non_overlap_masks
        self.clear_non_cond_mem_around_input = clear_non_cond_mem_around_input
        self.clear_non_cond_mem_for_multi_obj = clear_non_cond_mem_for_multi_obj
        self.add_all_frames_to_correct_as_cond = add_all_frames_to_correct_as_cond
        self.max_update_length_for_new_obj_id = max_update_length_for_new_obj_id
        self.mask_resize = mask_resize

    # ------------------------------------------------------------------
    # state lifecycle
    # ------------------------------------------------------------------

    def init_state(
        self,
        video_path: Union[str, List, np.ndarray],
        video_height: Optional[int] = None,
        video_width: Optional[int] = None,
        async_loading_frames: bool = False,
    ) -> InferenceSession:
        """Load the frames and build a fresh session. With
        async_loading_frames, a frame-dir / path-list source decodes on a
        background thread and tracking starts at once."""
        if async_loading_frames:
            paths = None
            if isinstance(video_path, str) and os.path.isdir(video_path):
                paths = list_frame_dir(video_path)
            elif isinstance(video_path, list) and video_path and isinstance(
                video_path[0], str
            ):
                paths = list(video_path)
            if paths:
                loader = AsyncFrameLoader(paths, self.image_size)
                loader[0]  # sets video_height/width, surfaces bad paths now
                session = InferenceSession(
                    self.cfg,
                    video_height or loader.video_height,
                    video_width or loader.video_width,
                )
                session.frames = _LazyFrames(loader)
                session.num_frames = len(loader)
                self._get_feats(session, 0)
                return session
            # ndarray sources are already decoded: fall through
        frames, h, w = load_video_frames(video_path, self.image_size)
        session = InferenceSession(self.cfg, video_height or h, video_width or w)
        for i, f in enumerate(frames):
            session.frames[i] = f
        session.num_frames = len(frames)
        self._get_feats(session, 0)  # warm up the encoder on frame 0
        return session

    def update_state(
        self, video_path: Union[str, List, np.ndarray], session: InferenceSession
    ) -> InferenceSession:
        """Streaming append of new frames."""
        frames, h, w = load_video_frames(video_path, self.image_size)
        assert (h, w) == (session.video_height, session.video_width), (
            "appended frames must match the session video size"
        )
        start = session.num_frames
        for i, f in enumerate(frames):
            session.frames[start + i] = f
        session.num_frames = start + len(frames)
        return session

    def reset_state(self, session: InferenceSession) -> None:
        fresh = InferenceSession(self.cfg, session.video_height, session.video_width)
        fresh.frames = session.frames
        fresh.num_frames = session.num_frames
        session.__dict__.update(fresh.__dict__)

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------

    def _active_mask(self, session: InferenceSession) -> np.ndarray:
        mask = np.zeros(session.bank_objs, bool)
        for obj_idx in session.obj_idx_to_id:
            mask[obj_idx] = True
        return mask

    def _device_frame(self, session: InferenceSession, frame_idx: int) -> torch.Tensor:
        """Upload-once device copy of a frame (uint8, model size); evicted
        with the host frame by release_old_frames."""
        arr = session.frames_dev.get(frame_idx)
        if arr is None:
            frame = session.frames.get(frame_idx)
            if frame is None:
                raise KeyError(
                    f"frame {frame_idx} is not available (released or never loaded)"
                )
            arr = torch.as_tensor(frame).to(self.engine.device)
            session.frames_dev[frame_idx] = arr
        return arr

    def _get_feats(self, session: InferenceSession, frame_idx: int):
        """LRU-1 feature cache."""
        if session._feat_cache is not None and session._feat_cache[0] == frame_idx:
            return session._feat_cache[1]
        feats = self.engine.encode_image(self._device_frame(session, frame_idx)[None])
        session._feat_cache = (frame_idx, feats)
        return feats

    def _new_bank(self, num_objects: int) -> bank_ops.MemoryBank:
        return bank_ops.init_bank(
            self.cfg, num_objects, dtype=self.engine.dtype,
            banked_layers=self.engine.banked_layers, device=self.engine.device,
        )

    def _ensure_bank(self, session: InferenceSession, num_objects: int) -> None:
        if num_objects > self.cfg.max_objects:
            raise ValueError(
                f"object count {num_objects} exceeds SAM2Config.max_objects="
                f"{self.cfg.max_objects}; raise the config cap"
            )
        target = _bucket(max(num_objects, 1))
        if session.bank is None:
            session.bank = self._new_bank(target)
            session.bank_objs = target
        elif target > session.bank_objs:
            session.bank = bank_ops.grow_objects(session.bank, target)
            old = session.bank_objs
            session.bank_objs = target
            self._pad_outputs(session, old, target)

    def _pad_outputs(self, session, old_o: int, new_o: int) -> None:
        pad = new_o - old_o

        def _pad_store(store):
            for out in store.values():
                m = out["pred_masks"]
                out["pred_masks"] = np.concatenate(
                    [m, np.full((pad, *m.shape[1:]), NO_OBJ_SCORE, m.dtype)])
                p = out["obj_ptr"]
                out["obj_ptr"] = np.concatenate(
                    [p, np.full((pad, p.shape[1]), NO_OBJ_SCORE, p.dtype)])
                out["object_score_logits"] = np.concatenate(
                    [out["object_score_logits"], np.full((pad, 1), 10.0, np.float32)])
                out["valid"] = np.concatenate([out["valid"], np.zeros(pad, bool)])

        _pad_store(session.cond_outputs)
        _pad_store(session.noncond_outputs)

    def _obj_id_to_idx(self, session: InferenceSession, obj_id: int) -> int:
        """Client id -> slot; a new id after tracking has started grows the
        bank and re-consolidates."""
        if obj_id in session.obj_id_to_idx:
            return session.obj_id_to_idx[obj_id]
        # smallest free slot (remove_object leaves holes; a freed slot is
        # safe to reuse because its bank rows were invalidated)
        obj_idx = 0
        while obj_idx in session.obj_idx_to_id:
            obj_idx += 1
        session.obj_id_to_idx[obj_id] = obj_idx
        session.obj_idx_to_id[obj_idx] = obj_id
        self._ensure_bank(session, obj_idx + 1)
        if session.tracking_has_started:
            # re-encode recent + preload cond frames so every bank memory
            # carries a (placeholder) row for the new object
            self._reconsolidate_for_new_obj(session)
        return obj_idx

    def _reconsolidate_for_new_obj(self, session: InferenceSession) -> None:
        """Re-encode recent + preload cond frames so every bank memory has
        rows for the grown object axis."""
        cond_frames = sorted(session.cond_outputs.keys())
        recent = cond_frames[-self.max_update_length_for_new_obj_id:]
        for frame_idx in sorted(set(recent) | set(session.preload_cond_indices)):
            if frame_idx not in session.frames:
                continue  # image released; its memory keeps zero rows
            self._consolidate(session, frame_idx, is_cond=True, run_mem_encoder=True)

    def _refresh_cond_bucket(self, session: InferenceSession) -> None:
        """Size the attended cond-tile set to the live cond count, bucketed
        (exact: the bucket is >= the live count up to cond_attn_size)."""
        if session.bank is None:
            return
        live = len(set(session.cond_outputs) | set(session.preload_cond_indices))
        session.bank.attend_cond_tiles = bank_ops.cond_tile_bucket(self.cfg, live)

    def _empty_mask_ptr(self, session: InferenceSession, frame_idx: int):
        if frame_idx not in session._empty_ptr:
            feats = self._get_feats(session, frame_idx)
            ptr = self.engine.empty_mask_ptr(feats, frame_idx)
            session._empty_ptr[frame_idx] = to_host(ptr)[0]
        return session._empty_ptr[frame_idx]

    def _lookup_output_row(self, session, obj_idx: int, frame_idx: int):
        """temp -> cond store -> non-cond store."""
        for temp in (session.temp_cond, session.temp_noncond):
            out = temp[obj_idx].get(frame_idx)
            if out is not None:
                return out, True
        for store in (session.cond_outputs, session.noncond_outputs):
            out = store.get(frame_idx)
            if out is not None and obj_idx < len(out["valid"]) and out["valid"][obj_idx]:
                return ({k: out[k][obj_idx:obj_idx + 1]
                         for k in ("pred_masks", "obj_ptr", "object_score_logits")},
                        True)
        return None, False

    def _resize(self, masks: np.ndarray, hw, group: int = MASK_GROUP) -> np.ndarray:
        """Masks [..., h, w] -> [..., H, W] on the engine's device, read back
        once; group: the masks of one cv2 call in the JAX package ("host":
        cv2 picks its arithmetic by that channel count)."""
        if self.mask_resize == "host":
            x = torch.from_numpy(np.ascontiguousarray(masks, np.float32))
            return to_host(resize_masks_cv2(x.to(self.engine.device), hw, group=group))[0]
        return to_host(self.engine.resize_masks(masks, hw))[0]

    def _consolidate(
        self,
        session: InferenceSession,
        frame_idx: int,
        is_cond: bool,
        run_mem_encoder: bool,
        consolidate_at_video_res: bool = False,
    ) -> dict:
        """Merge the per-object outputs of one frame (and, with
        run_mem_encoder, encode them into the bank and the stores)."""
        o = session.bank_objs
        if consolidate_at_video_res:
            assert not run_mem_encoder
            h, w = session.video_height, session.video_width
        else:
            h = w = self.image_size // 4
        masks = np.full((o, 1, h, w), NO_OBJ_SCORE, np.float32)
        ptrs = np.full((o, self.cfg.hidden_dim), NO_OBJ_SCORE, np.float32)
        scores = np.full((o, 1), 10.0, np.float32)
        valid = np.zeros(o, bool)

        to_resize = {}
        for obj_idx in sorted(session.obj_idx_to_id):
            row, found = self._lookup_output_row(session, obj_idx, frame_idx)
            if not found:
                if run_mem_encoder:
                    ptrs[obj_idx] = self._empty_mask_ptr(session, frame_idx)[0]
                continue
            m = np.asarray(row["pred_masks"], np.float32)
            if m.shape[-2:] != (h, w):
                to_resize[obj_idx] = m[0]
            else:
                masks[obj_idx] = m[0]
            ptrs[obj_idx] = np.asarray(row["obj_ptr"], np.float32)[0]
            scores[obj_idx] = np.asarray(row["object_score_logits"], np.float32)[0]
            valid[obj_idx] = True
        if to_resize:
            # the JAX package resizes each object's row on its own (a
            # one-channel cv2 call each): one call here, one mask a group
            resized = self._resize(np.stack(list(to_resize.values())), (h, w), group=1)
            for i, obj_idx in enumerate(to_resize):
                masks[obj_idx] = resized[i]

        out = {"pred_masks": masks, "obj_ptr": ptrs, "object_score_logits": scores,
               "valid": valid}

        if run_mem_encoder:
            feats = self._get_feats(session, frame_idx)
            encode = (self.engine.encode_cond_memory if is_cond
                      else self.engine.encode_noncond_memory)
            kw = {"pinned": frame_idx in session.preload_cond_indices} if is_cond else {}
            # corrections on tracked frames stay non-cond memories
            encode(feats, session.bank, frame_idx, masks, scores, ptrs,
                   is_mask_from_pts=True, obj_valid=self._active_mask(session), **kw)
            if is_cond:
                bank_ops.invalidate_noncond(session.bank, frame_idx)
            store = session.cond_outputs if is_cond else session.noncond_outputs
            store[frame_idx] = {
                "pred_masks": masks.astype(np.float16),
                "obj_ptr": ptrs,
                "object_score_logits": scores,
                "valid": valid,
            }
            self._refresh_cond_bucket(session)
        return out

    def _video_res_masks(self, session, masks_np: np.ndarray) -> np.ndarray:
        """Low-res logits [O, 1, h, w] -> video resolution."""
        m = np.asarray(masks_np, np.float32)
        target = (session.video_height, session.video_width)
        if m.shape[-2:] != target:
            m = self._resize(m, target)
        if self.non_overlap_masks:
            m = apply_non_overlapping_constraints(torch.from_numpy(m)).numpy()
        return m

    # ------------------------------------------------------------------
    # prompts
    # ------------------------------------------------------------------

    def _store_temp(self, session, obj_idx: int, frame_idx: int, is_cond: bool,
                    out: dict) -> np.ndarray:
        """Keep this object's row of a prompt step's outputs, consolidate the
        frame at video resolution and return its masks."""
        masks, ptr, scores = to_host(out["pred_masks"], out["obj_ptr"],
                                      out["object_score_logits"])
        temp = session.temp_cond if is_cond else session.temp_noncond
        temp[obj_idx][frame_idx] = {
            "pred_masks": masks[obj_idx:obj_idx + 1],
            "obj_ptr": ptr[obj_idx:obj_idx + 1],
            "object_score_logits": scores[obj_idx:obj_idx + 1],
        }
        consolidated = self._consolidate(session, frame_idx, is_cond=is_cond,
                                         run_mem_encoder=False,
                                         consolidate_at_video_res=True)
        return self._video_res_masks(session, consolidated["pred_masks"])

    def add_new_points_or_box(
        self,
        session: InferenceSession,
        frame_idx: int,
        obj_id: int,
        points=None,
        labels=None,
        clear_old_points: bool = True,
        normalize_coords: bool = True,
        box=None,
    ):
        obj_idx = self._obj_id_to_idx(session, obj_id)
        if (points is not None) != (labels is not None):
            raise ValueError("points and labels must be provided together")
        if points is None and box is None:
            raise ValueError("at least one of points or box must be provided")

        points = (np.zeros((0, 2), np.float32) if points is None
                  else np.asarray(points, np.float32))
        labels = (np.zeros((0,), np.int32) if labels is None
                  else np.asarray(labels, np.int32))
        if points.ndim == 2:
            points = points[None]
        if labels.ndim == 1:
            labels = labels[None]
        if box is not None:
            if not clear_old_points:
                raise ValueError(
                    "box prompts must precede point prompts (use clear_old_points=True)"
                )
            box = np.asarray(box, np.float32).reshape(1, 2, 2)
            points = np.concatenate([box, points], axis=1)
            labels = np.concatenate([np.asarray([[2, 3]], np.int32), labels], axis=1)
        if normalize_coords:
            points = points / np.asarray(
                [session.video_width, session.video_height], np.float32)
        points = points * self.image_size

        old = None if clear_old_points else session.point_inputs_per_obj[obj_idx].get(frame_idx)
        point_inputs = concat_points(old, points, labels)
        session.point_inputs_per_obj[obj_idx][frame_idx] = point_inputs
        session.mask_inputs_per_obj[obj_idx].pop(frame_idx, None)

        tracked = session.tracked_info(frame_idx)
        is_init = tracked is None
        reverse = False if is_init else tracked["reverse"]
        is_cond = is_init or self.add_all_frames_to_correct_as_cond

        prev_row, found = self._lookup_output_row(session, obj_idx, frame_idx)

        # batched prompt step: this object's row carries the prompt, the
        # others are dummies (-1 labels) whose outputs are discarded
        o = session.bank_objs
        p = point_inputs["point_coords"].shape[1]
        all_pts = np.zeros((o, p, 2), np.float32)
        all_lbl = -np.ones((o, p), np.int32)
        all_pts[obj_idx] = point_inputs["point_coords"][0]
        all_lbl[obj_idx] = point_inputs["point_labels"][0]
        prev_all = None
        if found and prev_row["pred_masks"] is not None:
            s4 = self.image_size // 4
            prev_all = np.zeros((o, 1, s4, s4), np.float32)
            prev_all[obj_idx] = np.asarray(prev_row["pred_masks"], np.float32)[0]

        feats = self._get_feats(session, frame_idx)
        out = self.engine.prompt_step(
            feats, session.bank, frame_idx, session.num_frames, all_pts, all_lbl,
            is_init=is_init, reverse=reverse, prev_logits=prev_all,
        )
        return frame_idx, session.obj_ids, self._store_temp(
            session, obj_idx, frame_idx, is_cond, out)

    def add_new_mask(self, session, frame_idx: int, obj_id: int, mask):
        obj_idx = self._obj_id_to_idx(session, obj_id)
        mask = np.asarray(mask)
        assert mask.ndim == 2
        s = self.image_size
        mask_f = mask.astype(np.float32)[None, :, :, None]  # [1, H, W, 1]
        if mask.shape != (s, s):
            m = resize_bilinear(torch.from_numpy(mask_f[..., 0]), (s, s), antialias=True)
            mask_f = (m >= 0.5).float().numpy()[..., None]
        session.mask_inputs_per_obj[obj_idx][frame_idx] = mask_f
        session.point_inputs_per_obj[obj_idx].pop(frame_idx, None)

        tracked = session.tracked_info(frame_idx)
        is_init = tracked is None
        reverse = False if is_init else tracked["reverse"]
        is_cond = is_init or self.add_all_frames_to_correct_as_cond

        all_masks = np.zeros((session.bank_objs, s, s, 1), np.float32)
        all_masks[obj_idx] = mask_f[0]
        feats = self._get_feats(session, frame_idx)
        out = self.engine.mask_prompt_step(
            feats, session.bank, frame_idx, session.num_frames, all_masks,
            is_init=is_init, reverse=reverse,
        )
        return frame_idx, session.obj_ids, self._store_temp(
            session, obj_idx, frame_idx, is_cond, out)

    # ------------------------------------------------------------------
    # propagation
    # ------------------------------------------------------------------

    def propagate_in_video_preflight(self, session: InferenceSession) -> None:
        """Consolidate the temp outputs into the stores and the bank."""
        session.tracking_has_started = True
        for is_cond in (False, True):
            temp_store = session.temp_cond if is_cond else session.temp_noncond
            frame_inds = set()
            for per_frame in temp_store.values():
                frame_inds.update(per_frame.keys())
            for frame_idx in sorted(frame_inds):
                self._consolidate(session, frame_idx, is_cond=is_cond,
                                  run_mem_encoder=True)
                if not is_cond:
                    session.consolidated_noncond.add(frame_idx)
                if self._clear_nc(session):
                    self._clear_non_cond_mem_around_input(session, frame_idx)
            for per_frame in temp_store.values():
                per_frame.clear()
        # a frame is never both cond and non-cond
        for frame_idx in session.cond_outputs:
            session.noncond_outputs.pop(frame_idx, None)

    def _clear_nc(self, session) -> bool:
        return self.clear_non_cond_mem_around_input and (
            self.clear_non_cond_mem_for_multi_obj or session.num_objects <= 1)

    def propagate_in_video(
        self,
        session: InferenceSession,
        start_frame_idx: Optional[int] = None,
        max_frame_num_to_track: Optional[int] = None,
        reverse: bool = False,
    ) -> Iterator[Tuple[int, List[int], np.ndarray]]:
        """Yields (frame_idx, obj_ids, video-res mask logits [O, 1, H, W])."""
        self.propagate_in_video_preflight(session)
        if not session.cond_outputs:
            raise RuntimeError("no prompts provided; add points first")
        num_frames = session.num_frames
        if start_frame_idx is None:
            start_frame_idx = min(session.cond_outputs)
        if max_frame_num_to_track is None:
            max_frame_num_to_track = num_frames
        if reverse:
            end_frame_idx = max(start_frame_idx - max_frame_num_to_track + 1, 0)
            order = (list(range(start_frame_idx, end_frame_idx - 1, -1))
                     if start_frame_idx > 0 else [])
        else:
            end_frame_idx = min(start_frame_idx + max_frame_num_to_track,
                                num_frames - 1)
            order = list(range(start_frame_idx, end_frame_idx + 1))

        def _skip(fi):
            return fi in session.cond_outputs or (
                fi in session.consolidated_noncond and fi in session.noncond_outputs)

        if (len(order) > 1 and not self._clear_nc(session)
                and all(_skip(fi) or fi in session.frames for fi in order)):
            yield from self._propagate_window(session, order, _skip, reverse)
            return

        # per-frame path: queue every step on the device, read back once
        active = self._active_mask(session)
        steps: list = []  # (frame_idx, device outputs or None, stored masks)
        for frame_idx in order:
            if frame_idx in session.cond_outputs:
                steps.append((frame_idx, None,
                              session.cond_outputs[frame_idx]["pred_masks"]))
                if self._clear_nc(session):
                    self._clear_non_cond_mem_around_input(session, frame_idx)
            elif (frame_idx in session.consolidated_noncond
                  and frame_idx in session.noncond_outputs):
                # only prompted non-cond frames are reused; plain tracked
                # frames are re-inferred on revisit
                steps.append((frame_idx, None,
                              session.noncond_outputs[frame_idx]["pred_masks"]))
            else:
                if frame_idx not in session.frames:
                    raise KeyError(f"frame {frame_idx} is not available")
                session._feat_cache = None  # the step encodes the frame itself
                _, out = self.engine.stream_step(
                    self._device_frame(session, frame_idx)[None], session.bank,
                    frame_idx, num_frames, reverse=reverse, obj_valid=active)
                steps.append((frame_idx, out, None))

        keys = ("pred_masks", "obj_ptr", "object_score_logits")
        fetched = iter(to_host(*[o[k] for _, o, _ in steps if o is not None
                                  for k in keys]))
        for frame_idx, out, pred_masks in steps:
            if out is not None:
                masks, ptr, scores = (next(fetched) for _ in keys)
                session.noncond_outputs[frame_idx] = {
                    "pred_masks": masks.astype(np.float16),
                    "obj_ptr": ptr,
                    "object_score_logits": scores,
                    "valid": self._active_mask(session),
                }
                pred_masks = masks
            session.frames_already_tracked[frame_idx] = {"reverse": reverse}
            yield frame_idx, session.obj_ids, self._video_res_masks(session, pred_masks)

    def _propagate_window(self, session, order, skip, reverse):
        """The window path: engine.propagate_window over `order` (frames in
        the cond / prompted stores are skipped and reuse their outputs), one
        download, then store + yield."""
        run_frames = [fi for fi in order if not skip(fi)]
        pos = {fi: i for i, fi in enumerate(run_frames)}
        session._feat_cache = None
        _, outs = self.engine.propagate_window(
            [self._device_frame(session, fi) for fi in run_frames], session.bank,
            order, [skip(fi) for fi in order], session.num_frames, reverse=reverse,
            obj_valid=self._active_mask(session),
            img_idx=[pos.get(fi, 0) for fi in order],
        )
        masks_t, ptrs_t, scores_t = to_host(*outs)
        valid_row = self._active_mask(session)
        for i, frame_idx in enumerate(order):
            if skip(frame_idx):
                store = (session.cond_outputs if frame_idx in session.cond_outputs
                         else session.noncond_outputs)
                pred_masks = np.asarray(store[frame_idx]["pred_masks"], np.float32)
            else:
                pred_masks = masks_t[i]
                session.noncond_outputs[frame_idx] = {
                    "pred_masks": pred_masks.astype(np.float16),
                    "obj_ptr": ptrs_t[i],
                    "object_score_logits": scores_t[i],
                    "valid": valid_row.copy(),
                }
            session.frames_already_tracked[frame_idx] = {"reverse": reverse}
            yield frame_idx, session.obj_ids, self._video_res_masks(session, pred_masks)

    def _clear_non_cond_mem_around_input(self, session, frame_idx: int):
        r = self.cfg.memory_temporal_stride_for_eval
        radius = r * self.cfg.num_maskmem
        bank_ops.clear_noncond_around(session.bank, frame_idx, radius)
        lo, hi = frame_idx - radius, frame_idx + radius
        for t in list(session.noncond_outputs):
            if lo <= t <= hi:
                session.noncond_outputs.pop(t, None)

    # ------------------------------------------------------------------
    # memory management
    # ------------------------------------------------------------------

    def release_old_frames(
        self,
        session: InferenceSession,
        frame_idx: int,
        max_inference_state_frames: int,
        pre_frames: Optional[int] = None,
        release_images: bool = False,
    ) -> None:
        """Constant-memory eviction: drop outputs (and, with release_images,
        frames) with pre_frames - 1 < idx <= frame_idx -
        max_inference_state_frames."""
        pre_frames = session.pre_frames if pre_frames is None else pre_frames
        oldest_allowed = frame_idx - max_inference_state_frames

        def _in_range(idx):
            return (pre_frames - 1) < idx <= oldest_allowed

        for store in (session.cond_outputs, session.noncond_outputs):
            for t in [t for t in store if _in_range(t)]:
                store.pop(t, None)
        session.consolidated_noncond = {
            t for t in session.consolidated_noncond if not _in_range(t)}
        for t in [t for t in session._empty_ptr if _in_range(t)]:
            session._empty_ptr.pop(t, None)
        # tracked frames are kept (a later correction on a released frame
        # is still not an init frame), compacted into ranges
        session.compact_tracked(oldest_allowed)
        if session.bank is not None:
            bank_ops.release_frames(session.bank, oldest_allowed + 1)
            self._refresh_cond_bucket(session)
        if release_images:
            for t in [t for t in session.frames if _in_range(t)]:
                session.frames.pop(t, None)
            for t in [t for t in session.frames_dev if _in_range(t)]:
                session.frames_dev.pop(t, None)
            if session._feat_cache and _in_range(session._feat_cache[0]):
                session._feat_cache = None

    # ------------------------------------------------------------------
    # preload memory bank (save / restore across videos)
    # ------------------------------------------------------------------

    def save_session(self, session: InferenceSession, path: str) -> None:
        """Pickle the session. Prompts added since the last propagation are
        consolidated first (as the next propagate_in_video would). The bank
        goes as CPU tensors without its banked-attention caches, which are
        derived state: load_session_as_preload rebuilds them."""
        if any(per_frame
               for store in (session.temp_cond, session.temp_noncond)
               for per_frame in store.values()):
            self.propagate_in_video_preflight(session)
        bank = None
        if session.bank is not None:
            bank = {f.name: getattr(session.bank, f.name)
                    for f in dataclasses.fields(session.bank)
                    if f.name not in ("mem_k", "mem_v")}
            bank = {k: v.cpu() if torch.is_tensor(v) else v for k, v in bank.items()}
        payload = {
            "cfg_image_size": self.image_size,
            "video_height": session.video_height,
            "video_width": session.video_width,
            "num_frames": session.num_frames,
            "obj_id_to_idx": dict(session.obj_id_to_idx),
            "bank": bank,
            "bank_objs": session.bank_objs,
            "cond_outputs": session.cond_outputs,
            "noncond_outputs": session.noncond_outputs,
            "frames_already_tracked": session.frames_already_tracked,
            "tracked_ranges": session.tracked_ranges,
            "frames": (session.frames.materialized()
                       if isinstance(session.frames, _LazyFrames) else session.frames),
            "pre_frames": session.pre_frames,
            "preload_cond_indices": session.preload_cond_indices,
        }
        with open(path, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)

    def load_session_as_preload(self, path: str, keep_images: bool = True
                                ) -> InferenceSession:
        """Load a saved session as the preload memory bank of a NEW video:
        every cond frame becomes a pinned preload frame. Only load files
        this package wrote: they are pickles."""
        with open(path, "rb") as f:
            payload = pickle.load(f)
        assert payload["cfg_image_size"] == self.image_size
        session = InferenceSession(self.cfg, payload["video_height"],
                                   payload["video_width"])
        session.num_frames = payload["num_frames"]
        for oid, oidx in sorted(payload["obj_id_to_idx"].items(), key=lambda kv: kv[1]):
            session.obj_id_to_idx[oid] = oidx
            session.obj_idx_to_id[oidx] = oid
        session.bank_objs = payload["bank_objs"]
        if payload["bank"] is not None:
            dev = self.engine.device
            bank = bank_ops.MemoryBank(**{
                k: v.to(dev) if torch.is_tensor(v) else v
                for k, v in payload["bank"].items()})
            # pinned: preload memories survive eviction and always join
            # memory attention
            bank.cond_pinned = bank.cond_frame_idx >= 0
            session.bank = self.engine.attach_bank_caches(bank)
        session.cond_outputs = payload["cond_outputs"]
        session.noncond_outputs = payload["noncond_outputs"]
        session.frames_already_tracked = payload["frames_already_tracked"]
        session.tracked_ranges = [tuple(r) for r in payload["tracked_ranges"]]
        session._compact_seq = max((r[3] for r in session.tracked_ranges), default=0)
        if keep_images:
            session.frames = payload["frames"]
        session.pre_frames = session.num_frames
        session.preload_cond_indices = sorted(session.cond_outputs.keys())
        session.tracking_has_started = True
        self._refresh_cond_bucket(session)
        return session

    # ------------------------------------------------------------------
    # object / prompt removal
    # ------------------------------------------------------------------

    def remove_object(self, session: InferenceSession, obj_id: int):
        """Free an object's slot: its outputs are blanked and its bank rows
        invalidated, so a later object can reuse the slot."""
        if obj_id not in session.obj_id_to_idx:
            return session.obj_ids
        obj_idx = session.obj_id_to_idx.pop(obj_id)
        session.obj_idx_to_id.pop(obj_idx, None)
        for d in (session.point_inputs_per_obj, session.mask_inputs_per_obj,
                  session.temp_cond, session.temp_noncond):
            d.pop(obj_idx, None)
        for store in (session.cond_outputs, session.noncond_outputs):
            for out in store.values():
                if obj_idx < len(out["valid"]):
                    out["valid"][obj_idx] = False
                    out["pred_masks"][obj_idx] = NO_OBJ_SCORE
        if session.bank is not None:
            bank_ops.clear_object_rows(session.bank, obj_idx)
        return session.obj_ids

    def clear_all_prompts_in_frame(
        self, session: InferenceSession, frame_idx: int, obj_id: int
    ) -> None:
        """Remove an object's prompts on a frame; a frame left with no
        prompt leaves the consolidated set and a cond frame is demoted to a
        non-cond one; with no cond frame left, every tracking result goes."""
        obj_idx = session.obj_id_to_idx.get(obj_id)
        if obj_idx is None:
            return
        session.point_inputs_per_obj[obj_idx].pop(frame_idx, None)
        session.mask_inputs_per_obj[obj_idx].pop(frame_idx, None)
        session.temp_cond[obj_idx].pop(frame_idx, None)
        session.temp_noncond[obj_idx].pop(frame_idx, None)
        still_prompted = any(
            frame_idx in session.point_inputs_per_obj[i]
            or frame_idx in session.mask_inputs_per_obj[i]
            for i in session.obj_idx_to_id
        )
        if still_prompted:
            return
        session.consolidated_noncond.discard(frame_idx)
        if frame_idx in session.cond_outputs:
            session.noncond_outputs[frame_idx] = session.cond_outputs.pop(frame_idx)
            # a demoted frame is no longer tracked: a fresh prompt there is
            # an init cond frame
            session.frames_already_tracked.pop(frame_idx, None)
            if session.bank is not None:
                bank_ops.demote_cond_frame(session.bank, frame_idx)
                self._refresh_cond_bucket(session)
        if not session.cond_outputs:
            self._reset_tracking_results(session)

    def _reset_tracking_results(self, session: InferenceSession) -> None:
        """Clear every tracking input and output but keep the registered
        objects (and a bank sized for them)."""
        for d in (session.point_inputs_per_obj, session.mask_inputs_per_obj,
                  session.temp_cond, session.temp_noncond):
            for v in d.values():
                v.clear()
        session.cond_outputs.clear()
        session.noncond_outputs.clear()
        session.consolidated_noncond.clear()
        session.frames_already_tracked.clear()
        session.tracked_ranges.clear()
        session.tracking_has_started = False
        session._empty_ptr.clear()
        # preload state lives in the bank, so it goes too
        if session.bank is not None:
            session.bank = self._new_bank(session.bank_objs)
            self._refresh_cond_bucket(session)
        session.pre_frames = 0
        session.preload_cond_indices = []
        session._feat_cache = None
