"""InferenceAPI: the multi-session video-segmentation service core.

Counterpart of the JAX package's ``serving/inference_api.py`` (after the
reference demo backend's InferenceAPI, demo/backend/server/inference/
predictor.py): per-session state keyed by uuid, start_session / add_points /
add_box / add_mask / clear_points_in_frame / remove_object / reset_session /
propagate_in_video / cancel / close_session, all behind one global inference
lock; responses carry RLE-encoded masks.

The HTTP layer (serving/server.py) calls these methods on its handler
threads. PyTorch's grad mode is thread-local and on by default on a new
thread, so every method that runs the model runs under ``torch.no_grad()``
(the propagation generator too: the decorator re-enters it at each resume).
The sessions live on the predictor's device.
"""

from __future__ import annotations

import threading
import uuid
from typing import Dict, List, Optional

import numpy as np
import torch

from det_sam2_tpu_torch.utils.amg import mask_to_rle, rle_to_mask
from det_sam2_tpu_torch.video_predictor import InferenceSession, SAM2VideoPredictor


class Session:
    def __init__(self, session_id: str, state: InferenceSession):
        self.session_id = session_id
        self.state = state
        self.canceled = False


class InferenceAPI:
    def __init__(self, predictor: SAM2VideoPredictor):
        self.predictor = predictor
        self.sessions: Dict[str, Session] = {}
        self.inference_lock = threading.Lock()

    # ------------------------------------------------------------------

    @torch.no_grad()
    def start_session(self, video_path) -> dict:
        """video_path: anything ``init_state`` takes (a frame directory, a
        video file, a list of paths or an ndarray video)."""
        with self.inference_lock:
            state = self.predictor.init_state(video_path)
            session_id = str(uuid.uuid4())
            self.sessions[session_id] = Session(session_id, state)
            return {"session_id": session_id,
                    "num_frames": state.num_frames,
                    "video_height": state.video_height,
                    "video_width": state.video_width}

    def close_session(self, session_id: str) -> dict:
        with self.inference_lock:
            ok = self.sessions.pop(session_id, None) is not None
            return {"success": ok}

    def _session(self, session_id: str) -> Session:
        s = self.sessions.get(session_id)
        if s is None:
            raise KeyError(f"unknown session {session_id}")
        return s

    # ------------------------------------------------------------------

    def _rle_masks(self, obj_ids: List[int], video_res_masks: np.ndarray):
        """Binary RLE per object (the reference's __get_rle_mask_list)."""
        out = []
        for i, obj_id in enumerate(obj_ids):
            mask = video_res_masks[i, 0] > 0.0
            rle = mask_to_rle(mask[None])[0]
            out.append(
                {"object_id": obj_id,
                 "mask": {"size": rle["size"], "counts": rle["counts"]}}
            )
        return out

    @torch.no_grad()
    def add_points(
        self, session_id: str, frame_idx: int, obj_id: int,
        points: List[List[float]], labels: List[int],
        clear_old_points: bool = True,
    ) -> dict:
        with self.inference_lock:
            s = self._session(session_id)
            frame_idx, obj_ids, masks = self.predictor.add_new_points_or_box(
                s.state, frame_idx=frame_idx, obj_id=obj_id,
                points=np.asarray(points, np.float32),
                labels=np.asarray(labels, np.int32),
                clear_old_points=clear_old_points,
            )
            return {"frame_index": frame_idx,
                    "results": self._rle_masks(obj_ids, masks)}

    @torch.no_grad()
    def add_box(self, session_id: str, frame_idx: int, obj_id: int,
                box: List[float]) -> dict:
        with self.inference_lock:
            s = self._session(session_id)
            frame_idx, obj_ids, masks = self.predictor.add_new_points_or_box(
                s.state, frame_idx=frame_idx, obj_id=obj_id,
                box=np.asarray(box, np.float32),
            )
            return {"frame_index": frame_idx,
                    "results": self._rle_masks(obj_ids, masks)}

    @torch.no_grad()
    def add_mask(self, session_id: str, frame_idx: int, obj_id: int,
                 mask_rle: dict) -> dict:
        with self.inference_lock:
            s = self._session(session_id)
            mask = rle_to_mask(
                {"size": mask_rle["size"], "counts": mask_rle["counts"]}
            )
            frame_idx, obj_ids, masks = self.predictor.add_new_mask(
                s.state, frame_idx=frame_idx, obj_id=obj_id, mask=mask
            )
            return {"frame_index": frame_idx,
                    "results": self._rle_masks(obj_ids, masks)}

    @torch.no_grad()
    def clear_points_in_frame(self, session_id: str, frame_idx: int,
                              obj_id: int) -> dict:
        with self.inference_lock:
            s = self._session(session_id)
            self.predictor.clear_all_prompts_in_frame(s.state, frame_idx, obj_id)
            return {"success": True}

    @torch.no_grad()
    def remove_object(self, session_id: str, obj_id: int) -> dict:
        with self.inference_lock:
            s = self._session(session_id)
            obj_ids = self.predictor.remove_object(s.state, obj_id)
            return {"object_ids": obj_ids}

    def reset_session(self, session_id: str) -> dict:
        with self.inference_lock:
            s = self._session(session_id)
            self.predictor.reset_state(s.state)
            return {"success": True}

    def session_info(self, session_id: str) -> dict:
        s = self._session(session_id)
        return {"session_id": session_id,
                "num_frames": s.state.num_frames,
                "video_height": s.state.video_height,
                "video_width": s.state.video_width}

    def frame_jpeg(self, session_id: str, frame_index: int) -> bytes:
        """Frame as JPEG bytes (serves the demo frontend's viewer); needs
        cv2."""
        import cv2

        s = self._session(session_id)
        frame = s.state.frames.get(int(frame_index))
        if frame is None:
            raise KeyError(f"frame {frame_index} not loaded")
        ok, buf = cv2.imencode(".jpg", cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        if not ok:
            raise RuntimeError("jpeg encode failed")
        return bytes(buf)

    def cancel_propagate_in_video(self, session_id: str) -> dict:
        s = self._session(session_id)
        s.canceled = True
        return {"success": True}

    @torch.no_grad()
    def propagate_in_video(
        self, session_id: str, start_frame_idx: Optional[int] = None,
        max_frame_num_to_track: Optional[int] = None, reverse: bool = False,
    ):
        """Generator of per-frame dicts (streamed by the HTTP layer as NDJSON
        lines); a cancel is seen between two yielded frames."""
        s = self._session(session_id)
        s.canceled = False
        with self.inference_lock:
            for frame_idx, obj_ids, masks in self.predictor.propagate_in_video(
                s.state, start_frame_idx=start_frame_idx,
                max_frame_num_to_track=max_frame_num_to_track, reverse=reverse,
            ):
                if s.canceled:
                    break
                yield {"frame_index": frame_idx,
                       "results": self._rle_masks(obj_ids, masks)}
