"""VideoProcessor: the detector-self-prompted streaming engine.

Counterpart of the JAX package's ``app/video_processor.py`` (Det-SAM2's
det_sam2_RT.py VideoProcessor): buffer frames, detect every
`detect_interval` frames, turn detections into box prompts (obj_id ==
detector class), reverse-propagate `max_frame_num_to_track` frames, record
binary masks into `video_segments`, and release old state for constant
memory over unbounded streams. Special-class detections (billiard pockets)
are collected for the postprocessor rather than tracked.

The model runs in the SAM2VideoPredictor, on its engine's device; the
detector is pluggable (app/detector.py). The device state of a session is
the fixed-size MemoryBank plus the frames not yet released, so device memory
stays flat over a stream of any length; host memory is bounded by
max_inference_state_frames plus the caller draining video_segments.
"""

from __future__ import annotations

import pickle
import time
from typing import Dict, List, Optional, Sequence, Set, Union

import numpy as np

from det_sam2_tpu_torch.app.detector import Detection, Detector, NullDetector
from det_sam2_tpu_torch.video_predictor import InferenceSession, SAM2VideoPredictor


class VideoProcessor:
    def __init__(
        self,
        predictor: SAM2VideoPredictor,
        detector: Optional[Detector] = None,
        skip_classes: Set[int] = frozenset({11, 14, 15, 19}),
        special_classes: int = 11,
        frame_buffer_size: int = 30,
        detect_interval: int = 30,
        max_frame_num_to_track: int = 60,
        max_inference_state_frames: int = 60,
        load_session_path: Optional[str] = None,
        save_session_path: Optional[str] = None,
        output_dir: Optional[str] = None,
        vis_frame_stride: int = -1,
    ):
        if save_session_path is not None:
            assert max_inference_state_frames == -1, (
                "saving a session for preloading requires keeping all frames "
                "(max_inference_state_frames=-1)"  # det_sam2_RT.py:67-68
            )
        self.predictor = predictor
        self.detector = detector or NullDetector()
        self.skip_classes = set(skip_classes)
        self.special_classes = special_classes
        self.frame_buffer_size = frame_buffer_size
        self.detect_interval = detect_interval
        self.max_frame_num_to_track = max_frame_num_to_track
        self.max_inference_state_frames = max_inference_state_frames
        self.load_session_path = load_session_path
        self.save_session_path = save_session_path
        self.output_dir = output_dir
        self.vis_frame_stride = vis_frame_stride

        self.frame_buffer: List[np.ndarray] = []
        self.video_segments: Dict[int, Dict[int, np.ndarray]] = {}
        self.session: Optional[InferenceSession] = None
        self.special_classes_detection: List[np.ndarray] = []
        self._special_classes_count = 0
        self.pre_frames = 0
        # wall-clock breakdown of the streaming loop (system bench): where
        # the end-to-end time actually goes — detector, state upload, and
        # the propagation windows (device compute + mask download)
        self.stats: Dict[str, float] = {
            "detect_s": 0.0, "update_state_s": 0.0,
            "propagate_s": 0.0, "frames_propagated": 0,
        }

    # ------------------------------------------------------------------

    def clear(self) -> None:
        """Reset for a new video (det_sam2_RT.py:189-198)."""
        self.frame_buffer = []
        self.video_segments = {}
        self.session = None
        self.special_classes_detection = []
        self._special_classes_count = 0
        self.pre_frames = 0
        self.stats = {
            "detect_s": 0.0, "update_state_s": 0.0,
            "propagate_s": 0.0, "frames_propagated": 0,
        }

    def detect_predict(
        self, images: Sequence[np.ndarray], past_num_frames: int
    ) -> Dict[int, List[Detection]]:
        """Run the detector on buffer frames at the detect_interval cadence
        (det_sam2_RT.py:201-265); collects special-class boxes keeping the
        max-count frame."""
        if self.detect_interval == -1:
            return {}
        selected, indices = [], []
        for i, image in enumerate(images):
            frame_idx = past_num_frames + i
            if frame_idx % self.detect_interval == 0:
                selected.append(image)
                indices.append(frame_idx)
        if not selected:
            return {}
        results = self.detector(selected, indices)

        for idx in indices:
            dets = results.get(idx, [])
            special = [d for d in dets if d.cls == self.special_classes]
            if len(special) > self._special_classes_count:
                self.special_classes_detection = [d.box for d in special]
                self._special_classes_count = len(special)
        return results

    def prompt_from_detections(
        self, detections: Dict[int, List[Detection]]
    ) -> None:
        """Detections -> box prompts, obj_id = detector class
        (Detect_2_SAM2_Prompt, det_sam2_RT.py:267-316)."""
        for frame_idx, dets in detections.items():
            for det in dets:
                if det.cls in self.skip_classes:
                    continue
                self.predictor.add_new_points_or_box(
                    self.session,
                    frame_idx=frame_idx,
                    obj_id=det.cls,
                    box=np.asarray(det.box, np.float32),
                    normalize_coords=True,
                )

    def _detect_and_infer(self, frame_idx: int) -> None:
        """One buffer flush (Detect_and_SAM2_inference, det_sam2_RT.py
        :342-419)."""
        past = self.session.num_frames if self.session is not None else 0
        t0 = time.perf_counter()
        detections = self.detect_predict(self.frame_buffer, past)
        t1 = time.perf_counter()
        self.stats["detect_s"] += t1 - t0

        if self.session is None:
            self.session = self.predictor.init_state(self.frame_buffer)
        else:
            self.predictor.update_state(self.frame_buffer, self.session)
        self.session.pre_frames = self.pre_frames
        t2 = time.perf_counter()
        self.stats["update_state_s"] += t2 - t1

        self.prompt_from_detections(detections)
        if self.session.num_objects == 0:
            # nothing prompted yet — still bound host memory: hours of
            # detection-free stream would otherwise accumulate frames
            if self.max_inference_state_frames != -1:
                self.predictor.release_old_frames(
                    self.session,
                    frame_idx,
                    self.max_inference_state_frames,
                    self.pre_frames,
                    release_images=self.vis_frame_stride == -1,
                )
            return

        t3 = time.perf_counter()
        for out_frame_idx, out_obj_ids, out_mask_logits in (
            self.predictor.propagate_in_video(
                self.session,
                start_frame_idx=frame_idx,
                max_frame_num_to_track=self.max_frame_num_to_track,
                reverse=True,
            )
        ):
            if out_frame_idx >= self.pre_frames:
                self.video_segments[out_frame_idx] = {
                    obj_id: (out_mask_logits[i] > 0.0)
                    for i, obj_id in enumerate(out_obj_ids)
                }
            self.stats["frames_propagated"] += 1
        self.stats["propagate_s"] += time.perf_counter() - t3

        if self.max_inference_state_frames != -1:
            self.predictor.release_old_frames(
                self.session,
                frame_idx,
                self.max_inference_state_frames,
                self.pre_frames,
                release_images=self.vis_frame_stride == -1,
            )

    def process_frame(self, frame_idx: int, frame_rgb: np.ndarray):
        """Accumulate one frame; flush the buffer when full
        (det_sam2_RT.py:421-435)."""
        self.frame_buffer.append(frame_rgb)
        if len(self.frame_buffer) >= self.frame_buffer_size:
            self._detect_and_infer(frame_idx)
            self.frame_buffer.clear()
        return self.session

    def finish(self) -> None:
        """End-of-stream flush of a partial buffer (det_sam2_RT.py:567-571)."""
        if self.frame_buffer:
            past = self.session.num_frames if self.session is not None else 0
            last_idx = past + len(self.frame_buffer) - 1
            self._detect_and_infer(last_idx)
            self.frame_buffer.clear()
        if self.save_session_path and self.session is not None:
            self.predictor.save_session(self.session, self.save_session_path)

    # ------------------------------------------------------------------

    def run(
        self,
        video_source: Union[str, Sequence[np.ndarray]],
        max_frames: Optional[int] = None,
    ) -> Dict[int, Dict[int, np.ndarray]]:
        """Process a whole video / stream (det_sam2_RT.py:526-651)."""
        if self.load_session_path:
            self.session = self.predictor.load_session_as_preload(
                self.load_session_path
            )
            self.pre_frames = self.session.pre_frames

        from det_sam2_tpu_torch.app.rtsp import iter_video_frames

        for i, frame in enumerate(iter_video_frames(video_source, max_frames)):
            self.process_frame(self.pre_frames + i, frame)
        self.finish()
        return self.video_segments

    # ------------------------------------------------------------------

    def save_results(self, path: str) -> None:
        """Pickle video_segments + special-class detections with the preload
        offset removed (det_sam2_RT.py:610-622)."""
        segments = {
            idx - self.pre_frames: segs
            for idx, segs in self.video_segments.items()
        }
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "video_segments": segments,
                    "special_classes_detection": self.special_classes_detection,
                },
                f,
                protocol=pickle.HIGHEST_PROTOCOL,
            )

    def render_video(self, frames_rgb: Sequence[np.ndarray], out_path: str,
                     fps: int = 30, alpha: float = 0.5) -> None:
        """Overlay masks on frames and write an mp4 (det_sam2_RT.py:628-651,
        cv2 instead of matplotlib)."""
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError("cv2 required for rendering") from e
        if not frames_rgb:
            return
        h, w = frames_rgb[0].shape[:2]
        writer = cv2.VideoWriter(
            out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
        )
        rng = np.random.default_rng(0)
        colors: Dict[int, np.ndarray] = {}
        for i, frame in enumerate(frames_rgb):
            canvas = frame.copy()
            segs = self.video_segments.get(self.pre_frames + i, {})
            for obj_id, mask in segs.items():
                if obj_id not in colors:
                    colors[obj_id] = rng.integers(60, 255, 3)
                m = np.asarray(mask)[0] if mask.ndim == 3 else np.asarray(mask)
                canvas[m] = (
                    (1 - alpha) * canvas[m] + alpha * colors[obj_id]
                ).astype(np.uint8)
            writer.write(cv2.cvtColor(canvas, cv2.COLOR_RGB2BGR))
        writer.release()
