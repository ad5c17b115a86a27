"""DetSAM2Pipeline: asynchronous end-to-end inference + postprocessing.

Counterpart of the JAX package's ``app/pipeline.py`` (Det-SAM2's
Det_SAM2_pipeline.py): the calling thread streams frames through the
VideoProcessor (all device work stays on it) and hands finished segments,
host bool masks, to a queue; a second thread, started once pockets are
detected, consumes the queue and runs the billiards postprocessor
incrementally on numpy only. Ordering rule: the postprocessor may
RE-process corrected (re-delivered) frames but never skips one; processed
frames are dropped from the shared dict for constant memory.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional, Sequence, Union

import numpy as np

from det_sam2_tpu_torch.app.postprocess import VideoPostProcessor
from det_sam2_tpu_torch.app.video_processor import VideoProcessor

class DetSAM2Pipeline:
    def __init__(
        self,
        video_processor: VideoProcessor,
        post_processor: Optional[VideoPostProcessor] = None,
        max_inference_state_frames: int = 2000,  # pipeline default (:43)
        visualize_postprocess: bool = False,  # retain frames, render overlay
        output_video_dir: Optional[str] = None,  # where the overlay mp4 goes
    ):
        self.video_processor = video_processor
        if getattr(video_processor, "save_session_path", None) is not None:
            # session saving requires keeping ALL frames (the
            # VideoProcessor constructor asserts -1); overriding here would
            # silently truncate the saved session
            if max_inference_state_frames != -1:
                raise ValueError(
                    "video_processor has save_session_path set; pass "
                    "max_inference_state_frames=-1 to DetSAM2Pipeline"
                )
        else:
            self.video_processor.max_inference_state_frames = (
                max_inference_state_frames
            )
        self.post_processor = post_processor or VideoPostProcessor()
        self.frames_queue: "queue.Queue[int]" = queue.Queue()
        self.segments_lock = threading.Lock()
        self.shared_segments: Dict[int, dict] = {}
        self.inference_done = threading.Event()
        self.postprocess_started = threading.Event()
        self._post_thread: Optional[threading.Thread] = None
        self._errors: list = []
        self.skipped_frames: list = []
        # Det-SAM2's Det_SAM2_pipeline.py:28,224-235: when the viz flag is
        # on, every raw frame is retained and the postprocessor's event
        # overlay is rendered to an mp4 after inference completes
        if visualize_postprocess and output_video_dir is None:
            raise ValueError(
                "visualize_postprocess=True requires output_video_dir"
            )
        self.visualize_postprocess = visualize_postprocess
        self.output_video_dir = output_video_dir
        self.retained_frames: list = []
        self.visualized_video_path: Optional[str] = None

    # ------------------------------------------------------------------

    def _hand_off_segments(self) -> None:
        """Move newly finished segments into the shared dict + queue
        (transform_video_segments, Det_SAM2_pipeline.py:59-78)."""
        vp = self.video_processor
        new_frames = sorted(vp.video_segments.keys())
        with self.segments_lock:
            for idx in new_frames:
                self.shared_segments[idx - vp.pre_frames] = vp.video_segments.pop(
                    idx
                )
                self.frames_queue.put(idx - vp.pre_frames)

    def _maybe_start_postprocess(self) -> None:
        if self.postprocess_started.is_set():
            return
        pockets = self.video_processor.special_classes_detection
        if pockets:
            self.post_processor.get_hole_name(list(pockets))
            self.post_processor.get_boundary_from_holes()
            self.postprocess_started.set()
            self._post_thread = threading.Thread(
                target=self._postprocess_loop, daemon=True
            )
            self._post_thread.start()

    def _postprocess_loop(self) -> None:
        """Consume segments in order; re-deliveries allowed, later gaps
        skipped (:176-221: Det-SAM2 drops any frame beyond
        len(has_processed_frames) rather than erroring). The stream may
        START late — the first reverse window begins wherever the detector
        first fires — so the first delivered frame anchors the order."""
        next_expected = None
        try:
            while True:
                try:
                    frame_idx = self.frames_queue.get(timeout=0.2)
                except queue.Empty:
                    if self.inference_done.is_set() and self.frames_queue.empty():
                        break
                    continue
                if next_expected is None:
                    next_expected = frame_idx
                if frame_idx > next_expected:
                    # mid-stream jump (max_frame_num_to_track too small for
                    # the buffer size): drop like Det-SAM2, visibly
                    self.skipped_frames.append(frame_idx)
                    continue
                with self.segments_lock:
                    segments = self.shared_segments.get(frame_idx)
                if segments is None:
                    continue
                self.post_processor.process_single_frame(frame_idx, segments)
                next_expected = max(next_expected, frame_idx + 1)
                # constant memory: drop frames the window can no longer revisit
                horizon = frame_idx - 2 * (
                    self.video_processor.max_frame_num_to_track or 0
                )
                with self.segments_lock:
                    for old in [k for k in self.shared_segments if k < horizon]:
                        self.shared_segments.pop(old, None)
        except Exception as e:  # surfaced by inference()
            self._errors.append(e)

    # ------------------------------------------------------------------

    def inference(
        self,
        video_source: Union[str, Sequence[np.ndarray]],
        max_frames: Optional[int] = None,
    ) -> VideoPostProcessor:
        """Run the full async pipeline (Det_SAM2_pipeline.py:81-247)."""
        from det_sam2_tpu_torch.app.rtsp import iter_video_frames

        vp = self.video_processor
        # step 1 of Det-SAM2's pipeline: preload the memory bank
        # (Det_SAM2_pipeline.py:99-113) — run() does this itself, but the
        # pipeline drives process_frame directly
        if getattr(vp, "load_session_path", None) and vp.session is None:
            vp.session = vp.predictor.load_session_as_preload(
                vp.load_session_path
            )
            vp.pre_frames = vp.session.pre_frames

        for i, frame in enumerate(iter_video_frames(video_source, max_frames)):
            if self.visualize_postprocess:
                self.retained_frames.append(frame)
            vp.process_frame(vp.pre_frames + i, frame)
            self._hand_off_segments()
            self._maybe_start_postprocess()
        vp.finish()
        self._hand_off_segments()
        self._maybe_start_postprocess()
        self.inference_done.set()
        if self._post_thread is not None:
            # the loop provably exits once inference_done is set and the
            # queue drains; a bounded join would race visualize()/events()
            # against a still-running consumer
            self._post_thread.join()
        if self._errors:
            raise self._errors[0]
        if self.visualize_postprocess and self.retained_frames:
            if self.output_video_dir is None:
                raise ValueError(
                    "visualize_postprocess=True requires output_video_dir"
                )
            self.visualized_video_path = self.post_processor.visualize(
                self.retained_frames, self.output_video_dir
            )
        return self.post_processor
