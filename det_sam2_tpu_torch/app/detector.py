"""Pluggable detector interface for the self-prompting pipeline.

Counterpart of the JAX package's ``app/detector.py``. Det-SAM2 hard-wires
ultralytics YOLOv8 (det_sam2_RT.py detect_predict); here a small protocol
lets any box detector drive the pipeline: the ultralytics YOLO adapter when
that optional package and its weights are installed, a user-provided
callable, or the synthetic detectors of the tests and chip_smoke.py.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Protocol, Sequence

import numpy as np


@dataclasses.dataclass
class Detection:
    """One detection: xyxy box in video pixels + integer class + score."""

    box: np.ndarray  # [4] float32 xyxy
    cls: int
    confidence: float = 1.0


class Detector(Protocol):
    def __call__(
        self, frames: Sequence[np.ndarray], frame_indices: Sequence[int]
    ) -> Dict[int, List[Detection]]:
        """frames: RGB uint8 arrays; frame_indices: absolute indices.
        Returns {absolute_frame_idx: [Detection, ...]}."""
        ...


class CallableDetector:
    """Wrap a per-frame function frame -> [(x1,y1,x2,y2,cls,conf), ...]."""

    def __init__(self, fn: Callable[[np.ndarray, int], List]):
        self.fn = fn

    def __call__(self, frames, frame_indices):
        out: Dict[int, List[Detection]] = {}
        for frame, idx in zip(frames, frame_indices):
            dets = []
            for item in self.fn(frame, idx):
                x1, y1, x2, y2, cls, conf = item
                dets.append(
                    Detection(
                        box=np.asarray([x1, y1, x2, y2], np.float32),
                        cls=int(cls),
                        confidence=float(conf),
                    )
                )
            out[idx] = dets
        return out


class TorchYoloDetector:
    """ultralytics YOLO adapter (requires the optional ultralytics package;
    mirrors det_sam2_RT.py:228 conf/iou settings)."""

    def __init__(self, weights: str, confidence: float = 0.85, iou: float = 0.1):
        try:
            from ultralytics import YOLO
        except ImportError as e:  # pragma: no cover
            raise ImportError(
                "TorchYoloDetector requires the 'ultralytics' package"
            ) from e
        self.model = YOLO(weights)
        self.confidence = confidence
        self.iou = iou

    def __call__(self, frames, frame_indices):  # pragma: no cover (needs pkg)
        import cv2

        bgr = [cv2.cvtColor(f, cv2.COLOR_RGB2BGR) for f in frames]
        results = self.model(
            bgr, stream=True, conf=self.confidence, iou=self.iou, verbose=False
        )
        out: Dict[int, List[Detection]] = {}
        for idx, result in zip(frame_indices, results):
            dets = []
            if result.boxes is not None:
                for box in result.boxes:
                    dets.append(
                        Detection(
                            box=box.xyxy[0].cpu().numpy().astype(np.float32),
                            cls=int(box.cls.item()),
                            confidence=float(box.conf.item()),
                        )
                    )
            out[idx] = dets
        return out


class NullDetector:
    """Never detects anything (detect_interval=-1 equivalent)."""

    def __call__(self, frames, frame_indices):
        return {idx: [] for idx in frame_indices}
