"""Host-side frame I/O and mask utilities of the video predictor.

The port's own copy of the JAX package's ``utils/misc.py``, with no optional
package on the ndarray frame path: the JAX package resizes those frames with
cv2, and the port computes cv2's arithmetic on the host without it
(``utils.cv2_resize``), so both give the same bytes. PIL is imported only to
decode image files, which it also resizes (as the JAX package does), and cv2
only to decode video files. Frames are stored as resized uint8
[image_size, image_size, 3]; the patch embed normalises them.
"""

from __future__ import annotations

import os
from typing import List, Tuple, Union

import numpy as np
import torch

from det_sam2_tpu_torch.modeling.layers import IMAGENET_MEAN, IMAGENET_STD
from det_sam2_tpu_torch.utils.cv2_resize import (
    MASK_GROUP,
    resize_chw,
    resize_linear,
    resize_linear_float,
)

IMG_MEAN = np.asarray(IMAGENET_MEAN, np.float32)
IMG_STD = np.asarray(IMAGENET_STD, np.float32)
VIDEO_EXTENSIONS = (".mp4", ".avi", ".mov", ".mkv")


def _load_image_file(path: str, image_size: int) -> Tuple[np.ndarray, int, int]:
    """Decode an image file with PIL -> (resized uint8 frame, height, width).
    Decoded and resized as the JAX package does: PIL's ``Image.resize`` with
    its default filter (not ``prepare_frame``, which differs from it by tens
    of uint8 levels away from model size)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding {path} needs Pillow (PIL), which is not installed; pass "
            "the frames as ndarrays instead"
        ) from e
    with Image.open(path) as im:
        img = im.convert("RGB")
    w, h = img.size
    return np.asarray(img.resize((image_size, image_size))), h, w


def prepare_frame(frame_rgb: np.ndarray, image_size: int) -> np.ndarray:
    """One RGB frame [H, W, 3] -> resized uint8 [image_size, image_size, 3],
    equal to ``cv2.resize(frame, (image_size, image_size))`` as the JAX
    package computes it (cv2's INTER_LINEAR, rebuilt without cv2). Float frames
    are accepted in [0, 1] or [0, 255] and cast to uint8 first, as there; a
    frame already at model size comes back as an equal copy."""
    if frame_rgb.dtype != np.uint8:
        frame_rgb = np.asarray(frame_rgb, np.float32)
        if frame_rgb.size and float(frame_rgb.max()) <= 1.0:
            frame_rgb = frame_rgb * 255.0
        frame_rgb = np.clip(frame_rgb, 0, 255).astype(np.uint8)
    if frame_rgb.shape[:2] == (image_size, image_size):
        return np.array(frame_rgb)
    return resize_linear(frame_rgb, image_size)


def normalize_frame(frame_rgb: np.ndarray, image_size: int) -> np.ndarray:
    """Resize and normalise on the host (fp32): ``prepare_frame``, / 255, then
    the ImageNet mean and std. The predictor stores ``prepare_frame``'s uint8
    and normalises on the device instead."""
    img = prepare_frame(frame_rgb, image_size).astype(np.float32) / 255.0
    return ((img - IMG_MEAN) / IMG_STD).astype(np.float32)


def tensor_to_frame_rgb(
    frame: np.ndarray,
    original_size: Tuple[int, int] = (1920, 1080),
) -> np.ndarray:
    """A stored frame (resized uint8, or normalised float) [S, S, 3] -> uint8
    RGB at the video's (W, H): the ImageNet normalisation undone, cv2's
    float INTER_LINEAR resize (rebuilt in numpy), then * 255, clipped and
    truncated, as the JAX package computes it."""
    if frame.dtype == np.uint8:
        img = frame.astype(np.float32) / 255.0
    else:
        img = frame.astype(np.float32) * IMG_STD + IMG_MEAN
    img = resize_linear_float(img, original_size)
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)


def list_frame_dir(video_path: str) -> List[str]:
    """A JPEG / PNG frame directory in frame-number order (int-named
    stems)."""
    names = [
        p
        for p in os.listdir(video_path)
        if os.path.splitext(p)[-1].lower() in (".jpg", ".jpeg", ".png")
    ]
    names.sort(key=lambda p: int(os.path.splitext(p)[0]))
    if not names:
        raise RuntimeError(f"no frames found in {video_path}")
    return [os.path.join(video_path, n) for n in names]


def load_video_frames(
    video_path: Union[str, List, np.ndarray],
    image_size: int,
) -> Tuple[List[np.ndarray], int, int]:
    """JPEG / PNG dir, list of paths, single image path, single ndarray
    frame, [N, H, W, 3] ndarray stack, list of ndarray frames, or video file
    (needs cv2) -> (list of resized uint8 HWC frames, video height, video
    width)."""
    if isinstance(video_path, np.ndarray):
        if video_path.ndim == 4:  # [N, H, W, 3] frame stack
            h, w = video_path.shape[1:3]
            return [prepare_frame(f, image_size) for f in video_path], h, w
        h, w = video_path.shape[:2]
        return [prepare_frame(video_path, image_size)], h, w

    if isinstance(video_path, list) and video_path and isinstance(
        video_path[0], np.ndarray
    ):
        h, w = video_path[0].shape[:2]
        return [prepare_frame(f, image_size) for f in video_path], h, w

    if isinstance(video_path, list):
        img_paths = list(video_path)
    elif isinstance(video_path, str) and os.path.isdir(video_path):
        img_paths = list_frame_dir(video_path)
    elif isinstance(video_path, str) and os.path.isfile(video_path):
        if os.path.splitext(video_path)[-1].lower() in VIDEO_EXTENSIONS:
            return _load_video_file(video_path, image_size)
        img_paths = [video_path]
    else:
        raise NotImplementedError(f"unsupported video input: {type(video_path)}")

    frames = []
    h = w = None
    for p in img_paths:
        arr, h, w = _load_image_file(p, image_size)
        frames.append(arr)
    return frames, h, w


def _load_video_file(path: str, image_size: int):
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"decoding the video file {path} needs cv2, which is not installed; "
            "pass a frame directory or ndarray frames instead"
        ) from e
    cap = cv2.VideoCapture(path)
    frames = []
    h = w = None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        if h is None:
            h, w = rgb.shape[:2]
        frames.append(prepare_frame(rgb, image_size))
    cap.release()
    if not frames:
        raise RuntimeError(f"no frames decoded from {path}")
    return frames, h, w


def mask_to_box_np(masks: np.ndarray) -> np.ndarray:
    """[..., H, W] binary -> xyxy [..., 4] fp32 with inclusive edges; empty
    masks -> zeros (SAM's mask_to_box and the AMG's batched_mask_to_box)."""
    shape = masks.shape[:-2]
    h, w = masks.shape[-2:]
    if masks.size == 0:
        return np.zeros((*shape, 4), np.float32)
    flat = masks.reshape(-1, h, w) > 0
    any_y = flat.any(axis=2)  # [B, H] rows holding foreground
    any_x = flat.any(axis=1)  # [B, W] columns holding foreground
    y_min = np.argmax(any_y, axis=1)
    y_max = h - 1 - np.argmax(any_y[:, ::-1], axis=1)
    x_min = np.argmax(any_x, axis=1)
    x_max = w - 1 - np.argmax(any_x[:, ::-1], axis=1)
    out = np.stack([x_min, y_min, x_max, y_max], axis=-1).astype(np.float32)
    out[~any_y.any(axis=1)] = 0.0
    return out.reshape(*shape, 4)


def to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Tensors -> fp32 numpy arrays with one synchronisation: the device
    copies are queued into pinned memory, then the stream is waited for
    once."""
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    if any(t.is_cuda for t in tensors):
        torch.cuda.current_stream().synchronize()
    return [h.float().numpy() for h in host]


def concat_points(old, points: np.ndarray, labels: np.ndarray):
    """Merge point prompts. old is None or a dict."""
    if old is None:
        return {"point_coords": points, "point_labels": labels}
    return {
        "point_coords": np.concatenate([old["point_coords"], points], axis=1),
        "point_labels": np.concatenate([old["point_labels"], labels], axis=1),
    }


def resize_masks_np(masks: np.ndarray, out_hw: Tuple[int, int],
                    group: int = MASK_GROUP) -> np.ndarray:
    """Host resize of mask logits [..., h, w] -> [..., H, W] float32, equal
    to the JAX package's ``resize_masks_np`` with cv2 present: the masks go
    through cv2's channel axis ``group`` (128) at a time, and each group
    takes the path cv2 takes at its channel count (IPP at 1, 3 or 4, the
    generic float INTER_LINEAR otherwise), rebuilt without cv2
    (``utils.cv2_resize``). group=1 is one cv2 call a mask, as the JAX
    predictor resizes each object's row when it consolidates a frame."""
    h, w = masks.shape[-2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (h, w) == (oh, ow):
        return masks
    lead = masks.shape[:-2]
    flat = np.ascontiguousarray(masks, np.float32).reshape(-1, h, w)
    flat = torch.from_numpy(flat if flat.flags.writeable else flat.copy())
    out = torch.empty((flat.shape[0], oh, ow), dtype=torch.float32)
    for i in range(0, flat.shape[0], group):
        resize_chw(flat[i:i + group], out[i:i + group])
    return out.numpy().reshape(*lead, oh, ow)


class AsyncFrameLoader:
    """Background-thread frame preparation: image paths or RGB ndarrays,
    resized on a daemon thread ahead of consumption; indexed access blocks
    only until the requested frame is ready."""

    def __init__(self, sources, image_size: int, prefetch: int = 64):
        import threading

        self.sources = list(sources)
        self.image_size = image_size
        self.prefetch = prefetch
        self._frames: dict = {}
        self._cond = threading.Condition()
        self._error = None
        self._max_requested = 0
        self.video_height = None
        self.video_width = None
        if self.sources:
            first = self._load(0)
            with self._cond:
                self._frames[0] = first
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _load(self, idx: int) -> np.ndarray:
        src = self.sources[idx]
        if isinstance(src, np.ndarray):
            if self.video_height is None:
                self.video_height, self.video_width = src.shape[:2]
            return prepare_frame(src, self.image_size)
        # the eager loader's decode and resize: async loading changes the
        # schedule, not the pixels
        arr, h, w = _load_image_file(src, self.image_size)
        if self.video_height is None:
            self.video_height, self.video_width = h, w
        return arr

    def _worker(self):
        try:
            for i in range(len(self.sources)):
                if i in self._frames:
                    continue
                # at most `prefetch` frames ahead of the furthest request;
                # loaded frames stay cached for random access
                with self._cond:
                    while (
                        i > self._max_requested + self.prefetch
                        and self._error is None
                    ):
                        self._cond.wait(timeout=5)
                frame = self._load(i)
                with self._cond:
                    self._frames[i] = frame
                    self._cond.notify_all()
        except Exception as e:  # surfaced on next access
            with self._cond:
                self._error = e
                self._cond.notify_all()

    def __len__(self):
        return len(self.sources)

    def __getitem__(self, idx: int) -> np.ndarray:
        if not (0 <= idx < len(self.sources)):
            raise IndexError(
                f"frame {idx} out of range [0, {len(self.sources)})"
            )
        with self._cond:
            if idx > self._max_requested:
                self._max_requested = idx
                self._cond.notify_all()  # wake the worker's prefetch gate
            while idx not in self._frames and self._error is None:
                self._cond.wait(timeout=30)
            if self._error is not None:
                raise self._error
            return self._frames[idx]

    def to_list(self):
        return [self[i] for i in range(len(self))]
