"""Video -> JPEG frame extraction.

Counterpart of the JAX package's ``tools/extract_frames.py`` (after the
reference's training/scripts/sav_frame_extraction_submitit.py): mp4 ->
fps-resampled JPEG frames, a plain cv2 loop (cv2 imported inside the
function), parallelisable by calling it per video.

    python -m det_sam2_tpu_torch.tools.extract_frames --video_dir V --output_dir O
"""

from __future__ import annotations

import argparse
import os
from typing import Optional


def extract_frames(
    video_path: str, output_dir: str, fps: Optional[float] = 24.0,
    quality: int = 95, start_number: int = 0,
) -> int:
    """Decode a video to <output_dir>/<%05d>.jpg at the given fps (None =
    native). Returns the number of frames written."""
    import cv2

    os.makedirs(output_dir, exist_ok=True)
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open {video_path}")
    native_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    step = 1.0 if fps is None else max(native_fps / fps, 1e-6)
    n_written = 0
    src_idx = 0
    next_keep = 0.0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if src_idx >= next_keep:
            out = os.path.join(
                output_dir, f"{start_number + n_written:05d}.jpg"
            )
            cv2.imwrite(out, frame, [cv2.IMWRITE_JPEG_QUALITY, quality])
            n_written += 1
            next_keep += step
        src_idx += 1
    cap.release()
    return n_written


def main():  # pragma: no cover
    ap = argparse.ArgumentParser()
    ap.add_argument("--video_dir", required=True)
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--fps", type=float, default=24.0)
    args = ap.parse_args()
    for name in sorted(os.listdir(args.video_dir)):
        if not name.lower().endswith((".mp4", ".avi", ".mov", ".mkv")):
            continue
        stem = os.path.splitext(name)[0]
        n = extract_frames(
            os.path.join(args.video_dir, name),
            os.path.join(args.output_dir, stem),
            fps=args.fps,
        )
        print(f"{name}: {n} frames")


if __name__ == "__main__":  # pragma: no cover
    main()
