"""PNG / JPEG frame folder -> mp4 (Det-SAM2's frames2video.py); cv2 is
imported when called."""

from __future__ import annotations

import os


def frames_to_video(frames_dir: str, output_path: str, fps: int = 30) -> None:
    import cv2

    names = sorted(
        (n for n in os.listdir(frames_dir)
         if os.path.splitext(n)[-1].lower() in (".png", ".jpg", ".jpeg")),
    )
    if not names:
        raise RuntimeError(f"no frames in {frames_dir}")
    first = cv2.imread(os.path.join(frames_dir, names[0]))
    h, w = first.shape[:2]
    writer = cv2.VideoWriter(
        output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    for n in names:
        img = cv2.imread(os.path.join(frames_dir, n))
        if img is not None:
            writer.write(img)
    writer.release()
