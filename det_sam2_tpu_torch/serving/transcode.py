"""Upload normalisation for the serving layer.

Counterpart of the JAX package's ``serving/transcode.py`` (after the
reference demo's data/transcoder.py, which shells out to ffmpeg): probe an
uploaded video, cap its duration and resolution, and re-encode it to a
normalised mp4. cv2 is optional and imported inside the functions;
the ``ffmpeg`` binary is used when it is on the PATH.
"""

from __future__ import annotations

import shutil
import subprocess
from typing import Optional


def get_video_metadata(path: str) -> dict:
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video {path}")
    meta = {
        "fps": cap.get(cv2.CAP_PROP_FPS) or 30.0,
        "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        "num_frames": int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
    }
    meta["duration_sec"] = meta["num_frames"] / max(meta["fps"], 1e-6)
    cap.release()
    return meta


def transcode(
    in_path: str,
    out_path: str,
    max_seconds: float = 10.0,
    max_dim: int = 1280,
    fps: Optional[float] = 24.0,
    max_w: Optional[int] = None,
    max_h: Optional[int] = None,
) -> dict:
    """Re-encode to mp4 with duration/resolution caps (the demo's upload
    guardrails). Returns the output metadata.

    ``max_w``/``max_h`` cap each axis independently (the reference's
    VIDEO_ENCODE_MAX_WIDTH/HEIGHT semantics, transcoder.py scale filter);
    when unset both fall back to the single long-side cap ``max_dim``."""
    meta = get_video_metadata(in_path)
    scale = min(
        1.0,
        (max_w or max_dim) / meta["width"],
        (max_h or max_dim) / meta["height"],
    ) if (max_w or max_h) else min(
        1.0, max_dim / max(meta["width"], meta["height"]))
    out_w = int(meta["width"] * scale) // 2 * 2
    out_h = int(meta["height"] * scale) // 2 * 2
    out_fps = fps or meta["fps"]
    max_frames = int(max_seconds * out_fps)

    if shutil.which("ffmpeg"):  # pragma: no cover (ffmpeg is optional)
        cmd = [
            "ffmpeg", "-y", "-t", str(max_seconds), "-i", in_path,
            "-vf", f"scale={out_w}:{out_h},fps={out_fps}",
            "-an", out_path,
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        return get_video_metadata(out_path)

    import cv2

    cap = cv2.VideoCapture(in_path)
    writer = cv2.VideoWriter(
        out_path, cv2.VideoWriter_fourcc(*"mp4v"), out_fps, (out_w, out_h)
    )
    # ffmpeg `fps=` semantics: output tick j shows the source frame at
    # floor(j * src_fps / out_fps) — duplicates when upsampling, drops
    # when downsampling, so playback speed is preserved either way. The
    # duration cap is measured in SOURCE time (ffmpeg's `-t`), not output
    # frames.
    src_fps = max(meta["fps"], 1e-6)
    max_src = int(round(max_seconds * src_fps))
    written = 0
    src_idx = 0
    while written < max_frames and src_idx < max_src:
        ok, frame = cap.read()
        if not ok:
            break
        if int(written * src_fps / out_fps) == src_idx:
            if (frame.shape[1], frame.shape[0]) != (out_w, out_h):
                frame = cv2.resize(frame, (out_w, out_h))
            while (written < max_frames
                   and int(written * src_fps / out_fps) == src_idx):
                writer.write(frame)
                written += 1
        src_idx += 1
    cap.release()
    writer.release()
    if written == 0:
        raise RuntimeError(f"no frames transcoded from {in_path}")
    return get_video_metadata(out_path)
