"""RTSP / video-stream connectivity probe and frame streams.

Counterpart of the JAX package's ``app/rtsp.py``: open a stream, report
fps / resolution and read a few frames (headless, no display loop).
``probe_stream`` and ``stream_frames`` decode with cv2, imported when
called; ``iter_video_frames`` needs it only for a path or URL and takes any
iterable of ndarray frames (a list, a generator) without it.
"""

from __future__ import annotations

from typing import Optional


def probe_stream(url: str, num_frames: int = 10) -> Optional[dict]:
    """Returns {'fps', 'width', 'height', 'frames_read'} or None when the
    stream cannot be opened."""
    import cv2

    cap = cv2.VideoCapture(url)
    if not cap.isOpened():
        return None
    info = {
        "fps": cap.get(cv2.CAP_PROP_FPS),
        "width": int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        "height": int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
        "frames_read": 0,
    }
    for _ in range(num_frames):
        ok, _ = cap.read()
        if not ok:
            break
        info["frames_read"] += 1
    cap.release()
    return info


def stream_frames(url: str, max_frames: Optional[int] = None):
    """Generator of RGB frames from an RTSP/file source (feed into
    VideoProcessor.run or DetSAM2Pipeline.inference)."""
    import cv2

    cap = cv2.VideoCapture(url)
    if not cap.isOpened():
        cap.release()
        raise RuntimeError(f"cannot open video source: {url}")
    i = 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok or (max_frames is not None and i >= max_frames):
                break
            yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            i += 1
    finally:
        cap.release()


def iter_video_frames(video_source, max_frames: Optional[int] = None):
    """RGB frames from a path/URL (cv2) or any ndarray iterable — the one
    stream-decoding loop shared by VideoProcessor.run and
    DetSAM2Pipeline.inference."""
    if isinstance(video_source, str):
        yield from stream_frames(video_source, max_frames)
        return
    for i, frame in enumerate(video_source):
        if max_frames is not None and i >= max_frames:
            break
        yield frame
