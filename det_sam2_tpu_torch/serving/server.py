"""HTTP serving of the video predictor (stdlib; no Flask).

Counterpart of the JAX package's ``serving/server.py``: the reference demo
backend's session API (demo/backend/server/app.py + inference/predictor.py)
on a ThreadingHTTPServer with JSON endpoints; propagation streams
newline-delimited JSON (the reference streams multipart chunks). The model
runs on the predictor's device (CUDA unless the caller built it on the CPU).

    python -m det_sam2_tpu_torch.serving.server [--model hiera_s] [--port 7263]

Endpoints (all POST with JSON bodies unless noted):
  GET  /                       demo frontend (serving/frontend.py)
  GET  /healthy
  GET  /session_info?session_id=
  GET  /frame?session_id=&index=   -> image/jpeg
  GET  /video?path=                -> video file from gallery/uploads
  POST /graphql                {"query", "variables"} — the reference demo
                               schema's operations (serving/graphql.py)
  POST /start_session          {"video_path": ...}
  POST /add_points             {"session_id", "frame_index", "object_id",
                                "points", "labels", "clear_old_points"}
  POST /add_box                {"session_id", "frame_index", "object_id", "box"}
  POST /add_mask               {"session_id", "frame_index", "object_id", "mask"}
  POST /clear_points_in_frame  {"session_id", "frame_index", "object_id"}
  POST /remove_object          {"session_id", "object_id"}
  POST /reset_session          {"session_id"}
  POST /propagate_in_video     {"session_id", "start_frame_index",
                                "max_frame_num_to_track", "reverse"}
                               -> streamed JSON lines
  POST /cancel_propagate_in_video {"session_id"}
  POST /close_session          {"session_id"}
"""

from __future__ import annotations

import json
import os
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, TYPE_CHECKING

from det_sam2_tpu_torch.configs import MODEL_CONFIGS
from det_sam2_tpu_torch.configs import MODEL_SIZE_ALIASES as _MODEL_SIZE_ALIASES
from det_sam2_tpu_torch.serving.inference_api import InferenceAPI

if TYPE_CHECKING:  # pragma: no cover
    from det_sam2_tpu_torch.serving.graphql import GraphQLAPI


def make_handler(api: InferenceAPI, gql: Optional["GraphQLAPI"] = None):
    from urllib.parse import parse_qs, urlparse

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _bytes(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_file(self, path: str):
            """Stream a file in 1 MiB chunks; honors a single-span Range
            header (browser <video> seeking) and guesses the MIME type —
            gallery listings include .avi/.mov/.mkv, not just mp4."""
            import mimetypes

            ctype = mimetypes.guess_type(path)[0] or "video/mp4"
            size = os.path.getsize(path)
            start, end = 0, size - 1
            rng = self.headers.get("Range")
            code = 200
            if rng and rng.startswith("bytes="):
                span = rng[len("bytes="):].split(",")[0]
                s, _, e = span.partition("-")
                if s:
                    start = int(s)
                    end = int(e) if e else size - 1
                elif e:  # suffix range: last N bytes
                    start = max(0, size - int(e))
                if start >= size:
                    self.send_response(416)
                    self.send_header("Content-Range", f"bytes */{size}")
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                end = min(end, size - 1)
                code = 206
            length = end - start + 1
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(length))
            self.send_header("Accept-Ranges", "bytes")
            if code == 206:
                self.send_header(
                    "Content-Range", f"bytes {start}-{end}/{size}"
                )
            self.end_headers()
            with open(path, "rb") as f:
                f.seek(start)
                left = length
                while left > 0:
                    buf = f.read(min(1 << 20, left))
                    if not buf:
                        break
                    self.wfile.write(buf)
                    left -= len(buf)

        def do_GET(self):
            try:
                url = urlparse(self.path)
                qs = {k: v[0] for k, v in parse_qs(url.query).items()}
                if url.path == "/healthy":
                    self._json(200, {"status": "ok"})
                elif url.path == "/":
                    from det_sam2_tpu_torch.serving.frontend import INDEX_HTML

                    self._bytes(200, INDEX_HTML.encode(),
                                "text/html; charset=utf-8")
                elif url.path == "/session_info":
                    self._json(200, api.session_info(qs["session_id"]))
                elif url.path == "/frame":
                    jpg = api.frame_jpeg(qs["session_id"], int(qs["index"]))
                    self._bytes(200, jpg, "image/jpeg")
                elif url.path == "/video" and gql is not None:
                    path = qs["path"]
                    allowed = [d for d in (gql.gallery_dir, gql.uploads_dir)
                               if d]
                    real = os.path.realpath(path)
                    if not any(
                        real.startswith(os.path.realpath(d) + os.sep)
                        for d in allowed
                    ):
                        self._json(403, {"error": "path outside gallery"})
                        return
                    self._send_file(real)
                else:
                    self._json(404, {"error": "not found"})
            except Exception as e:
                traceback.print_exc()
                try:
                    self._json(500, {"error": str(e)})
                except Exception:
                    pass

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(length) or b"{}")
                route = self.path.rstrip("/")
                if route == "/graphql" and gql is not None:
                    self._json(200, gql.execute(
                        body.get("query", ""), body.get("variables")
                    ))
                elif route == "/start_session":
                    self._json(200, api.start_session(body["video_path"]))
                elif route == "/add_points":
                    self._json(200, api.add_points(
                        body["session_id"], body["frame_index"],
                        body["object_id"], body["points"], body["labels"],
                        body.get("clear_old_points", True),
                    ))
                elif route == "/add_box":
                    self._json(200, api.add_box(
                        body["session_id"], body["frame_index"],
                        body["object_id"], body["box"],
                    ))
                elif route == "/add_mask":
                    self._json(200, api.add_mask(
                        body["session_id"], body["frame_index"],
                        body["object_id"], body["mask"],
                    ))
                elif route == "/clear_points_in_frame":
                    self._json(200, api.clear_points_in_frame(
                        body["session_id"], body["frame_index"],
                        body["object_id"],
                    ))
                elif route == "/remove_object":
                    self._json(200, api.remove_object(
                        body["session_id"], body["object_id"]
                    ))
                elif route == "/reset_session":
                    self._json(200, api.reset_session(body["session_id"]))
                elif route == "/cancel_propagate_in_video":
                    self._json(200, api.cancel_propagate_in_video(
                        body["session_id"]
                    ))
                elif route == "/close_session":
                    self._json(200, api.close_session(body["session_id"]))
                elif route == "/propagate_in_video":
                    gen = api.propagate_in_video(
                        body["session_id"],
                        body.get("start_frame_index"),
                        body.get("max_frame_num_to_track"),
                        body.get("reverse", False),
                    )
                    # pull the first item BEFORE committing the 200 — a
                    # generator defers argument errors (unknown session_id)
                    # to first iteration, and a second response written
                    # into an open chunked stream corrupts the connection
                    try:
                        first = next(gen)
                    except StopIteration:
                        first = None
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-ndjson")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def _chunk(obj):
                        line = (json.dumps(obj) + "\n").encode()
                        self.wfile.write(
                            f"{len(line):x}\r\n".encode() + line + b"\r\n"
                        )

                    try:
                        if first is not None:
                            _chunk(first)
                        for item in gen:
                            _chunk(item)
                    except Exception as e:  # mid-stream: final error line
                        traceback.print_exc()
                        _chunk({"error": str(e)})
                    self.wfile.write(b"0\r\n\r\n")
                else:
                    self._json(404, {"error": f"unknown route {route}"})
            except Exception as e:  # surface errors as 500 JSON
                traceback.print_exc()
                try:
                    self._json(500, {"error": str(e)})
                except Exception:
                    pass

    return Handler


def serve(api: InferenceAPI, host: str = "0.0.0.0", port: int = 7263,
          gallery_dir: Optional[str] = None,
          uploads_dir: Optional[str] = None):
    """Blocking server (reference backend default port 7263)."""
    from det_sam2_tpu_torch.serving.graphql import GraphQLAPI

    gql = GraphQLAPI(api, gallery_dir=gallery_dir, uploads_dir=uploads_dir)
    server = ThreadingHTTPServer((host, port), make_handler(api, gql))
    server.serve_forever()


# The reference container configures the backend entirely through env vars
# (docker-compose.yaml: MODEL_SIZE, GUNICORN_PORT, DATA_PATH,
# DEFAULT_VIDEO_PATH). Accept both its MODEL_SIZE vocabulary and ours.


def env_config(environ=None) -> dict:
    """Resolve serving defaults from the container environment (the
    deploy/ recipes set these; CLI flags still win). Mirrors the reference
    backend's env surface (backend.Dockerfile:7-16, docker-compose.yaml
    environment block): MODEL_SIZE, CHECKPOINT_PATH, SERVER_PORT (alias
    GUNICORN_PORT), DATA_PATH (gallery/ + uploads/ subdirs, the compose
    file's /data mount), GALLERY_PATH / UPLOADS_PATH overrides."""
    env = os.environ if environ is None else environ
    model = env.get("MODEL_SIZE", "hiera_s")
    model = _MODEL_SIZE_ALIASES.get(model, model)
    # argparse does not validate DEFAULTS against choices — a typo'd env
    # var would otherwise surface much later as a raw KeyError in the
    # engine builder. Fail at config time with the valid vocabulary.
    if model not in MODEL_CONFIGS:
        raise ValueError(
            f"MODEL_SIZE={env.get('MODEL_SIZE')!r} is not a known model: "
            f"use one of {sorted(_MODEL_SIZE_ALIASES)} or "
            f"{sorted(MODEL_CONFIGS)}"
        )
    data = env.get("DATA_PATH")
    gallery = env.get("GALLERY_PATH") or (
        os.path.join(data, "gallery") if data else None)
    uploads = env.get("UPLOADS_PATH") or (
        os.path.join(data, "uploads") if data else None)
    return {
        "model": model,
        "checkpoint": env.get("CHECKPOINT_PATH") or None,
        "port": int(env.get("SERVER_PORT") or env.get("GUNICORN_PORT")
                    or 7263),
        "gallery": gallery,
        "uploads": uploads,
    }


def main():  # pragma: no cover
    import argparse

    import torch

    from det_sam2_tpu_torch.build import build_sam2_engine
    from det_sam2_tpu_torch.video_predictor import SAM2VideoPredictor

    defaults = env_config()
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default=defaults["model"],
                    choices=MODEL_CONFIGS)
    ap.add_argument("--checkpoint", default=defaults["checkpoint"])
    ap.add_argument("--port", type=int, default=defaults["port"])
    ap.add_argument("--gallery", default=defaults["gallery"],
                    help="directory of mp4s for the demo gallery")
    ap.add_argument("--uploads", default=defaults["uploads"],
                    help="directory for uploaded/transcoded videos")
    ap.add_argument("--int8", action="store_true",
                    help="serve with the W8A8 int8 trunk (ops/quant.py: int8 "
                    "weights and activations, torch._int_mm on the card)")
    args = ap.parse_args()

    # bf16 on CUDA; raises without a card
    engine = build_sam2_engine(
        args.model, args.checkpoint, dtype=torch.bfloat16,
        quantize_int8=args.int8,
    )
    api = InferenceAPI(SAM2VideoPredictor(engine))
    serve(api, port=args.port, gallery_dir=args.gallery,
          uploads_dir=args.uploads)


if __name__ == "__main__":  # pragma: no cover
    main()
