"""A minimal GraphQL endpoint for the demo backend's session API.

Counterpart of the JAX package's ``serving/graphql.py`` (after the reference
demo's strawberry schema, demo/backend/server/data/schema.py:
Query{defaultVideo, videos} and Mutation{uploadVideo, startSession,
closeSession, addPoints, removeObject, clearPointsInFrame,
clearPointsInVideo, cancelPropagateInVideo}) without strawberry or Flask: a
small stdlib parser of a GraphQL subset (one operation, top-level fields,
literal and variable arguments, selection sets that filter the response)
over the same InferenceAPI. Propagation streams outside GraphQL, as in the
reference (/propagate_in_video is a plain route there too).
"""

from __future__ import annotations

import base64
import json
import os
import re
import tempfile
import urllib.parse
import uuid
from typing import Any, Dict, List, Optional, Tuple

from det_sam2_tpu_torch.serving.inference_api import InferenceAPI

# ---------------------------------------------------------------------------
# tiny GraphQL document parser (subset: one operation, scalar/list/object
# literals, $variables, nested selection sets)
# ---------------------------------------------------------------------------

_TOKEN = re.compile(
    r"""\s*(?:(?P<punct>[{}():,!\[\]$=])
            |(?P<string>"(?:\\.|[^"\\])*")
            |(?P<number>-?\d+(?:\.\d+)?)
            |(?P<name>[_A-Za-z][_0-9A-Za-z]*)
            |(?P<comment>\#[^\n]*))""",
    re.VERBOSE,
)


def _tokenize(src: str) -> List[Tuple[str, str]]:
    out, i = [], 0
    while i < len(src):
        m = _TOKEN.match(src, i)
        if m is None:
            if src[i:].strip() == "":
                break
            raise ValueError(f"GraphQL parse error at {src[i:i + 20]!r}")
        i = m.end()
        kind = m.lastgroup
        if kind != "comment":
            out.append((kind, m.group(kind)))
    return out


class _Parser:
    def __init__(self, tokens: List[Tuple[str, str]]):
        self.toks = tokens
        self.pos = 0

    def peek(self) -> Optional[Tuple[str, str]]:
        return self.toks[self.pos] if self.pos < len(self.toks) else None

    def next(self) -> Tuple[str, str]:
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of GraphQL document")
        self.pos += 1
        return t

    def expect(self, value: str) -> None:
        t = self.next()
        if t[1] != value:
            raise ValueError(f"expected {value!r}, got {t[1]!r}")

    # ------------------------------------------------------------------

    def parse_document(self) -> dict:
        op_type = "query"
        t = self.peek()
        if t and t[0] == "name" and t[1] in ("query", "mutation"):
            op_type = self.next()[1]
            t = self.peek()
            if t and t[0] == "name":  # operation name
                self.next()
                t = self.peek()
            if t and t[1] == "(":  # variable definitions: skip to ')'
                depth = 0
                while True:
                    tok = self.next()[1]
                    depth += tok == "("
                    depth -= tok == ")"
                    if depth == 0:
                        break
        fields = self.parse_selection_set()
        return {"operation": op_type, "fields": fields}

    def parse_selection_set(self) -> List[dict]:
        self.expect("{")
        fields = []
        while True:
            t = self.peek()
            if t is None:
                raise ValueError("unterminated selection set")
            if t[1] == "}":
                self.next()
                return fields
            fields.append(self.parse_field())

    def parse_field(self) -> dict:
        name = self.next()[1]
        # alias support: `alias: field`
        alias = None
        t = self.peek()
        if t and t[1] == ":":
            self.next()
            alias, name = name, self.next()[1]
        args: Dict[str, Any] = {}
        t = self.peek()
        if t and t[1] == "(":
            self.next()
            while self.peek() and self.peek()[1] != ")":
                argname = self.next()[1]
                self.expect(":")
                args[argname] = self.parse_value()
                if self.peek() and self.peek()[1] == ",":
                    self.next()
            self.expect(")")
        selections = None
        t = self.peek()
        if t and t[1] == "{":
            selections = self.parse_selection_set()
        return {"name": name, "alias": alias or name, "args": args,
                "selections": selections}

    def parse_value(self) -> Any:
        kind, val = self.next()
        if kind == "string":
            # GraphQL string escapes are JSON's (\" \\ \/ \b \f \n \r \t
            # \uXXXX) — json.loads handles them without mangling non-ASCII
            # (unicode_escape would mojibake UTF-8 as Latin-1)
            try:
                return json.loads(val)
            except ValueError:
                return val[1:-1]
        if kind == "number":
            return float(val) if "." in val else int(val)
        if val == "$":
            return _Var(self.next()[1])
        if val == "[":
            items = []
            while self.peek() and self.peek()[1] != "]":
                items.append(self.parse_value())
                if self.peek() and self.peek()[1] == ",":
                    self.next()
            self.expect("]")
            return items
        if val == "{":
            obj = {}
            while self.peek() and self.peek()[1] != "}":
                k = self.next()[1]
                self.expect(":")
                obj[k] = self.parse_value()
                if self.peek() and self.peek()[1] == ",":
                    self.next()
            self.expect("}")
            return obj
        if kind == "name":
            return {"true": True, "false": False, "null": None}.get(val, val)
        raise ValueError(f"unexpected value token {val!r}")


class _Var:
    def __init__(self, name: str):
        self.name = name


def _resolve_vars(value: Any, variables: Dict[str, Any]) -> Any:
    if isinstance(value, _Var):
        if value.name not in variables:
            raise ValueError(f"missing variable ${value.name}")
        return variables[value.name]
    if isinstance(value, list):
        return [_resolve_vars(v, variables) for v in value]
    if isinstance(value, dict):
        return {k: _resolve_vars(v, variables) for k, v in value.items()}
    return value


def _filter_selection(data: Any, selections: Optional[List[dict]]) -> Any:
    """Project the result onto the requested selection set (extra server
    fields are dropped, like a real GraphQL executor)."""
    if selections is None or data is None:
        return data
    if isinstance(data, list):
        return [_filter_selection(d, selections) for d in data]
    out = {}
    for sel in selections:
        if sel["name"] in data:
            out[sel["alias"]] = _filter_selection(
                data[sel["name"]], sel["selections"]
            )
    return out


# ---------------------------------------------------------------------------
# executor over InferenceAPI + a filesystem video gallery
# ---------------------------------------------------------------------------


class GraphQLAPI:
    """Resolvers for the reference schema's operations."""

    # server-side ceiling on uploaded-video duration; the client's
    # durationTimeSec can only lower it (reference app_conf.py:27
    # MAX_UPLOAD_VIDEO_DURATION, env-overridable there too)
    MAX_UPLOAD_DURATION = float(
        os.environ.get("MAX_UPLOAD_VIDEO_DURATION", "10")
    )

    def __init__(
        self,
        api: InferenceAPI,
        gallery_dir: Optional[str] = None,
        uploads_dir: Optional[str] = None,
    ):
        self.api = api
        self.gallery_dir = gallery_dir
        self.uploads_dir = uploads_dir or tempfile.mkdtemp(
            prefix="det_sam2_uploads_"
        )
        os.makedirs(self.uploads_dir, exist_ok=True)
        # upload-normalization knobs, env-configured like the reference
        # container (docker-compose.yaml: VIDEO_ENCODE_FPS /
        # VIDEO_ENCODE_MAX_WIDTH / VIDEO_ENCODE_MAX_HEIGHT feed
        # data/transcoder.py). Instance attrs (not import-time) so a
        # restarted server — or a test — picks up the current env.
        self.encode_fps = float(os.environ.get("VIDEO_ENCODE_FPS", "24"))
        self.encode_max_w = int(
            os.environ.get("VIDEO_ENCODE_MAX_WIDTH", "1280"))
        self.encode_max_h = int(
            os.environ.get("VIDEO_ENCODE_MAX_HEIGHT", "1280"))
        # reference: DEFAULT_VIDEO_PATH names the gallery item the UI
        # opens first (app_conf.py), relative to the data root
        self.default_video_path = os.environ.get("DEFAULT_VIDEO_PATH")

    # -- gallery ---------------------------------------------------------

    def _video_info(self, path: str) -> dict:
        from det_sam2_tpu_torch.serving.transcode import get_video_metadata

        meta = get_video_metadata(path)
        return {
            "id": base64.urlsafe_b64encode(path.encode()).decode(),
            "path": path,
            "url": "/video?path=" + urllib.parse.quote(path),
            "width": meta["width"],
            "height": meta["height"],
            "fps": meta["fps"],
            "numFrames": meta["num_frames"],
            "durationSec": meta["duration_sec"],
        }

    def _gallery_paths(self) -> List[str]:
        out = []
        for d in (self.gallery_dir, self.uploads_dir):
            if d and os.path.isdir(d):
                for f in sorted(os.listdir(d)):
                    if f.lower().endswith((".mp4", ".avi", ".mov", ".mkv")):
                        out.append(os.path.join(d, f))
        return out

    def default_video(self, args: dict) -> dict:
        paths = self._gallery_paths()
        if not paths:
            raise ValueError("gallery is empty")
        if self.default_video_path:
            want = self.default_video_path
            for p in paths:
                # match an exact path or a data-root-relative suffix like
                # the reference's "gallery/05_default_juggle.mp4"
                if p == want or p.endswith(os.sep + os.path.basename(want)):
                    return self._video_info(p)
        return self._video_info(paths[0])

    def videos(self, args: dict) -> dict:
        infos = [self._video_info(p) for p in self._gallery_paths()]
        # relay-style connection shape (schema.py:81 uses relay pagination)
        return {
            "totalCount": len(infos),
            "edges": [{"node": i} for i in infos],
        }

    # -- mutations -------------------------------------------------------

    def upload_video(self, args: dict) -> dict:
        from det_sam2_tpu_torch.serving.transcode import transcode

        content = base64.b64decode(args["file"]["contentBase64"])
        name = os.path.basename(args["file"].get("filename", "upload.mp4"))
        raw = os.path.join(self.uploads_dir, f"raw_{uuid.uuid4().hex}_{name}")
        with open(raw, "wb") as f:
            f.write(content)
        out = os.path.join(self.uploads_dir, f"{uuid.uuid4().hex}.mp4")
        try:
            transcode(
                raw, out,
                max_seconds=min(
                    float(args.get("durationTimeSec")
                          or self.MAX_UPLOAD_DURATION),
                    self.MAX_UPLOAD_DURATION,
                ),
                max_w=self.encode_max_w,
                max_h=self.encode_max_h,
                fps=self.encode_fps,
            )
        finally:
            os.unlink(raw)
        return self._video_info(out)

    def start_session(self, args: dict) -> dict:
        path = args["input"]["path"]
        res = self.api.start_session(path)
        return {"sessionId": res["session_id"]}

    def close_session(self, args: dict) -> dict:
        res = self.api.close_session(args["input"]["sessionId"])
        return {"success": res["success"]}

    def _rle_on_frame(self, res: dict) -> dict:
        return {
            "frameIndex": res["frame_index"],
            "rleMaskList": [
                {
                    "objectId": r["object_id"],
                    "rleMask": {"size": r["mask"]["size"],
                                "counts": r["mask"]["counts"]},
                }
                for r in res["results"]
            ],
        }

    def add_points(self, args: dict) -> dict:
        i = args["input"]
        res = self.api.add_points(
            i["sessionId"], i["frameIndex"], i["objectId"],
            i["points"], i["labels"], i.get("clearOldPoints", True),
        )
        return self._rle_on_frame(res)

    def remove_object(self, args: dict) -> List[dict]:
        i = args["input"]
        self.api.remove_object(i["sessionId"], i["objectId"])
        return []

    def clear_points_in_frame(self, args: dict) -> dict:
        i = args["input"]
        self.api.clear_points_in_frame(
            i["sessionId"], i["frameIndex"], i["objectId"]
        )
        return {"success": True}

    def clear_points_in_video(self, args: dict) -> dict:
        res = self.api.reset_session(args["input"]["sessionId"])
        return {"success": res["success"] if "success" in res else True}

    def cancel_propagate_in_video(self, args: dict) -> dict:
        res = self.api.cancel_propagate_in_video(args["input"]["sessionId"])
        return {"success": res["success"]}

    # -- dispatch --------------------------------------------------------

    RESOLVERS = {
        "defaultVideo": ("query", "default_video"),
        "videos": ("query", "videos"),
        "uploadVideo": ("mutation", "upload_video"),
        "startSession": ("mutation", "start_session"),
        "closeSession": ("mutation", "close_session"),
        "addPoints": ("mutation", "add_points"),
        "removeObject": ("mutation", "remove_object"),
        "clearPointsInFrame": ("mutation", "clear_points_in_frame"),
        "clearPointsInVideo": ("mutation", "clear_points_in_video"),
        "cancelPropagateInVideo": ("mutation", "cancel_propagate_in_video"),
    }

    def execute(self, query: str,
                variables: Optional[Dict[str, Any]] = None) -> dict:
        """Execute a GraphQL request -> {"data": ...} or {"errors": [...]}."""
        try:
            doc = _Parser(_tokenize(query)).parse_document()
            data = {}
            for field in doc["fields"]:
                spec = self.RESOLVERS.get(field["name"])
                if spec is None:
                    raise ValueError(f"unknown field {field['name']!r}")
                op_kind, method = spec
                if op_kind != doc["operation"]:
                    raise ValueError(
                        f"{field['name']} is a {op_kind} field, used in a "
                        f"{doc['operation']}"
                    )
                args = _resolve_vars(field["args"], variables or {})
                result = getattr(self, method)(args)
                data[field["alias"]] = _filter_selection(
                    result, field["selections"]
                )
            return {"data": data}
        except Exception as e:  # GraphQL-style error envelope
            return {"errors": [{"message": str(e)}]}
