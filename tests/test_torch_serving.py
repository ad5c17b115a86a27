"""The port's serving stack (InferenceAPI, GraphQL, the HTTP server,
transcode) vs the JAX package's, on the same calls.

Both InferenceAPIs run on the CPU over predictors with the same weights
(tests/test_torch_video_predictor.py's engines: tiny_test_config(
fill_hole_area=8, max_objects=4), fp32, TF32 off, gather mode), both
packages' frame loaders resizing with the port's prepare_frame. One session
script (boxes, clicks with and without clear_old_points, a mask prompt, a
prompt cleared, propagation forward and reverse, a cancel after the first
streamed frame and a full pass after it, remove_object, reset_session,
close) is driven through each; every response must be equal, the RLE masks
decoded and equal on >= PIXEL_AGREE of their pixels (logits near 0 may
round to the other side; the packages read 1e-5 apart), the JPEG of a frame
byte for byte. The HTTP tests run the port's server over a real socket:
the round trip against in-process calls on the same predictor (equal), a
cancel from a second connection, clean 500s, the mid-stream error line,
/video with Range and MIME types and its path guard, and grad mode off in
every engine call on a handler thread. GraphQL: the parser and every
resolver against JAX's. env_config and transcode against JAX's.
"""

import base64
import contextlib
import json
import os
import re
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from urllib.parse import quote

import numpy as np
import pytest
import torch

import det_sam2_tpu.serving.graphql as jax_graphql
import det_sam2_tpu.serving.server as jax_server
import det_sam2_tpu.serving.transcode as jax_transcode
from det_sam2_tpu.serving.inference_api import InferenceAPI as JaxAPI
from det_sam2_tpu.video_predictor import SAM2VideoPredictor as JaxPredictor

from det_sam2_tpu_torch.serving import graphql, server, transcode
from det_sam2_tpu_torch.serving.inference_api import InferenceAPI
from det_sam2_tpu_torch.serving.server import make_handler
from det_sam2_tpu_torch.utils.amg import mask_to_rle, rle_to_mask
from det_sam2_tpu_torch.video_predictor import SAM2VideoPredictor

from test_torch_video_predictor import (  # noqa: F401 (fixtures)
    make_engines,
    make_frames,
    one_torch_thread,
    shared_loader,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
PIXEL_AGREE = 0.999  # decoded RLE masks, port vs JAX
H, W, N = 96, 112, 8
BOX1 = [10.0, 8.0, 50.0, 40.0]
CLICKS2 = ([[70.0, 50.0], [80.0, 62.0], [60.0, 80.0]], [1, 1, 0])


def _mask3():
    m = np.zeros((H, W), bool)
    m[50:80, 20:60] = True
    return mask_to_rle(m[None])[0]


def drive_api(api) -> dict:
    """One session through every InferenceAPI method; the responses, the
    session id taken out."""
    rec = {}
    res = api.start_session(make_frames(N, H, W))
    sid = res.pop("session_id")
    rec["start"] = res
    info = api.session_info(sid)
    assert info.pop("session_id") == sid
    rec["info"] = info
    rec["box1"] = api.add_box(sid, 0, 1, BOX1)
    rec["points2"] = api.add_points(sid, 0, 2, *CLICKS2)
    rec["points2_more"] = api.add_points(sid, 0, 2, [[75.0, 55.0]], [1],
                                         clear_old_points=False)
    rec["mask3"] = api.add_mask(sid, 4, 3, _mask3())
    rec["click1_f4"] = api.add_points(sid, 4, 1, [[30.0, 20.0]], [1])
    rec["clear"] = api.clear_points_in_frame(sid, 4, 1)
    rec["forward"] = list(api.propagate_in_video(sid, 0))
    rec["reverse"] = list(api.propagate_in_video(sid, N - 1, reverse=True))
    gen = api.propagate_in_video(sid, 0)
    first = next(gen)
    rec["cancel"] = api.cancel_propagate_in_video(sid)
    rec["canceled"] = [first] + list(gen)
    rec["after_cancel"] = list(api.propagate_in_video(sid, 0))
    rec["remove"] = api.remove_object(sid, 2)
    rec["after_remove"] = list(api.propagate_in_video(sid, 0, 3))
    rec["jpeg"] = api.frame_jpeg(sid, 3)
    rec["reset"] = api.reset_session(sid)
    rec["box_after_reset"] = api.add_box(sid, 2, 5, BOX1)
    rec["after_reset"] = list(api.propagate_in_video(sid, 2, 2))
    rec["close"] = api.close_session(sid)
    rec["close_again"] = api.close_session(sid)
    with pytest.raises(KeyError, match="unknown session"):
        api.session_info(sid)
    return rec


def assert_response_close(got, want, what):
    """Equal, except that RLE masks are compared decoded (PIXEL_AGREE)."""
    if isinstance(want, dict) and set(want) == {"size", "counts"}:
        assert got["size"] == want["size"], what
        a, b = rle_to_mask(got), rle_to_mask(want)
        agree = (a == b).mean()
        assert agree >= PIXEL_AGREE, f"{what}: {agree}"
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            assert_response_close(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_response_close(g, w, f"{what}[{i}]")
    else:
        assert got == want and type(got) is type(want), f"{what}: {got!r} vs {want!r}"


@pytest.fixture(scope="module")
def predictors(shared_loader):
    jeng, eng = make_engines()
    return SAM2VideoPredictor(eng), JaxPredictor(jeng)


@pytest.fixture(scope="module")
def api_runs(predictors):
    vp, jvp = predictors
    return drive_api(InferenceAPI(vp)), drive_api(JaxAPI(jvp))


STEPS = ["start", "info", "box1", "points2", "points2_more", "mask3", "click1_f4",
         "clear", "forward", "reverse", "cancel", "canceled", "after_cancel", "remove",
         "after_remove", "reset", "box_after_reset", "after_reset", "close",
         "close_again"]


@pytest.mark.parametrize("step", STEPS)
def test_api_responses_match_jax(api_runs, step):
    got, want = api_runs
    assert_response_close(got[step], want[step], step)


def test_api_session_went_where_it_should(api_runs):
    got, _ = api_runs
    assert got["start"] == {"num_frames": N, "video_height": H, "video_width": W}
    assert [r["frame_index"] for r in got["forward"]] == list(range(N))
    assert [r["frame_index"] for r in got["reverse"]] == list(range(N - 1, -1, -1))
    assert [r["frame_index"] for r in got["canceled"]] == [0]
    assert got["after_cancel"] == got["forward"]
    assert [r["object_id"] for r in got["forward"][0]["results"]] == [1, 2, 3]
    assert got["remove"] == {"object_ids": [1, 3]}
    assert [r["frame_index"] for r in got["after_reset"]] == [2, 3, 4]
    assert got["close"] == {"success": True} and got["close_again"] == {"success": False}
    for r in got["forward"]:  # some foreground on every frame
        assert any(sum(o["mask"]["counts"][1::2]) for o in r["results"])


def test_frame_jpeg_equals_jax(api_runs):
    got, want = api_runs
    assert got["jpeg"][:2] == b"\xff\xd8" and got["jpeg"] == want["jpeg"]


# ---------------------------------------------------------------------------
# the HTTP server
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def serving(api, gql=None):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(api, gql))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()


def _post(port, route, payload, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{route}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _post_json(port, route, payload):
    with _post(port, route, payload) as r:
        assert r.status == 200
        return json.load(r)


def _ndjson(port, payload):
    with _post(port, "/propagate_in_video", payload) as r:
        assert r.headers["Content-Type"] == "application/x-ndjson"
        return [json.loads(line) for line in r.read().decode().splitlines()]


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("frames")
    for i, f in enumerate(make_frames(N, H, W, seed=3)):
        Image.fromarray(f).save(d / f"{i:05d}.png")
    return str(d)


def test_http_round_trip_equals_in_process_calls(predictors, frames_dir, monkeypatch):
    """A session over HTTP against the same calls in process on the same
    predictor: equal responses. Every engine call made on a handler thread
    runs with grad mode off (grad mode is thread-local in PyTorch)."""
    vp, _ = predictors
    eng = vp.engine
    grad_seen = []
    for name in ("encode_image", "prompt_step", "track_step", "propagate_window",
                 "encode_cond_memory", "encode_noncond_memory", "mask_prompt_step"):
        fn = getattr(eng, name)

        def tap(*a, _fn=fn, **kw):
            grad_seen.append((threading.current_thread().name, torch.is_grad_enabled()))
            return _fn(*a, **kw)
        monkeypatch.setattr(eng, name, tap)
    api = InferenceAPI(vp)
    calls = [("/add_box", {"frame_index": 0, "object_id": 1, "box": BOX1}),
             ("/add_points", {"frame_index": 0, "object_id": 2, "points": CLICKS2[0],
                              "labels": CLICKS2[1]}),
             ("/add_mask", {"frame_index": 3, "object_id": 3, "mask": _mask3()}),
             ("/clear_points_in_frame", {"frame_index": 0, "object_id": 2})]
    with serving(api) as port:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthy", timeout=10) as r:
            assert json.load(r) == {"status": "ok"}
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=10) as r:
            html = r.read().decode()
            assert "det_sam2_tpu_torch" in html and "/graphql" in html
        start = _post_json(port, "/start_session", {"video_path": frames_dir})
        sid = start.pop("session_id")
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/session_info?session_id={sid}", timeout=10) as r:
            assert json.load(r)["num_frames"] == N
        got = [_post_json(port, route, dict(body, session_id=sid)) for route, body in calls]
        got.append(_ndjson(port, {"session_id": sid, "start_frame_index": 0}))
        got.append(_ndjson(port, {"session_id": sid, "start_frame_index": N - 1,
                                  "reverse": True}))
        got.append(_post_json(port, "/remove_object", {"session_id": sid, "object_id": 2}))
        got.append(_post_json(port, "/reset_session", {"session_id": sid}))
        got.append(_post_json(port, "/close_session", {"session_id": sid}))
    http_threads = {t for t, _ in grad_seen}
    assert grad_seen and "MainThread" not in http_threads
    assert not any(g for _, g in grad_seen), "grad mode on in an engine call"

    in_proc = InferenceAPI(vp)
    want_start = in_proc.start_session(frames_dir)
    sid = want_start.pop("session_id")
    assert start == want_start
    want = [in_proc.add_box(sid, 0, 1, BOX1), in_proc.add_points(sid, 0, 2, *CLICKS2),
            in_proc.add_mask(sid, 3, 3, _mask3()), in_proc.clear_points_in_frame(sid, 0, 2),
            list(in_proc.propagate_in_video(sid, 0)),
            list(in_proc.propagate_in_video(sid, N - 1, reverse=True)),
            in_proc.remove_object(sid, 2), in_proc.reset_session(sid),
            in_proc.close_session(sid)]
    assert got == want
    assert [r["frame_index"] for r in got[4]] == list(range(N))


def test_http_cancel_mid_stream_then_session_usable(predictors, frames_dir):
    """A cancel from a second connection while a propagation streams stops
    the stream early; the session stays usable for a full propagation (the
    JAX package's tests/test_serving_tools.py case on the port)."""
    vp, _ = predictors

    class PausingPredictor:
        def __init__(self, inner):
            self._inner = inner
            self.first_yield = threading.Event()
            self.resume = threading.Event()
            self.paused_once = False

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def propagate_in_video(self, *a, **kw):
            for i, item in enumerate(self._inner.propagate_in_video(*a, **kw)):
                yield item
                if i == 0 and not self.paused_once:
                    self.paused_once = True
                    self.first_yield.set()
                    assert self.resume.wait(timeout=60)

    pausing = PausingPredictor(vp)
    with serving(InferenceAPI(pausing)) as port:
        sid = _post_json(port, "/start_session", {"video_path": frames_dir})["session_id"]
        _post_json(port, "/add_box", {"session_id": sid, "frame_index": 0,
                                      "object_id": 1, "box": BOX1})
        lines = []

        def consume():
            with _post(port, "/propagate_in_video",
                       {"session_id": sid, "start_frame_index": 0}) as r:
                for line in r:
                    lines.append(json.loads(line))

        t = threading.Thread(target=consume)
        t.start()
        assert pausing.first_yield.wait(timeout=120)
        assert _post_json(port, "/cancel_propagate_in_video", {"session_id": sid}) == {
            "success": True}
        pausing.resume.set()
        t.join(timeout=120)
        assert not t.is_alive()
        assert [line["frame_index"] for line in lines] == [0]
        _post_json(port, "/add_box", {"session_id": sid, "frame_index": 0,
                                      "object_id": 1, "box": BOX1})
        full = _ndjson(port, {"session_id": sid, "start_frame_index": 0})
        assert [line["frame_index"] for line in full] == list(range(N))
        assert _post_json(port, "/close_session", {"session_id": sid})["success"]


@pytest.fixture(scope="module")
def stub_server(tmp_path_factory):
    """The port's server over a stub InferenceAPI (no model) and a gallery
    file (tests/test_serving_review_fixes.py's fixture)."""
    gallery = tmp_path_factory.mktemp("gallery")
    blob = bytes(range(256)) * 40  # 10240 bytes
    with open(gallery / "clip.mkv", "wb") as f:
        f.write(blob)
    outside = tmp_path_factory.mktemp("outside") / "secret.mp4"
    outside.write_bytes(b"x" * 10)

    class StubAPI:
        def propagate_in_video(self, session_id, start, max_num, reverse):
            if session_id != "good":
                raise KeyError(f"unknown session {session_id!r}")
            yield {"frame_index": 0}
            yield {"frame_index": 1}
            raise RuntimeError("mid-stream boom")

        def frame_jpeg(self, session_id, index):
            import cv2  # noqa: F401  (the real method needs it)
            raise KeyError(f"unknown session {session_id}")

    class StubGQL:
        gallery_dir = str(gallery)
        uploads_dir = None

    with serving(StubAPI(), StubGQL()) as port:
        yield port, blob, str(gallery / "clip.mkv"), str(outside)


def test_unknown_session_is_a_clean_500(stub_server):
    port = stub_server[0]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, "/propagate_in_video", {"session_id": "nope"})
    assert ei.value.code == 500
    assert "unknown session" in json.load(ei.value)["error"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/frame?session_id=x&index=0",
                               timeout=10)
    assert ei.value.code == 500 and "unknown session" in json.load(ei.value)["error"]
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(port, "/no_such_route", {})
    assert ei.value.code == 404
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthy", timeout=10) as r:
        assert json.load(r)["status"] == "ok"


def test_mid_stream_error_ends_the_stream(stub_server):
    port = stub_server[0]
    with _post(port, "/propagate_in_video", {"session_id": "good"}) as r:
        assert r.status == 200
        lines = [json.loads(line) for line in r.read().decode().splitlines()]
    assert [line.get("frame_index") for line in lines[:2]] == [0, 1]
    assert "mid-stream boom" in lines[2]["error"] and len(lines) == 3


def test_video_range_mime_and_path_guard(stub_server):
    port, blob, path, outside = stub_server
    url = f"http://127.0.0.1:{port}/video?path={quote(path)}"
    with urllib.request.urlopen(url, timeout=10) as r:
        assert r.headers["Content-Type"] != "video/mp4"  # .mkv guessed
        assert r.headers["Accept-Ranges"] == "bytes"
        assert r.read() == blob
    for rng, code, body, crange in (
            ("bytes=100-199", 206, blob[100:200], f"bytes 100-199/{len(blob)}"),
            ("bytes=-100", 206, blob[-100:], f"bytes {len(blob) - 100}-{len(blob) - 1}/"
             f"{len(blob)}"),
            ("bytes=10000-", 206, blob[10000:], f"bytes 10000-{len(blob) - 1}/{len(blob)}"),
            ("bytes=0-99999", 206, blob, f"bytes 0-{len(blob) - 1}/{len(blob)}")):
        req = urllib.request.Request(url, headers={"Range": rng})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert (r.status, r.read(), r.headers["Content-Range"]) == (code, body, crange)
    req = urllib.request.Request(url, headers={"Range": f"bytes={len(blob) + 5}-"})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 416
    for bad in (outside, os.path.join(os.path.dirname(path), "..",
                                      os.path.basename(os.path.dirname(outside)),
                                      "secret.mp4")):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/video?path={quote(bad)}",
                                   timeout=10)
        assert ei.value.code == 403


# ---------------------------------------------------------------------------
# GraphQL
# ---------------------------------------------------------------------------

DOCUMENTS = [
    'mutation Go($i: AddPointsInput!) { addPoints(input: $i) '
    '{ frameIndex rleMaskList { objectId rleMask { size counts } } } }',
    'query { videos(first: 3, flag: true, off: false, none: null, who: "a\\"b", '
    'pt: {x: 1.5, y: [1, -2]}, e: ENUM) { edges } }',
    'mutation { startSession(input: {path: "/gallery/vidéo — 视频.mp4"}) { sessionId } }',
    r'query { q(s: "line1\nline2\ttab \"quoted\" ué é") { x } }',
    'query { a: videos { totalCount } b: defaultVideo { path } } # comment',
    '{ videos { edges { node { path width } } } }',
]


def _plain(doc):
    """A parsed document with its variables as ('$', name)."""
    if isinstance(doc, dict):
        return {k: _plain(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_plain(v) for v in doc]
    if hasattr(doc, "name") and type(doc).__name__ == "_Var":
        return ("$", doc.name)
    return doc


@pytest.mark.parametrize("doc", DOCUMENTS)
def test_graphql_parser_matches_jax(doc):
    got = graphql._Parser(graphql._tokenize(doc)).parse_document()
    want = jax_graphql._Parser(jax_graphql._tokenize(doc)).parse_document()
    assert _plain(got) == _plain(want)


def test_graphql_parser_values_and_errors():
    f = graphql._Parser(graphql._tokenize(DOCUMENTS[1])).parse_document()["fields"][0]
    assert f["args"]["who"] == 'a"b' and f["args"]["pt"] == {"x": 1.5, "y": [1, -2]}
    assert f["args"]["flag"] is True and f["args"]["none"] is None
    f = graphql._Parser(graphql._tokenize(DOCUMENTS[2])).parse_document()["fields"][0]
    assert f["args"]["input"]["path"] == "/gallery/vidéo — 视频.mp4"
    for bad in ("query { a(", "query { a(x: @) }", "{ a", "query { a(x: ) }"):
        with pytest.raises(ValueError):
            graphql._Parser(graphql._tokenize(bad)).parse_document()
        with pytest.raises(ValueError):
            jax_graphql._Parser(jax_graphql._tokenize(bad)).parse_document()
    data = {"a": 1, "b": {"c": 2, "d": 3}, "e": [{"f": 4, "g": 5}], "n": None}
    sels = graphql._Parser(graphql._tokenize("query { x { a b { c } e { g } n { z } "
                                             "m: a } }")).parse_document()
    sels = sels["fields"][0]["selections"]
    assert graphql._filter_selection(data, sels) == {"a": 1, "b": {"c": 2},
                                                     "e": [{"g": 5}], "n": None, "m": 1}
    assert graphql._filter_selection(data, sels) == jax_graphql._filter_selection(data, sels)
    with pytest.raises(ValueError, match="missing variable"):
        graphql._resolve_vars(graphql._Var("i"), {})


def _write_clip(path, n=4, h=72, w=96, fps=10.0):
    import cv2

    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for t in range(n):
        f = np.full((h, w, 3), 30, np.uint8)
        f[18 + 2 * t:40 + 2 * t, 10:40] = (30, 30, 200)
        wr.write(f)
    wr.release()


OPS = [
    ("videos", "query { videos { totalCount edges { node { path width height fps "
     "numFrames durationSec url } } } }", None),
    ("defaultVideo", "query { defaultVideo { path numFrames } }", None),
    ("unknown field", "query { nope }", None),
    ("mutation as query", "query { closeSession(input: {sessionId: \"x\"}) { success } }",
     None),
    ("missing variable", "mutation($i: X!) { closeSession(input: $i) { success } }", {}),
    ("close unknown", "mutation { closeSession(input: {sessionId: \"x\"}) { success } }",
     None),
]
SESSION_OPS = [
    ("addPoints", "mutation($i: AddPointsInput!) { addPoints(input: $i) { frameIndex "
     "rleMaskList { objectId rleMask { size counts } } } }",
     {"frameIndex": 0, "objectId": 1, "points": [[24.0, 30.0]], "labels": [1],
      "clearOldPoints": True}),
    ("addPoints more", "mutation($i: AddPointsInput!) { addPoints(input: $i) { "
     "frameIndex rleMaskList { objectId rleMask { size counts } } } }",
     {"frameIndex": 0, "objectId": 1, "points": [[60.0, 50.0]], "labels": [0],
      "clearOldPoints": False}),
    ("clearPointsInFrame", "mutation($i: ClearPointsInFrameInput!) { "
     "clearPointsInFrame(input: $i) { success } }", {"frameIndex": 0, "objectId": 1}),
    ("cancelPropagateInVideo", "mutation($i: CancelPropagateInVideoInput!) { "
     "cancelPropagateInVideo(input: $i) { success } }", {}),
    ("clearPointsInVideo", "mutation($i: ClearPointsInVideoInput!) { "
     "clearPointsInVideo(input: $i) { success } }", {}),
    ("removeObject", "mutation($i: RemoveObjectInput!) { removeObject(input: $i) }",
     {"objectId": 1}),
    ("closeSession", "mutation($i: CloseSessionInput!) { closeSession(input: $i) "
     "{ success } }", {}),
]


def drive_graphql(gql) -> dict:
    """Every resolver of GraphQLAPI in one script; uploaded paths and session
    ids left out of the record."""
    rec = {}
    upload_name = re.compile(re.escape(gql.uploads_dir) + r"/raw_[0-9a-f]{32}_")
    for name, q, v in OPS:
        rec[name] = gql.execute(q, v)
    content = base64.b64encode(open(os.path.join(gql.gallery_dir, "clip.mp4"), "rb")
                               .read()).decode()
    up = gql.execute("mutation($f: VideoFile!) { uploadVideo(file: $f) "
                     "{ path numFrames width height fps } }",
                     {"f": {"contentBase64": content, "filename": "my.mp4"}})
    path = up["data"]["uploadVideo"].pop("path")
    assert path.startswith(gql.uploads_dir) and os.path.exists(path)
    rec["uploadVideo"] = up
    rec["videos after upload"] = gql.execute("query { videos { totalCount } }")
    d = gql.execute("mutation($i: StartSessionInput!) { startSession(input: $i) "
                    "{ sessionId } }", {"i": {"path": path}})
    sid = d["data"]["startSession"].pop("sessionId")
    rec["startSession"] = d
    for name, q, v in SESSION_OPS:
        rec[name] = gql.execute(q, {"i": dict(v, sessionId=sid)})
    d = gql.execute(
        "mutation($f: VideoFile!) { uploadVideo(file: $f) { path } }",
        {"f": {"contentBase64": base64.b64encode(b"not a video").decode(),
               "filename": "bad.mp4"}})
    for e in d.get("errors", []):
        e["message"] = upload_name.sub("<upload>/", e["message"])
    rec["no decoder"] = d
    return rec


@pytest.fixture(scope="module")
def graphql_runs(predictors, tmp_path_factory):
    vp, jvp = predictors
    gallery = tmp_path_factory.mktemp("gql_gallery")
    _write_clip(gallery / "clip.mp4")
    _write_clip(gallery / "b_other.avi", n=3)
    out = []
    for api, mod in ((InferenceAPI(vp), graphql), (JaxAPI(jvp), jax_graphql)):
        gql = mod.GraphQLAPI(api, gallery_dir=str(gallery),
                             uploads_dir=str(tmp_path_factory.mktemp("uploads")))
        gql.default_video_path = "gallery/clip.mp4"
        out.append(drive_graphql(gql))
    return out


@pytest.mark.parametrize("op", [name for name, _, _ in OPS] + [
    "uploadVideo", "videos after upload", "startSession"] + [
    name for name, _, _ in SESSION_OPS] + ["no decoder"])
def test_graphql_resolvers_match_jax(graphql_runs, op):
    got, want = graphql_runs
    assert_response_close(got[op], want[op], op)


def test_graphql_resolvers_went_where_they_should(graphql_runs):
    got, _ = graphql_runs
    assert got["videos"]["data"]["videos"]["totalCount"] == 2
    assert got["defaultVideo"]["data"]["defaultVideo"]["path"].endswith("clip.mp4")
    for name in ("unknown field", "mutation as query", "missing variable", "no decoder"):
        assert "errors" in got[name] and "data" not in got[name], name
    assert got["close unknown"] == {"data": {"closeSession": {"success": False}}}
    assert got["videos after upload"]["data"]["videos"]["totalCount"] == 3
    res = got["addPoints"]["data"]["addPoints"]
    assert res["frameIndex"] == 0 and res["rleMaskList"][0]["rleMask"]["size"] == [72, 96]
    assert got["removeObject"] == {"data": {"removeObject": []}}
    assert got["closeSession"] == {"data": {"closeSession": {"success": True}}}


def test_graphql_over_http(predictors, tmp_path):
    vp, _ = predictors
    _write_clip(tmp_path / "clip.mp4")
    gql = graphql.GraphQLAPI(InferenceAPI(vp), gallery_dir=str(tmp_path),
                             uploads_dir=str(tmp_path / "up"))
    with serving(gql.api, gql) as port:
        d = _post_json(port, "/graphql", {"query": "query { defaultVideo { path url } }"})
        video = d["data"]["defaultVideo"]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{video['url']}",
                                    timeout=10) as r:
            assert r.read() == open(video["path"], "rb").read()
        d = _post_json(port, "/graphql", {"query": "query { nope }"})
        assert "errors" in d


# ---------------------------------------------------------------------------
# env_config, transcode
# ---------------------------------------------------------------------------

ENVS = [
    {},
    {"MODEL_SIZE": "small"},
    {"MODEL_SIZE": "base_plus", "CHECKPOINT_PATH": "/ckpt/x.pt", "SERVER_PORT": "9000"},
    {"MODEL_SIZE": "hiera_l", "GUNICORN_PORT": "8000", "DATA_PATH": "/data"},
    {"DATA_PATH": "/d", "GALLERY_PATH": "/g", "CHECKPOINT_PATH": ""},
    {"MODEL_SIZE": "tiny", "UPLOADS_PATH": "/u", "SERVER_PORT": "", "GUNICORN_PORT": "7"},
]


@pytest.mark.parametrize("env", range(len(ENVS)))
def test_env_config_matches_jax(env):
    assert server.env_config(ENVS[env]) == jax_server.env_config(ENVS[env])


def test_env_config_bad_model_size():
    with pytest.raises(ValueError) as got:
        server.env_config({"MODEL_SIZE": "huge"})
    with pytest.raises(ValueError) as want:
        jax_server.env_config({"MODEL_SIZE": "huge"})
    assert str(got.value) == str(want.value) and "huge" in str(got.value)


def _seeded_clip(path, n, fps, w=64, h=48):
    import cv2

    rng = np.random.default_rng(n)
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    for i in range(n):
        f = np.full((h, w, 3), (i * 7) % 256, np.uint8)
        f[rng.integers(0, h - 8):, rng.integers(0, w - 8):][:8, :8] = 255
        wr.write(f)
    wr.release()


def _decoded(path):
    import cv2

    cap, frames = cv2.VideoCapture(str(path)), []
    while True:
        ok, f = cap.read()
        if not ok:
            return np.stack(frames)
        frames.append(f)


TRANSCODES = {  # name -> (source frames, source fps, transcode arguments)
    "upsample 12 -> 24 fps, 1 s cap": (24, 12.0, dict(max_seconds=1.0, fps=24.0)),
    "downsample 48 -> 24 fps": (48, 48.0, dict(max_seconds=10.0, fps=24.0)),
    "long side 32": (10, 10.0, dict(max_dim=32, fps=None)),
    "per-axis caps": (10, 10.0, dict(max_w=40, max_h=40, fps=5.0)),
}


@pytest.mark.parametrize("case", list(TRANSCODES))
def test_transcode_matches_jax(case, tmp_path):
    n, fps, kw = TRANSCODES[case]
    src = tmp_path / "src.mp4"
    _seeded_clip(src, n, fps)
    assert transcode.get_video_metadata(str(src)) == jax_transcode.get_video_metadata(
        str(src))
    got = transcode.transcode(str(src), str(tmp_path / "port.mp4"), **kw)
    want = jax_transcode.transcode(str(src), str(tmp_path / "jax.mp4"), **kw)
    assert got == want
    np.testing.assert_array_equal(_decoded(tmp_path / "port.mp4"),
                                  _decoded(tmp_path / "jax.mp4"))
    if case.startswith("upsample"):
        assert got["num_frames"] == 24 and abs(got["duration_sec"] - 1.0) < 1e-6
    if case.startswith("downsample"):
        assert got["num_frames"] == 24


def test_transcode_and_metadata_errors(tmp_path):
    with pytest.raises(RuntimeError, match="cannot open"):
        transcode.get_video_metadata(str(tmp_path / "missing.mp4"))
