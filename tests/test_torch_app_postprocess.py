"""The port's Det-SAM2 application without a model: the billiards
postprocessor, the evaluation harness, the detectors and the frame
iterator, against the JAX package's on the same inputs.

The segments are a seeded synthetic game at a quarter of the 1920x1080
table (270x480), with the hole anchors and the postprocessor's pixel
thresholds scaled by the same quarter: a ball potted into the left-up hole,
two balls colliding, and the white ball rebounding off the right cushion
(and passing over another ball, so its dilated mask is subtracted). The
postprocessor is exact host arithmetic on the same masks, so positions,
velocities and events must be equal, not close. The JAX postprocessor
dilates the white ball with cv2 (installed here); the port's 3x3 numpy
dilation must give the same masks.
"""

import json
import os
import pickle

import numpy as np
import pytest

from det_sam2_tpu.app import detector as jax_detector
from det_sam2_tpu.app import eval as jax_eval
from det_sam2_tpu.app import postprocess as jax_post
from det_sam2_tpu.app import rtsp as jax_rtsp
from det_sam2_tpu_torch.app import detector, eval as app_eval, postprocess, rtsp

H, W = 270, 480  # a quarter of 1080 x 1920
SCALE = 0.25
ANCHORS = {k: (x * SCALE, y * SCALE) for k, (x, y) in postprocess.DEFAULT_HOLE_ANCHORS.items()}
KW = dict(pot_distance_threshold=100 * SCALE, ball_distance_threshold=120 * SCALE,
          ball_velocity_threshold=10 * SCALE, table_margin=100 * SCALE,
          hole_anchors=ANCHORS)
RADIUS = 6
N_FRAMES = 40


def _pockets(jitter=0.0, seed=0):
    """Six pocket boxes (x0, y0, x1, y1) around the scaled anchors."""
    rng = np.random.default_rng(seed)
    out = []
    for x, y in ANCHORS.values():
        dx, dy = rng.uniform(-jitter, jitter, 2)
        out.append(np.asarray([x + dx - 8, y + dy - 8, x + dx + 8, y + dy + 8], np.float32))
    return out


def _tracks():
    """Ball centre per frame (None once potted): ball 1 rolls into the
    left-up hole, balls 2 and 3 meet head-on at frame 18 and part, the white
    ball (16) runs into the right cushion, turns at x = 445, and on the way
    back passes over ball 7, which rests."""
    tracks = {}
    tracks[1] = [(100 - 4 * t, 100 - 4 * t) if t <= 15 else None for t in range(N_FRAMES)]
    tc = 18
    tracks[2] = [(150 + 4 * min(t, tc) - 4 * max(t - tc, 0), 100) for t in range(N_FRAMES)]
    tracks[3] = [(306 - 4 * min(t, tc) + 4 * max(t - tc, 0), 100) for t in range(N_FRAMES)]
    tracks[16] = [(409 + 4 * t if t <= 9 else 445 - 4 * (t - 9), 120 + t) for t in range(N_FRAMES)]
    tracks[7] = [(401, 140) for _ in range(N_FRAMES)]
    return tracks


def _disc(c, seed):
    m = np.zeros((1, H, W), bool)
    if c is None:
        return m
    yy, xx = np.ogrid[:H, :W]
    m[0] = (xx - c[0]) ** 2 + (yy - c[1]) ** 2 <= RADIUS ** 2
    # a few seeded stray pixels at the disc edge: centroids off the grid
    rng = np.random.default_rng(seed)
    ys, xs = np.nonzero(m[0])
    pick = rng.integers(0, len(ys), 3)
    m[0, np.clip(ys[pick] + 1, 0, H - 1), np.clip(xs[pick] + 1, 0, W - 1)] = True
    return m


def make_segments():
    tracks = _tracks()
    return {t: {b: _disc(tr[t], 1000 * b + t) for b, tr in tracks.items()}
            for t in range(N_FRAMES)}


def _run(mod, segments, pockets):
    post = mod.VideoPostProcessor(**KW)
    post.get_hole_name(pockets)
    post.get_boundary_from_holes()
    post.run(segments)
    return post


@pytest.fixture(scope="module")
def game():
    segments = make_segments()
    pockets = _pockets(jitter=3.0)
    return segments, pockets, _run(postprocess, segments, pockets), _run(jax_post, segments, pockets)


def test_postprocessor_matches_jax(game):
    _, _, got, want = game
    assert got.hole_names_and_positions == want.hole_names_and_positions
    assert got.effective_boundary == want.effective_boundary
    assert got.balls_positions == want.balls_positions
    assert got.balls_velocities == want.balls_velocities
    assert got.disappeared_balls == want.disappeared_balls
    assert got.ball_collision == want.ball_collision
    assert got.ball_rebound == want.ball_rebound
    assert got.events() == want.events()


def test_the_game_has_each_event(game):
    """The synthetic game is worth comparing: each event fires where it was
    staged."""
    _, _, got, _ = game
    ev = got.events()
    assert [(p["ball"], p["hole"]) for p in ev["pot"]] == [(1, "left_up")]
    assert {tuple(sorted(c["balls"])) for c in ev["collision"]} == {(2, 3)}
    assert {(r["ball"], r["boundary"]) for r in ev["rebound"]} >= {(16, "right")}


def test_postprocessor_from_pickles_matches_jax(game, tmp_path):
    """Segments and pockets given as pickle paths (a saved VideoProcessor
    result), processed frame by frame as the pipeline does."""
    segments, pockets, _, _ = game
    seg_path, pocket_path = tmp_path / "segments.pkl", tmp_path / "pockets.pkl"
    with open(seg_path, "wb") as f:
        pickle.dump({"video_segments": segments, "special_classes_detection": pockets}, f)
    with open(pocket_path, "wb") as f:
        pickle.dump(pockets, f)
    posts = []
    for mod in (postprocess, jax_post):
        post = mod.VideoPostProcessor(**KW)
        post.get_hole_name(str(pocket_path))
        post.get_boundary_from_holes()
        for t, segs in sorted(post.load_video_segments(str(seg_path)).items()):
            post.process_single_frame(t, segs)
        posts.append(post)
    assert posts[0].events() == posts[1].events()
    assert posts[0].balls_velocities == posts[1].balls_velocities


@pytest.mark.parametrize("iterations", [1, 2])
def test_white_ball_dilation_matches_jax_cv2(iterations):
    """The port's 3x3 numpy dilation against JAX's cv2.dilate path: masks
    touching every border, several components, single pixels."""
    pytest.importorskip("cv2")
    assert jax_post.cv2 is not None  # JAX takes its cv2 path here
    rng = np.random.default_rng(iterations)
    white = rng.random((1, 1, 37, 53)) < 0.08
    white[..., 0, :5] = white[..., -1, -4:] = white[..., :, 0] = True
    white[..., 10, -1] = True
    others = [rng.random((1, 37, 53)) < p for p in (0.3, 0.6, 0.95)]
    got = postprocess.VideoPostProcessor().remove_white_ball_from_other_masks(
        white, others, iterations)
    want = jax_post.VideoPostProcessor().remove_white_ball_from_other_masks(
        white, others, iterations)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert any((w != o[0]).any() for w, o in zip(want, others))


def test_hole_names_and_boundary_match_jax():
    got, want = postprocess.VideoPostProcessor(), jax_post.VideoPostProcessor()
    boxes = [b / SCALE for b in _pockets(jitter=40.0, seed=3)]  # the 1920x1080 anchors
    for post in (got, want):
        post.get_hole_name(boxes)
        post.get_boundary_from_holes()
    assert got.hole_names_and_positions == want.hole_names_and_positions
    assert got.effective_boundary == want.effective_boundary
    assert sorted(n for n, _ in got.hole_names_and_positions) == sorted(ANCHORS)
    for mod in (postprocess, jax_post):
        with pytest.raises(ValueError, match="no hole positions"):
            mod.VideoPostProcessor().get_boundary_from_holes()
    assert postprocess.WHITE_BALL_ID == jax_post.WHITE_BALL_ID == 16
    assert postprocess.DEFAULT_HOLE_ANCHORS == jax_post.DEFAULT_HOLE_ANCHORS


def test_overlay_needs_cv2_without_it(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    post = postprocess.VideoPostProcessor()
    with pytest.raises(RuntimeError, match="cv2"):
        post.draw_frame_overlay(np.zeros((8, 8, 3), np.uint8), 0, 1)
    with pytest.raises(RuntimeError, match="cv2"):
        post.visualize([np.zeros((8, 8, 3), np.uint8)], "unused")


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------

SETS = [(set(), set()), ({1, 2}, {2, 3}), ({1}, set()), (set(), {4}), ({1, 2, 3}, {1, 2, 3})]


@pytest.mark.parametrize("true_set, pred_set", SETS)
def test_precision_recall_f1_matches_jax(true_set, pred_set):
    assert app_eval.precision_recall_f1(true_set, pred_set) == \
        jax_eval.precision_recall_f1(true_set, pred_set)


GT = {"video": "game.mp4", "pot": {"1": "left_up", "5": "right_down"},
      "collision": [[3, 2], [7, 16]], "rebound": {"16": ["right"], "2": ["top"]}}


def test_event_metrics_match_jax(game):
    _, _, got, want = game
    a, b = app_eval.evaluate_video(got, GT), jax_eval.evaluate_video(want, GT)
    assert a == b
    assert a["pot"]["precision"] == 1.0 and a["collision"]["recall"] == 0.5
    results = {"a": a, "b": app_eval.evaluate_video(got, {})}
    assert app_eval.average_metrics(results) == jax_eval.average_metrics(
        {"a": b, "b": jax_eval.evaluate_video(want, {})})
    assert app_eval.average_metrics({}) == jax_eval.average_metrics({})


GRID = {"frame_buffer_size": [30, 60], "detect_interval": [0, 30],
        "max_frame_num_to_track": [30, 60], "max_inference_state_frames": [-1, 30, 60],
        "load_inference_state_path": [None, "bank.pkl"]}


def test_valid_combo_matches_jax():
    import itertools

    keys = list(GRID)
    seen = []
    for values in itertools.product(*GRID.values()):
        params = dict(zip(keys, values))
        v = app_eval.EvalDetSAM2PostProcess.valid_combo(params)
        assert v == jax_eval.EvalDetSAM2PostProcess.valid_combo(params), params
        seen.append(v)
    assert any(seen) and not all(seen)


class _ReplayProcessor:
    """A VideoProcessor stand-in that replays the game's segments."""

    def __init__(self, segments, pockets):
        self.segments, self.pockets = segments, pockets
        self.video_segments, self.special_classes_detection, self.pre_frames = {}, [], 0

    def run(self, source):
        self.video_segments = dict(self.segments)
        self.special_classes_detection = list(self.pockets)
        return self.video_segments


def test_grid_search_matches_jax(game, tmp_path):
    """eval_all_settings over a small grid: every valid combination run
    and scored, results appended to eval_results.json, equal to JAX's."""
    segments, pockets, _, _ = game
    gt_path = tmp_path / "postprocess.jsonl"
    gt_path.write_text(json.dumps(GT) + "\n\n")
    grid = {"frame_buffer_size": [30], "detect_interval": [30],
            "max_frame_num_to_track": [30, 60], "max_inference_state_frames": [30, 60],
            "ball_distance_threshold": [120 * SCALE, 60 * SCALE]}
    out = []
    for mod, post_mod, name in ((app_eval, postprocess, "port"), (jax_eval, jax_post, "jax")):
        def factory(**params):
            kw = dict(KW, ball_distance_threshold=params["ball_distance_threshold"])
            return _ReplayProcessor(segments, pockets), post_mod.VideoPostProcessor(**kw)

        d = tmp_path / name
        res = mod.EvalDetSAM2PostProcess(factory).eval_all_settings(
            {"game.mp4": None}, str(gt_path), str(d), grid)
        with open(d / "eval_results.json") as f:
            assert json.load(f) == res
        out.append(res)
    assert out[0] == out[1]
    assert len(out[0]) == 6  # max_inference_state_frames 30 < track 60 is invalid


# ---------------------------------------------------------------------------
# detectors and the frame iterator
# ---------------------------------------------------------------------------


def _det_fn(frame, idx):
    return [(idx, 2.0, idx + 10.5, 12.0, 16, 0.99), (0, 0, 5, 5, 11.0, 0.5)]


def test_detectors_match_jax():
    frames = [np.zeros((4, 4, 3), np.uint8)] * 3
    got = detector.CallableDetector(_det_fn)(frames, [0, 30, 60])
    want = jax_detector.CallableDetector(_det_fn)(frames, [0, 30, 60])
    assert list(got) == list(want) == [0, 30, 60]
    for idx in got:
        for g, w in zip(got[idx], want[idx], strict=True):
            assert (g.cls, g.confidence) == (w.cls, w.confidence)
            assert g.box.dtype == np.float32
            np.testing.assert_array_equal(g.box, w.box)
    assert detector.NullDetector()(frames, [3, 4]) == jax_detector.NullDetector()(frames, [3, 4])
    with pytest.raises(ImportError, match="ultralytics"):
        detector.TorchYoloDetector("yolov8.pt")


def _gen(n):
    for i in range(n):
        yield np.full((2, 2, 3), i, np.uint8)


@pytest.mark.parametrize("max_frames", [None, 3, 0])
def test_iter_video_frames_matches_jax(max_frames):
    frames = list(_gen(5))
    for src_fn in (lambda: frames, lambda: _gen(5), lambda: np.stack(frames)):
        got = list(rtsp.iter_video_frames(src_fn(), max_frames))
        want = list(jax_rtsp.iter_video_frames(src_fn(), max_frames))
        assert len(got) == len(want) == (5 if max_frames is None else max_frames)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_stream_frames_without_cv2_raises(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        next(rtsp.iter_video_frames(os.path.join("no", "such.mp4")))
    with pytest.raises(ImportError):
        rtsp.probe_stream("rtsp://localhost:1/none")


# ---------------------------------------------------------------------------
# frames2video, result_visualize, profiling
# ---------------------------------------------------------------------------


def test_frames_to_video_and_streams_match_jax(tmp_path):
    """Both write the same mp4 from a PNG folder (decoded back with cv2,
    frame for frame equal), and read it back as the same stream."""
    cv2 = pytest.importorskip("cv2")
    from det_sam2_tpu.app.frames2video import frames_to_video as jax_frames_to_video
    from det_sam2_tpu_torch.app.frames2video import frames_to_video

    rng = np.random.default_rng(0)
    d = tmp_path / "frames"
    d.mkdir()
    for i in range(3):
        cv2.imwrite(str(d / f"{i:05d}.png"), rng.integers(0, 256, (48, 64, 3), np.uint8))
    videos = []
    for name, fn in (("port.mp4", frames_to_video), ("jax.mp4", jax_frames_to_video)):
        fn(str(d), str(tmp_path / name), fps=5)
        cap, frames = cv2.VideoCapture(str(tmp_path / name)), []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f)
        cap.release()
        videos.append(frames)
    assert len(videos[0]) == len(videos[1]) == 3
    for a, b in zip(*videos):
        np.testing.assert_array_equal(a, b)
    # the video as a stream (rtsp's cv2 path): frames and the probe
    path = str(tmp_path / "port.mp4")
    assert rtsp.probe_stream(path) == jax_rtsp.probe_stream(path)
    assert rtsp.probe_stream(str(tmp_path / "missing.mp4")) is None
    got = list(rtsp.iter_video_frames(path, max_frames=2))
    want = list(jax_rtsp.iter_video_frames(path, max_frames=2))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="no frames"):
        frames_to_video(str(tmp_path), str(tmp_path / "none.mp4"))


def test_result_heatmaps_match_jax(game, tmp_path):
    """The grid search's eval_results.json as a table and as pairwise
    heatmaps: the same table and the same files as JAX's."""
    pytest.importorskip("seaborn")
    from det_sam2_tpu.app import result_visualize as jax_viz
    from det_sam2_tpu_torch.app import result_visualize

    segments, pockets, _, _ = game
    gt_path = tmp_path / "postprocess.jsonl"
    gt_path.write_text(json.dumps(GT) + "\n")
    grid = {"frame_buffer_size": [30], "detect_interval": [30],
            "max_frame_num_to_track": [60, 90], "max_inference_state_frames": [-1],
            "ball_distance_threshold": [120 * SCALE, 60 * SCALE]}

    def factory(**params):
        kw = dict(KW, ball_distance_threshold=params["ball_distance_threshold"])
        return _ReplayProcessor(segments, pockets), postprocess.VideoPostProcessor(**kw)

    app_eval.EvalDetSAM2PostProcess(factory).eval_all_settings(
        {"game.mp4": None}, str(gt_path), str(tmp_path), grid)
    results = str(tmp_path / "eval_results.json")
    got, want = result_visualize.load_results(results), jax_viz.load_results(results)
    assert got.equals(want) and len(got) == 4
    saved = [result_visualize.plot_heatmaps(results, str(tmp_path / "port")),
             jax_viz.plot_heatmaps(results, str(tmp_path / "jax"))]
    assert [os.path.basename(p) for p in saved[0]] == \
        [os.path.basename(p) for p in saved[1]] == \
        ["heatmap_max_frame_num_to_track_vs_ball_distance_threshold.png"]
    assert all(os.path.getsize(p) > 0 for p in saved[0])


def test_profiling_helpers():
    """pytree_nbytes over nested tensors, arrays and dataclasses; the host
    report's keys as JAX's; device memory needs a card; a trace is
    written."""
    import dataclasses

    import torch

    from det_sam2_tpu.utils import profiling as jax_profiling
    from det_sam2_tpu_torch.utils import profiling

    @dataclasses.dataclass
    class Pair:
        a: torch.Tensor
        b: int

    tree = {"x": [torch.zeros(3, 4), np.zeros(5, np.uint8)],
            "y": (Pair(torch.zeros(2, dtype=torch.float16), 7), None)}
    assert profiling.pytree_nbytes(tree) == 48 + 5 + 4
    assert sorted(profiling.host_memory_stats()) == sorted(jax_profiling.host_memory_stats())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profiling.device_memory_stats()
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        with profiling.profile_trace(d):
            torch.ones(8).sum()
        assert os.path.getsize(os.path.join(d, "trace.json")) > 0


def test_defaults_match_jax():
    """The application's and the generators' constructor defaults are
    JAX's (VideoProcessor: skip classes {11, 14, 15, 19}, special 11,
    30 / 30 / 60 / 60; the AMG's 32 points a side, 64 a batch, ...)."""
    import inspect

    from det_sam2_tpu.app.pipeline import DetSAM2Pipeline as JaxPipeline
    from det_sam2_tpu.app.video_processor import VideoProcessor as JaxProcessor
    from det_sam2_tpu.automatic_mask_generator import SAM2AutomaticMaskGenerator as JaxAMG
    from det_sam2_tpu.image_predictor import SAM2ImagePredictor as JaxImagePredictor
    from det_sam2_tpu_torch.app.pipeline import DetSAM2Pipeline
    from det_sam2_tpu_torch.app.video_processor import VideoProcessor
    from det_sam2_tpu_torch.automatic_mask_generator import SAM2AutomaticMaskGenerator
    from det_sam2_tpu_torch.image_predictor import SAM2ImagePredictor

    def defaults(cls):
        return {k: p.default for k, p in inspect.signature(cls.__init__).parameters.items()
                if p.default is not inspect.Parameter.empty}

    for port_cls, jax_cls in ((VideoProcessor, JaxProcessor),
                              (postprocess.VideoPostProcessor, jax_post.VideoPostProcessor),
                              (DetSAM2Pipeline, JaxPipeline),
                              (SAM2AutomaticMaskGenerator, JaxAMG),
                              (SAM2ImagePredictor, JaxImagePredictor)):
        assert defaults(port_cls) == defaults(jax_cls), port_cls.__name__
    vp = defaults(VideoProcessor)
    assert vp["skip_classes"] == frozenset({11, 14, 15, 19}) and vp["special_classes"] == 11
    assert (vp["frame_buffer_size"], vp["detect_interval"], vp["max_frame_num_to_track"],
            vp["max_inference_state_frames"]) == (30, 30, 60, 60)
