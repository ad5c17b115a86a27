"""The port's Det-SAM2 application (VideoProcessor, DetSAM2Pipeline,
session_size_report) vs the JAX package's, with the tiny model.

Weights and settings of test_torch_video_predictor.py (tiny_test_config(
fill_hole_area=8, max_objects=4), seeded, object-score bias +1, fp32, TF32
off, gather mode), both packages' frame loaders on the port's prepare_frame
(the frames are 96x128, away from model size). The stream is that of
tests/test_app.py with a second square: a synthetic detector reports both
squares (classes 5 and 7) and six pockets (class 11, collected, not
tracked) on every detect frame. Processor settings as in tests/test_app.py:
buffer 4, detect every 4, reverse propagation over 8, keep 8; a few window
lengths, so JAX compiles each window once for the module.

Gates: the same frames and objects in video_segments, each mask bool
[1, 96, 128] with a pixel agreement >= PIXEL_AGREE against JAX's (the
masks are thresholded logits that agree within 2e-3; a pixel whose logit
sits within that of 0 may flip); pockets, preload offsets, session
bookkeeping, pipeline events and skipped frames equal.
"""

import pickle
import sys

import numpy as np
import pytest

from det_sam2_tpu.app.detector import CallableDetector as JaxCallableDetector
from det_sam2_tpu.app.detector import NullDetector as JaxNullDetector
from det_sam2_tpu.app.pipeline import DetSAM2Pipeline as JaxPipeline
from det_sam2_tpu.app.postprocess import VideoPostProcessor as JaxPost
from det_sam2_tpu.app.video_processor import VideoProcessor as JaxProcessor
from det_sam2_tpu.utils.profiling import session_size_report as jax_size_report
from det_sam2_tpu.video_predictor import SAM2VideoPredictor as JaxPredictor

from det_sam2_tpu_torch.app.detector import CallableDetector, NullDetector
from det_sam2_tpu_torch.app.pipeline import DetSAM2Pipeline
from det_sam2_tpu_torch.app.postprocess import VideoPostProcessor
from det_sam2_tpu_torch.app.video_processor import VideoProcessor
from det_sam2_tpu_torch.utils.profiling import pytree_nbytes, session_size_report
from det_sam2_tpu_torch.video_predictor import SAM2VideoPredictor
from test_torch_video_predictor import (
    make_engines,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    shared_loader,  # noqa: F401 (a fixture)
)

H, W = 96, 128
N_FRAMES = 20
PIXEL_AGREE = 0.999
POCKETS = [(10, 10), (W // 2, 5), (W - 10, 10), (10, H - 10), (W // 2, H - 10),
           (W - 10, H - 10)]
ANCHORS = dict(zip(("left_up", "middle_up", "right_up", "left_down", "middle_down",
                    "right_down"), POCKETS))
SETTINGS = dict(skip_classes={11}, frame_buffer_size=4, detect_interval=4,
                max_frame_num_to_track=8, max_inference_state_frames=8)


def _boxes(t, speed=3):
    x = 8 + speed * t
    return [(x, 20, x + 24, 50), (100 - 2 * t, 55, 124 - 2 * t, 85)]


def frames(n, speed=3, start=0):
    out = []
    for t in range(start, start + n):
        f = np.full((H, W, 3), 30, np.uint8)
        (a, b, c, d), (e, g, i, j) = _boxes(t, speed)
        f[b:d, a:c] = (200, 30, 30)
        f[g:j, e:i] = (30, 200, 60)
        out.append(f)
    return out


def _detect(speed=3):
    def det(frame, idx):
        dets = [(*box, cls, 0.99) for box, cls in zip(_boxes(idx, speed), (5, 7))]
        dets += [(x - 5, y - 5, x + 5, y + 5, 11, 0.9) for x, y in POCKETS]
        return dets
    return det


@pytest.fixture(scope="module")
def predictors(shared_loader):  # noqa: F811
    jeng, eng = make_engines()
    return SAM2VideoPredictor(eng), JaxPredictor(jeng)


def _processors(predictors, detect=None, **kw):
    port, jax_pred = predictors
    settings = dict(SETTINGS, **kw)
    det = detect or _detect()
    return (VideoProcessor(port, CallableDetector(det), **settings),
            JaxProcessor(jax_pred, JaxCallableDetector(det), **settings))


def assert_segments_close(got, want):
    assert sorted(got) == sorted(want)
    for t in want:
        assert sorted(got[t]) == sorted(want[t]), t
        for obj, m in want[t].items():
            g = got[t][obj]
            assert g.dtype == bool and g.shape == (1, H, W), (t, obj)
            agree = float((g == np.asarray(m)).mean())
            assert agree >= PIXEL_AGREE, (t, obj, agree)


@pytest.fixture(scope="module")
def streamed(predictors):
    """Both processors over the N_FRAMES stream, with the size of each
    session after every flush."""
    out = []
    for proc in _processors(predictors):
        sizes = []
        orig = proc._detect_and_infer

        def flush(frame_idx, proc=proc, orig=orig):
            orig(frame_idx)
            sizes.append((len(proc.session.frames), len(proc.session.noncond_outputs)))

        proc._detect_and_infer = flush
        segments = proc.run(frames(N_FRAMES))
        out.append((proc, segments, sizes))
    return out


def test_video_segments_match_jax(streamed):
    (port, got, _), (_, want, _) = streamed
    assert sorted(got) == list(range(N_FRAMES))
    assert_segments_close(got, want)
    assert all(sorted(s) == [5, 7] for s in got.values())
    assert all(m.any() for s in got.values() for m in s.values())


def test_processor_state_matches_jax(streamed):
    (port, _, sizes), (jax_proc, _, jax_sizes) = streamed
    assert len(port.special_classes_detection) == 6
    for g, w in zip(port.special_classes_detection, jax_proc.special_classes_detection,
                    strict=True):
        np.testing.assert_array_equal(g, w)
    assert port.pre_frames == jax_proc.pre_frames == 0
    assert port.session.obj_ids == jax_proc.session.obj_ids == [5, 7]
    assert sorted(port.stats) == sorted(jax_proc.stats)
    assert port.stats["frames_propagated"] == jax_proc.stats["frames_propagated"] == \
        4 + 4 * 8  # flushes at 3, 7, 11, 15, 19
    # the session stays bounded: as JAX's, and by the processor's own rule
    assert sizes == jax_sizes
    bound = port.max_inference_state_frames + port.frame_buffer_size
    assert all(f <= bound and n <= port.max_inference_state_frames + 1 for f, n in sizes)
    assert sorted(port.session.frames_dev) == sorted(port.session.frames)


def test_session_size_report_matches_jax(streamed):
    (port, _, _), (jax_proc, _, _) = streamed
    got, want = session_size_report(port.session), jax_size_report(jax_proc.session)
    assert sorted(got) == sorted(want)
    for k in want:  # the banks of both packages hold the same arrays here
        assert got[k] == pytest.approx(want[k]), k
    bank = port.session.bank
    assert got["bank_device_mib"] * 2**20 == sum(
        t.numel() * t.element_size() for t in vars(bank).values() if hasattr(t, "numel"))
    assert got["frames_device_mib"] * 2**20 == pytree_nbytes(
        list(port.session.frames_dev.values())) > 0


def test_detection_free_stream_stays_bounded(predictors):
    procs = _processors(predictors, detect=lambda f, i: [])
    for proc in procs:
        proc.detector = NullDetector() if isinstance(proc, VideoProcessor) else \
            JaxNullDetector()
        proc.run(frames(24))
    port, jax_proc = procs
    assert port.session.num_objects == jax_proc.session.num_objects == 0
    assert sorted(port.session.frames) == sorted(jax_proc.session.frames)
    assert len(port.session.frames) <= port.max_inference_state_frames + port.frame_buffer_size
    assert port.video_segments == jax_proc.video_segments == {}


def test_save_and_preload_round_trip_matches_jax(predictors, tmp_path):
    """A processor that saves its session (keeping every frame), then a new
    processor preloaded with it on a new video: frames indexed after the
    preload, results without it, the preload's cond frames pinned; and
    save_results with the preload offset removed."""
    outs = []
    for i, name in enumerate(("port", "jax")):
        path = str(tmp_path / f"{name}.pkl")
        first = _processors(predictors, max_inference_state_frames=-1,
                            save_session_path=path)[i]
        first.run(frames(8))
        second = _processors(predictors, load_session_path=path)[i]
        segments = second.run(frames(8, speed=2, start=8))
        res = str(tmp_path / f"{name}_results.pkl")
        second.save_results(res)
        with open(res, "rb") as f:
            outs.append((second, segments, pickle.load(f)))
    (port, got, got_res), (jax_proc, want, want_res) = outs
    assert port.pre_frames == jax_proc.pre_frames == 8
    assert min(got) >= 8 and port.session.num_frames == 16
    assert bool(port.session.bank.cond_pinned.any())
    assert_segments_close(got, want)
    assert sorted(got_res["video_segments"]) == [t - 8 for t in sorted(got)]
    assert_segments_close(got_res["video_segments"], want_res["video_segments"])


def test_pipeline_events_match_jax(predictors):
    """DetSAM2Pipeline: inference on the calling thread, the billiards
    postprocessor on its own thread; events, positions and skipped frames
    as JAX's."""
    outs = []
    for i, (pipe_cls, post_cls) in enumerate(((DetSAM2Pipeline, VideoPostProcessor),
                                              (JaxPipeline, JaxPost))):
        proc = _processors(predictors)[i]
        pipe = pipe_cls(proc, post_cls(hole_anchors=ANCHORS, table_margin=10.0),
                        max_inference_state_frames=8)
        post = pipe.inference(frames(16))
        assert pipe.postprocess_started.is_set() and pipe.inference_done.is_set()
        assert not pipe._post_thread.is_alive()
        outs.append((pipe, post))
    (pipe, post), (jax_pipe, jax_post) = outs
    assert pipe.skipped_frames == jax_pipe.skipped_frames
    assert post.events() == jax_post.events()
    assert sorted(post.balls_positions) == list(range(16))
    for t, pos in jax_post.balls_positions.items():
        for b, p in pos.items():
            q = post.balls_positions[t][b]
            assert (p is None) == (q is None), (t, b)
            if p is not None:  # centroids of masks that agree >= 99.9 %
                assert abs(p[0] - q[0]) <= 1 and abs(p[1] - q[1]) <= 1, (t, b)
    assert pipe.video_processor.video_segments == {}  # all handed off


def test_pipeline_refuses_a_truncating_session(predictors, tmp_path):
    proc = _processors(predictors, max_inference_state_frames=-1,
                       save_session_path=str(tmp_path / "s.pkl"))[0]
    with pytest.raises(ValueError, match="max_inference_state_frames=-1"):
        DetSAM2Pipeline(proc)
    with pytest.raises(ValueError, match="output_video_dir"):
        DetSAM2Pipeline(_processors(predictors)[0], visualize_postprocess=True)


def test_object_cap_and_render_without_cv2(predictors, monkeypatch):
    """An object beyond max_objects (4) raises as in JAX; render_video needs
    cv2."""
    proc = _processors(predictors)[0]
    proc.session = proc.predictor.init_state(frames(4))
    dets = CallableDetector(lambda f, i: [
        (8 + 20 * k, 20, 24 + 20 * k, 50, 20 + k, 0.9) for k in range(5)])([None], [0])
    with pytest.raises(ValueError, match="max_objects"):
        proc.prompt_from_detections(dets)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        proc.render_video(frames(1), "unused.mp4")
