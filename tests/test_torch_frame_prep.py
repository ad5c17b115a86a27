"""The port's frame preparation against cv2 and the JAX package.

The JAX package resizes ndarray frames with ``cv2.resize`` (uint8
INTER_LINEAR) and stored frames back to video size with cv2's float resize;
the port computes both in numpy (``utils/cv2_resize.py``) with no cv2.
``prepare_frame`` must equal ``cv2.resize`` bit for bit at the frame sizes
the application meets (down, up, an exact 2x, tiny, identity) and for float
frames in [0, 1] and [0, 255]; the port's video predictor must store the JAX
predictor's frame bytes for the same ndarray video, without either loader
being patched; ``normalize_frame`` equals JAX's bit for bit, and
``tensor_to_frame_rgb`` too at the sizes a model frame goes back to (an
upscale below ~9x; beyond it cv2's IPP border code rounds two channels of the
edge columns without an FMA: <= 1 level, <= 0.1 % of the values).
"""

import numpy as np
import pytest
import torch

import det_sam2_tpu.utils.misc as jax_misc
from det_sam2_tpu.video_predictor import SAM2VideoPredictor as JaxPredictor

from det_sam2_tpu_torch.utils import cv2_resize, misc
from det_sam2_tpu_torch.video_predictor import SAM2VideoPredictor

from test_torch_video_predictor import ATOL, make_engines, make_frames

cv2 = pytest.importorskip("cv2")

# (frame height, width, model size, frame kind)
PREPARE_CASES = [
    (720, 1280, 1024, "uint8"),
    (1080, 1920, 1024, "uint8"),
    (2048, 2048, 1024, "uint8"),  # an exact 2x
    (480, 640, 1024, "uint8"),  # up
    (96, 112, 128, "uint8"),
    (3, 5, 128, "uint8"),
    (128, 128, 128, "uint8"),  # identity
    (720, 1280, 1024, "float01"),
    (720, 1280, 1024, "float255"),
]
# stored frame size -> video (W, H) of tensor_to_frame_rgb, bit for bit
TO_RGB_EXACT = [(128, 112, 96), (128, 300, 200), (128, 128, 128), (1024, 1280, 720),
                (1024, 1920, 1080)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


@pytest.mark.parametrize("h,w,size,kind", PREPARE_CASES,
                         ids=[f"{h}x{w}-{s}-{k}" for h, w, s, k in PREPARE_CASES])
def test_prepare_frame_equals_cv2_bit_for_bit(h, w, size, kind):
    frame = _frame(h, w, h * w)
    src = {"uint8": frame, "float01": frame / 255.0,
           "float255": frame.astype(np.float32)}[kind]
    src.setflags(write=False)  # a read-only frame is accepted
    got = misc.prepare_frame(src, size)
    assert got.shape == (size, size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, cv2.resize(frame, (size, size)))
    # the JAX package's own preparation, cv2 included
    np.testing.assert_array_equal(got, jax_misc.prepare_frame(src, size))
    if (h, w) == (size, size):
        assert got is not src and np.shares_memory(got, src) is False


@pytest.mark.parametrize("hw,size", [((300, 200), 128), ((1080, 1920), 256)])
def test_the_loaders_prepare_as_cv2(hw, size):
    """load_video_frames (a stack and a list) and AsyncFrameLoader over
    ndarray frames go through prepare_frame."""
    frames = np.stack([_frame(*hw, seed) for seed in range(3)])
    want = [cv2.resize(f, (size, size)) for f in frames]
    for src in (frames, list(frames)):
        got, h, w = misc.load_video_frames(src, size)
        assert (h, w) == hw
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x)
    loader = misc.AsyncFrameLoader(list(frames), size)
    for i, x in enumerate(want):
        np.testing.assert_array_equal(loader[i], x)


def test_video_predictor_stores_the_jax_predictors_frames():
    """The slice as a whole: init_state and update_state on a seeded ndarray
    video (96x112, not model size) store the JAX predictor's frame bytes, and
    the warm-up encode of frame 0 agrees."""
    jeng, eng = make_engines()
    video = make_frames(5, 96, 112, seed=21)
    jvp, vp = JaxPredictor(jeng), SAM2VideoPredictor(eng)
    js, s = jvp.init_state(list(video[:3])), vp.init_state(list(video[:3]))
    jvp.update_state(video[3:], js)
    vp.update_state(video[3:], s)
    assert (s.video_height, s.video_width) == (js.video_height, js.video_width) == (96, 112)
    assert sorted(s.frames) == sorted(js.frames) == list(range(5))
    for t in range(5):
        assert s.frames[t].dtype == js.frames[t].dtype == np.uint8
        np.testing.assert_array_equal(s.frames[t], js.frames[t], err_msg=f"frame {t}")
    for got, want in zip(s._feat_cache[1], js._feat_cache[1]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=ATOL)


def test_normalize_frame_equals_jax():
    for hw, size in (((96, 112), 128), ((720, 1280), 256)):
        frame = _frame(*hw, 3)
        got = misc.normalize_frame(frame, size)
        assert got.dtype == np.float32 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, jax_misc.normalize_frame(frame, size))


@pytest.mark.parametrize("size,w,h", TO_RGB_EXACT,
                         ids=[f"{s}-{w}x{h}" for s, w, h in TO_RGB_EXACT])
def test_tensor_to_frame_rgb_equals_jax(size, w, h):
    stored = _frame(size, size, size + w)
    normed = jax_misc.normalize_frame(stored, size)
    for x in (stored, normed, normed.astype(np.float16)):
        got = misc.tensor_to_frame_rgb(x, (w, h))
        assert got.shape == (h, w, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_misc.tensor_to_frame_rgb(x, (w, h)),
                                      err_msg=str(x.dtype))


def test_tensor_to_frame_rgb_past_ipps_border_rule():
    """A 20x upscale: five or more clamped columns a side, where IPP rounds
    two of the three channels without an FMA (``cv2_resize.ipp_border``):
    equal to JAX's cv2 path."""
    stored = _frame(64, 64, 9)
    for x in (stored, jax_misc.normalize_frame(stored, 64)):
        got = misc.tensor_to_frame_rgb(x, (1280, 720))
        np.testing.assert_array_equal(got, jax_misc.tensor_to_frame_rgb(x, (1280, 720)))


@pytest.mark.parametrize("hw,out", [((64, 64), (112, 96)), ((128, 128), (1280, 720)),
                                    ((100, 90), (50, 40)), ((33, 47), (47, 33))])
def test_float_resize_equals_cv2(hw, out):
    img = np.random.default_rng(hw[0]).random(hw + (3,), dtype=np.float32)
    got = cv2_resize.resize_linear_float(img, out)
    # exact, the border columns of a >= 9x upscale (IPP's rule) included
    np.testing.assert_array_equal(got, cv2.resize(img, out))
