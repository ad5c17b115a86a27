"""The port's image predictor (SAM2Engine.predict_step, SAM2ImagePredictor,
build_sam2) vs the JAX package's, on the same calls.

Same weights as test_torch_video_predictor.py (tiny_test_config, seeded,
object-score bias +1), both on the CPU in fp32 with TF32 off. The images are
96x112, away from model size: JAX's image predictor resizes with cv2, and
it is handed the port's prepare_frame (cv2's arithmetic in numpy, equal to
it bit for bit); JAX's host mask resize is its cv2.resize, whose bits the
port computes too (tests/test_torch_mask_resize.py holds them equal on the
same logits). Tolerances: logits and IoU predictions within ATOL (the
port's tests' fp32 parity tolerance), binary masks with IoU >= MIN_IOU where
the union is non-empty.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import det_sam2_tpu.image_predictor as jax_ip
from det_sam2_tpu.ops.connected_components import (
    fill_holes_and_sprinkles_np as jax_fill,
)

from det_sam2_tpu_torch import build
from det_sam2_tpu_torch.image_predictor import SAM2ImagePredictor
from det_sam2_tpu_torch.ops.connected_components import fill_holes_and_sprinkles_np
from det_sam2_tpu_torch.utils import misc
from test_torch_video_predictor import (
    ATOL,
    MIN_IOU,
    make_engines,
    make_frames,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
)

H, W = 96, 112


@pytest.fixture(scope="module")
def engines():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ip, "prepare_frame", misc.prepare_frame)
        yield make_engines()


@pytest.fixture(scope="module")
def predictors(engines):
    jeng, eng = engines
    return SAM2ImagePredictor(eng), jax_ip.SAM2ImagePredictor(jeng)


def image(seed):
    return make_frames(1, H, W, seed=seed)[0]


def assert_binary_close(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype == bool, what
    for g, w in zip(got.reshape(-1, *got.shape[-2:]), want.reshape(-1, *want.shape[-2:])):
        union = np.logical_or(g, w).sum()
        if union:
            assert np.logical_and(g, w).sum() / union >= MIN_IOU, what


def assert_outputs_close(got, want, what, logits: bool = False):
    (gm, gi, gl), (wm, wi, wl) = got, want
    if logits:
        assert gm.dtype == wm.dtype == np.float32, what
        np.testing.assert_allclose(gm, wm, atol=ATOL, err_msg=what)
    else:
        assert_binary_close(gm, wm, what)
    np.testing.assert_allclose(gi, wi, atol=ATOL, err_msg=f"{what}: ious")
    np.testing.assert_allclose(gl, wl, atol=ATOL, err_msg=f"{what}: low-res")


@pytest.fixture(scope="module")
def features(engines):
    jeng, eng = engines
    frame = misc.prepare_frame(image(0), 128)[None]
    return jeng.encode_image(jnp.asarray(frame)), eng.encode_image(frame)


@pytest.mark.parametrize("multimask", [True, False])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("n_pts", [1, 3])
def test_predict_step_matches_jax(engines, features, n_pts, with_mask, multimask):
    jeng, eng = engines
    jf, tf = features
    rng = np.random.default_rng(n_pts + 10 * with_mask)
    points = rng.uniform(0, 128, (2, n_pts, 2)).astype(np.float32)
    labels = rng.integers(0, 2, (2, n_pts)).astype(np.int32)
    mask = rng.standard_normal((2, 1, 32, 32)).astype(np.float32) * 4 if with_mask else None
    got = eng.predict_step(tf, points, labels, mask_input=mask, multimask=multimask)
    want = jeng.predict_step(jf, points, labels, mask_input=mask, multimask=multimask)
    m = 3 if multimask else 1
    assert tuple(got["multimasks"].shape) == (2, m, 32, 32)
    assert tuple(got["low_res_masks"].shape) == (2, 1, 32, 32)
    for k in ("multimasks", "ious", "low_res_masks", "object_score_logits"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL,
                                   err_msg=k)


PREDICTS = {
    "box": dict(box=np.asarray([10.0, 8.0, 70.0, 60.0])),
    "clicks": dict(point_coords=np.asarray([[40.0, 50.0], [80.0, 20.0], [60.0, 70.0]]),
                   point_labels=np.asarray([1, 0, 1])),
    "box+click, single mask": dict(box=np.asarray([10.0, 8.0, 70.0, 60.0]),
                                   point_coords=np.asarray([[30.0, 30.0]]),
                                   point_labels=np.asarray([1]), multimask_output=False),
    "two boxes": dict(box=np.asarray([[10.0, 8.0, 70.0, 60.0], [50, 40, 110, 95]])),
    "normalized coords, logits": dict(point_coords=np.asarray([[0.3, 0.6]]),
                                      point_labels=np.asarray([1]),
                                      normalize_coords=False, return_logits=True),
}


@pytest.mark.parametrize("name", list(PREDICTS))
def test_set_image_and_predict_match_jax(predictors, name):
    port, jax_pred = predictors
    kw = PREDICTS[name]
    outs = []
    for p in (port, jax_pred):
        p.set_image(image(1))
        outs.append(p.predict(**kw))
    assert_outputs_close(outs[0], outs[1], name, logits=kw.get("return_logits", False))
    masks = outs[0][0]
    lead = (2,) if name == "two boxes" else ()
    m = 1 if not kw.get("multimask_output", True) else 3
    assert masks.shape == lead + (m, H, W)


def test_predict_with_a_mask_input_matches_jax(predictors):
    port, jax_pred = predictors
    mask = np.random.default_rng(7).standard_normal((1, 32, 32)).astype(np.float32) * 4
    outs = []
    for p in (port, jax_pred):
        p.set_image(image(1))
        outs.append(p.predict(point_coords=np.asarray([[40.0, 50.0]]),
                              point_labels=np.asarray([1]), mask_input=mask,
                              multimask_output=False))
    assert_outputs_close(outs[0], outs[1], "mask input")
    assert outs[0][0].shape == (1, H, W)


def test_set_image_batch_and_predict_batch_match_jax(predictors):
    """Three images in one batched encode; per-image prompts (a click, a
    box, both) decode against each; then the same-image batch mode on a
    pinned image."""
    port, jax_pred = predictors
    images = [image(2), make_frames(1, 80, 128, seed=3)[0], image(4)]
    coords = [np.asarray([[40.0, 50.0]]), None, np.asarray([[20.0, 30.0]])]
    labels = [np.asarray([1]), None, np.asarray([1])]
    boxes = [None, np.asarray([5.0, 5.0, 90.0, 70.0]), np.asarray([10.0, 8.0, 70.0, 60.0])]
    outs = []
    for p in (port, jax_pred):
        p.set_image_batch(images)
        per_image = p.predict_batch(coords, labels, box_batch=boxes)
        p.select_batch_image(1)
        same = p.predict_batch(np.asarray([[[40.0, 50.0]], [[10.0, 60.0]]]),
                               np.ones((2, 1), np.int32), return_logits=True)
        outs.append((per_image, same))
    (got, got_same), (want, want_same) = outs
    for i in range(3):
        assert_outputs_close([x[i] for x in got], [x[i] for x in want], f"image {i}")
        assert got[0][i].shape[-2:] == images[i].shape[:2]
    assert_outputs_close(got_same, want_same, "same-image batch", logits=True)
    assert got_same[0].shape == (2, 3, 80, 128)


def test_fill_holes_and_sprinkles_np_matches_jax():
    """The host cleanup against JAX's host function (its C++ union-find):
    holes and sprinkles of every size around the thresholds, components
    touching the border, several planes."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 2, 40, 48)).astype(np.float32) * 3
    logits[0, 0, :6, :6] = -2.0  # a border-touching hole
    for args in ((0.0, 4.0, 0.0), (0.0, 0.0, 6.0), (0.5, 10.0, 3.0), (0.0, 1.0, 1.0)):
        got = fill_holes_and_sprinkles_np(logits, *args)
        want = jax_fill(logits, *args)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=str(args))
        assert (got != logits).any()


def test_predictor_hole_and_sprinkle_areas_match_jax(predictors):
    port, jax_pred = predictors
    outs = []
    for p in (port, jax_pred):
        p.max_hole_area, p.max_sprinkle_area = 6.0, 4.0
        try:
            p.set_image(image(5))
            outs.append(p.predict(point_coords=np.asarray([[40.0, 50.0]]),
                                  point_labels=np.asarray([1]), return_logits=True))
        finally:
            p.max_hole_area = p.max_sprinkle_area = 0.0
    assert_outputs_close(outs[0], outs[1], "hole / sprinkle cleanup", logits=True)


def test_build_sam2_from_a_pt(engines, tmp_path):
    """build_sam2 on the CPU from a SAM 2.1 .pt state dict gives the
    fixture engine's predictions; without a card the default device
    raises."""
    _, eng = engines
    ckpt = tmp_path / "sam2.1_tiny.pt"
    torch.save({"model": eng.model.state_dict()}, ckpt)
    pred = build.build_sam2(eng.cfg, str(ckpt), dtype=torch.float32, device="cpu")
    assert isinstance(pred, SAM2ImagePredictor) and pred.engine.device.type == "cpu"
    ref = SAM2ImagePredictor(eng)
    kw = dict(box=np.asarray([10.0, 8.0, 70.0, 60.0]), return_logits=True)
    outs = []
    for p in (pred, ref):
        p.set_image(image(6))
        outs.append(p.predict(**kw))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build.build_sam2(eng.cfg, str(ckpt), dtype=torch.float32)
