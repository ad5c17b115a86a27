"""The port's automatic mask generator and its utils/amg copy vs the JAX
package's.

The utils are exact numpy on the same inputs: equal results. The port's
``remove_small_regions`` labels with scipy where JAX's labels with
cv2.connectedComponentsWithStats (installed here): the masks must be equal
in both modes, including the islands branch's tie between equal largest
islands, which cv2 breaks by its label order.

``generate`` runs both generators on the CPU with the weights of
test_torch_video_predictor.py (tiny_test_config), JAX's image predictor
handed the port's prepare_frame, both resizing masks with cv2's bits (see
test_torch_image_predictor.py). The thresholds are lowered so that masks
survive (random weights predict low IoU). Gates: the same number of
records and the same (crop box, point) prompts; within a prompt, in
descending predicted IoU, each mask with IoU >= MIN_IOU against JAX's,
predicted_iou within ATOL, stability score within STABILITY_TOL (one pixel
that crosses the +-1 offset moves it by one over the union), boxes within
BOX_TOL pixels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import det_sam2_tpu.image_predictor as jax_ip
import det_sam2_tpu.utils.misc as jax_misc
from det_sam2_tpu.automatic_mask_generator import SAM2AutomaticMaskGenerator as JaxAMG
from det_sam2_tpu.utils import amg as jax_amg

from det_sam2_tpu_torch import convert
from det_sam2_tpu_torch.automatic_mask_generator import SAM2AutomaticMaskGenerator
from det_sam2_tpu_torch.configs import tiny_test_config
from det_sam2_tpu_torch.image_predictor import SAM2ImagePredictor
from det_sam2_tpu_torch.track import SAM2Engine
from det_sam2_tpu_torch.utils import amg, misc
from test_torch_video_predictor import (
    ATOL,
    KW,
    MIN_IOU,
    make_engines,
    make_frames,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
)

STABILITY_TOL = 2e-3
BOX_TOL = 1.0


def _masks(seed, shape=(4, 23, 31), p=0.5):
    return np.random.default_rng(seed).random(shape) < p


def test_rle_round_trip_and_area_match_jax():
    masks = _masks(0)
    masks[1] = False
    masks[2, 0, 0] = True  # a mask starting in the foreground
    got, want = amg.mask_to_rle(masks), jax_amg.mask_to_rle(masks)
    assert got == want
    for rle, m in zip(got, masks):
        np.testing.assert_array_equal(amg.rle_to_mask(rle), m)
        np.testing.assert_array_equal(amg.rle_to_mask(rle), jax_amg.rle_to_mask(rle))
        assert amg.area_from_rle(rle) == jax_amg.area_from_rle(rle) == int(m.sum())


def test_scores_boxes_and_nms_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((5, 3, 20, 24)).astype(np.float32) * 3
    for thr, off in ((0.0, 1.0), (0.5, 0.25)):
        np.testing.assert_array_equal(amg.calculate_stability_score(logits, thr, off),
                                      jax_amg.calculate_stability_score(logits, thr, off))
    binary = logits > 2.0
    binary[0, 0] = False
    np.testing.assert_array_equal(amg.batched_mask_to_box(binary),
                                  jax_amg.batched_mask_to_box(binary))
    np.testing.assert_array_equal(misc.mask_to_box_np(binary),
                                  jax_misc.mask_to_box_np(binary))
    boxes = np.sort(rng.uniform(0, 50, (30, 2, 2)), axis=1).reshape(30, 4)[:, [0, 2, 1, 3]]
    boxes = boxes.astype(np.float32)
    scores = rng.random(30).astype(np.float32)
    np.testing.assert_array_equal(amg.box_iou(boxes, boxes[:7]), jax_amg.box_iou(boxes, boxes[:7]))
    for thr in (0.1, 0.5, 0.9):
        np.testing.assert_array_equal(amg.nms(boxes, scores, thr), jax_amg.nms(boxes, scores, thr))
    np.testing.assert_array_equal(amg.box_xyxy_to_xywh(boxes[0]),
                                  jax_amg.box_xyxy_to_xywh(boxes[0]))
    crop, orig = [10, 5, 40, 45], [0, 0, 60, 50]
    np.testing.assert_array_equal(amg.is_box_near_crop_edge(boxes, crop, orig),
                                  jax_amg.is_box_near_crop_edge(boxes, crop, orig))


@pytest.mark.parametrize("im_size, layers, overlap", [((96, 112), 1, 512 / 1500),
                                                      ((480, 640), 2, 0.34),
                                                      ((720, 1280), 1, 512 / 1500)])
def test_grids_crops_and_uncrop_match_jax(im_size, layers, overlap):
    assert amg.generate_crop_boxes(im_size, layers, overlap) == \
        jax_amg.generate_crop_boxes(im_size, layers, overlap)
    for got, want in zip(amg.build_all_layer_point_grids(16, layers, 2),
                         jax_amg.build_all_layer_point_grids(16, layers, 2), strict=True):
        np.testing.assert_array_equal(got, want)
    boxes, _ = amg.generate_crop_boxes(im_size, layers, overlap)
    h, w = im_size
    for crop in boxes[1:3]:
        x0, y0, x1, y1 = crop
        masks = _masks(2, (2, y1 - y0, x1 - x0))
        np.testing.assert_array_equal(amg.uncrop_masks(masks, crop, h, w),
                                      jax_amg.uncrop_masks(masks, crop, h, w))
        pts = np.asarray([[1.0, 2.0], [3.0, 4.0]], np.float32)
        np.testing.assert_array_equal(amg.uncrop_points(pts, crop),
                                      jax_amg.uncrop_points(pts, crop))


def test_mask_data_and_batch_iterator_match_jax():
    outs = []
    for mod in (amg, jax_amg):
        d = mod.MaskData(a=np.arange(5), b=list("abcde"))
        d.cat(mod.MaskData(a=np.arange(5, 8), b=list("fgh")))
        d.filter(np.asarray([True, False] * 4))
        d.filter(np.asarray([3, 0]))
        outs.append((d["a"].tolist(), d["b"],
                     [[x.tolist() for x in b] for b in mod.batch_iterator(3, np.arange(7))]))
    assert outs[0] == outs[1]


def _islands(shape, blobs):
    m = np.zeros(shape, bool)
    for y, x, hh, ww in blobs:
        m[y:y + hh, x:x + ww] = True
    return m


REGION_CASES = {
    "random": (_masks(3, (41, 57), 0.45), (2, 5, 20)),
    "dense": (_masks(4, (33, 29), 0.7), (3, 9, 40)),
    # three islands of 4 pixels, all small: the largest is kept, and cv2's
    # first-numbered of the tied ones wins (row pairs of 2x2 blocks first:
    # the island at (1, 20) before the one at (0, 30), which raster order
    # would pick, and before (6, 2))
    "tied islands": (_islands((12, 40), [(1, 20, 2, 2), (0, 30, 2, 2), (6, 2, 2, 2)]),
                     (5, 100)),
    "tied islands, odd rows": (_islands((13, 41), [(3, 10, 1, 4), (2, 30, 2, 2),
                                                   (9, 0, 4, 1), (12, 37, 1, 4)]), (5,)),
    "border": (_islands((20, 20), [(0, 0, 5, 20), (15, 0, 5, 3), (8, 8, 2, 2)]), (5, 16)),
    "empty": (np.zeros((10, 12), bool), (4,)),
    "full": (np.ones((10, 12), bool), (4, 200)),
}


@pytest.mark.parametrize("mode", ["holes", "islands"])
@pytest.mark.parametrize("case", list(REGION_CASES))
def test_remove_small_regions_matches_jax_cv2(case, mode):
    pytest.importorskip("cv2")
    mask, thresholds = REGION_CASES[case]
    for thr in thresholds:
        got, got_changed = amg.remove_small_regions(mask, thr, mode)
        want, want_changed = jax_amg.remove_small_regions(mask, thr, mode)
        assert got_changed == want_changed, (thr, mode)
        np.testing.assert_array_equal(np.asarray(got, bool), np.asarray(want, bool),
                                      err_msg=f"{case} {mode} {thr}")


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------


MASK_GAIN = 1000.0


@pytest.fixture(scope="module")
def predictors():
    """make_engines' weights with the mask logits scaled MASK_GAIN-fold (the
    hypernetworks' output layers): at the random init they stay within
    +-0.02, so every stability score would read 0 and every mask would hang
    on near-zero logits."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ip, "prepare_frame", misc.prepare_frame)
        jeng, _ = make_engines()
        params = jax.tree_util.tree_map(np.array, jeng.params)
        for i in range(4):
            for leaf in params["sam_mask_decoder"][f"hypernet_{i}"]["layers_2"].values():
                leaf *= MASK_GAIN
        jeng.params = jax.tree_util.tree_map(jnp.asarray, params)
        eng = SAM2Engine(tiny_test_config(**KW), params=convert.from_jax_params(params),
                         device="cpu")
        yield SAM2ImagePredictor(eng), jax_ip.SAM2ImagePredictor(jeng)


# NMS thresholds at 1 keep every mask: with random weights the masks are
# large and alike, so any lower threshold leaves one or two records, and
# between IoU predictions a few 1e-7 apart (as with 100 records of random
# weights) which one a greedy NMS keeps is a coin toss of rounding.
# utils' nms is held to JAX's above.
GENERATE = {
    "one crop": dict(points_per_side=4, points_per_batch=16, pred_iou_thresh=0.0,
                     stability_score_thresh=0.3, box_nms_thresh=1.0),
    "crops + small regions": dict(points_per_side=4, points_per_batch=16,
                                  pred_iou_thresh=0.0, stability_score_thresh=0.0,
                                  box_nms_thresh=1.0, crop_nms_thresh=1.0,
                                  crop_n_layers=1, min_mask_region_area=12),
}


def _by_prompt(records):
    """Records grouped by (crop box, point), each group in descending
    predicted IoU: the order of records with near-equal scores is left to
    rounding, the grouping is not."""
    groups = {}
    for r in records:
        key = (tuple(r["crop_box"]), tuple(map(tuple, r["point_coords"])))
        groups.setdefault(key, []).append(r)
    return {k: sorted(v, key=lambda r: -r["predicted_iou"]) for k, v in groups.items()}


@pytest.mark.parametrize("name", list(GENERATE))
def test_generate_matches_jax(predictors, name):
    image = make_frames(1, 96, 112, seed=8)[0]
    port, jax_pred = predictors
    kw = GENERATE[name]
    got = SAM2AutomaticMaskGenerator(port, **kw).generate(image)
    want = JaxAMG(jax_pred, **kw).generate(image)
    assert len(got) == len(want) > 10, (len(got), len(want))
    got_g, want_g = _by_prompt(got), _by_prompt(want)
    assert sorted(got_g) == sorted(want_g)
    for key in want_g:
        assert len(got_g[key]) == len(want_g[key]), key
        for g, w in zip(got_g[key], want_g[key]):
            assert g["segmentation"].shape == (96, 112) and g["segmentation"].dtype == bool
            union = np.logical_or(g["segmentation"], w["segmentation"]).sum()
            inter = np.logical_and(g["segmentation"], w["segmentation"]).sum()
            assert union == 0 or inter / union >= MIN_IOU, key
            assert abs(g["predicted_iou"] - w["predicted_iou"]) <= ATOL
            assert abs(g["stability_score"] - w["stability_score"]) <= STABILITY_TOL
            np.testing.assert_allclose(g["bbox"], w["bbox"], atol=BOX_TOL)
            assert g["area"] == int(g["segmentation"].sum())
    scores = [r["stability_score"] for r in got]
    assert max(scores) > min(scores)  # the stability scores say something
    if kw.get("crop_n_layers"):
        assert len({tuple(g["crop_box"]) for g in got}) > 1


def test_no_surviving_mask_gives_no_record(predictors):
    """Repaired in the port: when no mask passes the IoU filter (the
    default 0.8 against random weights' ~0.5), the JAX package's
    calculate_stability_score reshapes [0, H, W] with -1 and raises; the
    port's returns no score and generate returns no record."""
    assert amg.calculate_stability_score(np.zeros((0, 5, 7), np.float32), 0.0, 1.0).shape == (0,)
    with pytest.raises(ValueError):
        jax_amg.calculate_stability_score(np.zeros((0, 5, 7), np.float32), 0.0, 1.0)
    port, jax_pred = predictors
    image = make_frames(1, 96, 112, seed=8)[0]
    assert SAM2AutomaticMaskGenerator(port, points_per_side=4).generate(image) == []
    with pytest.raises(ValueError):
        JaxAMG(jax_pred, points_per_side=4).generate(image)
