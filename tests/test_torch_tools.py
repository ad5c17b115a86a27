"""The port's offline tools (tools/sav_benchmark, sav_utils, vos_inference,
extract_frames, process_dataset) vs the JAX package's.

J&F: seeded masks (empty ones and masks touching the border included) go
through both packages' metrics, which must be equal to the last bit: the
port rebuilds in numpy and scipy the cv2 morphology that the JAX module
takes when cv2 is installed (its 3x3 erosion with the border counted as
foreground, its elliptic structuring element), so it needs no cv2.
VOS inference: both packages' video predictors (tests/test_torch_video_
predictor.py's engines: tiny_test_config(fill_hole_area=8, max_objects=4),
fp32, TF32 off, gather mode) over one PNG frame directory with palettised
ground truth: joint, joint with an object appearing later, and per object;
the written PNGs must agree on >= PIXEL_AGREE of their pixels (logits near 0
may round to the other side; the packages read 1e-5 apart). Label
refinement: both image predictors as in tests/test_torch_image_predictor.py
(JAX's handed the port's prepare_frame and its numpy resize taps); the
refined YOLO lines must be equal. Dataset browsing and frame extraction:
equal results.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import det_sam2_tpu.image_predictor as jax_ip
import det_sam2_tpu.tools.sav_benchmark as jax_sav
import det_sam2_tpu.utils.misc as jax_misc
from det_sam2_tpu.tools import extract_frames as jax_extract
from det_sam2_tpu.tools import process_dataset as jax_process
from det_sam2_tpu.tools import sav_utils as jax_sav_utils
from det_sam2_tpu.tools import vos_inference as jax_vos
from det_sam2_tpu.video_predictor import SAM2VideoPredictor as JaxPredictor

from det_sam2_tpu_torch.image_predictor import SAM2ImagePredictor
from det_sam2_tpu_torch.tools import (
    extract_frames,
    process_dataset,
    sav_benchmark,
    sav_utils,
    vos_inference,
)
from det_sam2_tpu_torch.utils import misc
from det_sam2_tpu_torch.utils.amg import mask_to_rle
from det_sam2_tpu_torch.video_predictor import SAM2VideoPredictor

from test_torch_video_predictor import (  # noqa: F401 (fixtures)
    make_engines,
    make_frames,
    one_torch_thread,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
PIXEL_AGREE = 0.999  # palettised PNGs written by the two packages
H, W, N = 96, 112, 6


# ---------------------------------------------------------------------------
# J&F
# ---------------------------------------------------------------------------


def _seeded_masks(seed, n=12):
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = rng.integers(16, 160, 2)
        a = ndimage.binary_opening(rng.random((h, w)) < rng.uniform(0.2, 0.8))
        b = np.roll(a, int(rng.integers(-4, 5)), axis=int(rng.integers(0, 2)))
        if i % 4 == 0:
            b = np.zeros_like(b)
        if i % 5 == 0:
            a[:, :3] = True  # touching the border
        out.append((a, b))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_region_and_boundary_measures_equal_jax(seed):
    assert jax_sav.cv2 is not None  # JAX's reference path here is cv2's
    for a, b in _seeded_masks(seed):
        for x, y in ((a, b), (b, a), (a, a), (b, b)):
            assert sav_benchmark.db_eval_iou(x, y) == jax_sav.db_eval_iou(x, y)
            assert sav_benchmark.db_eval_boundary(x, y) == jax_sav.db_eval_boundary(x, y)
            assert sav_benchmark.db_eval_boundary(x, y, 0.02) == jax_sav.db_eval_boundary(
                x, y, 0.02)


def test_evaluate_object_and_videos_equal_jax():
    pairs = _seeded_masks(7, 10)
    gt, pred = [a for a, _ in pairs[:5]], [b for _, b in pairs[:5]]
    gt = [np.resize(g, (40, 50)) for g in gt]
    pred = [np.resize(p, (40, 50)) for p in pred]
    for skip in (True, False):
        assert sav_benchmark.evaluate_object(gt, pred, skip) == jax_sav.evaluate_object(
            gt, pred, skip)
    results = {"v0": {1: (gt, pred), 2: (gt, gt)}, "v1": {3: (pred[:2], gt[:2])}}
    assert sav_benchmark.evaluate_videos(results) == jax_sav.evaluate_videos(results)
    assert sav_benchmark.evaluate_videos({}) == jax_sav.evaluate_videos({}) == {
        "J": 0.0, "F": 0.0, "J&F": 0.0}
    e = np.zeros((30, 30), bool)
    assert sav_benchmark.db_eval_iou(e, e) == 1.0 == sav_benchmark.db_eval_boundary(e, e)


def test_jax_fallback_without_cv2_differs_the_port_follows_cv2(monkeypatch):
    """The JAX module's own fallback without cv2 (a disk structuring element,
    erosion with a background border) gives another F than its cv2 path; the
    port equals the cv2 path (ROADMAP Queue 3)."""
    a = np.zeros((60, 80), bool)
    a[:30, 10:50] = True  # touching the top border
    b = np.roll(a, 3, axis=1)
    with_cv2 = jax_sav.db_eval_boundary(a, b)
    monkeypatch.setattr(jax_sav, "cv2", None)
    assert jax_sav.db_eval_boundary(a, b) != with_cv2
    assert sav_benchmark.db_eval_boundary(a, b) == with_cv2


def test_cv2_ellipse_is_cv2s():
    import cv2

    for r in range(1, 40):
        want = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * r + 1, 2 * r + 1))
        np.testing.assert_array_equal(sav_benchmark._cv2_ellipse(r), want.astype(bool))


# ---------------------------------------------------------------------------
# VOS inference
# ---------------------------------------------------------------------------


def _rect_mask(y0, y1, x0, x1):
    m = np.zeros((H, W), bool)
    m[y0:y1, x0:x1] = True
    return m


@pytest.fixture(scope="module")
def vos_data(tmp_path_factory):
    """A PNG frame directory and two ground-truth directories: objects 1, 2
    at frame 0; and the same plus object 3 first at frame 2."""
    root = tmp_path_factory.mktemp("vos")
    frames = root / "frames"
    frames.mkdir()
    for i, f in enumerate(make_frames(N, H, W, seed=4)):
        Image.fromarray(f).save(frames / f"{i:05d}.png")
    first = {1: _rect_mask(10, 40, 10, 50), 2: _rect_mask(50, 80, 60, 100)}
    gt = root / "gt"
    gt.mkdir()
    vos_inference.save_palettised_png(first, str(gt / "00000.png"))
    later = root / "gt_later"
    later.mkdir()
    vos_inference.save_palettised_png(first, str(later / "00000.png"))
    vos_inference.save_palettised_png({3: _rect_mask(60, 90, 5, 40)},
                                      str(later / "00002.png"))
    return root


@pytest.fixture(scope="module")
def video_predictors():
    jeng, eng = make_engines()
    return SAM2VideoPredictor(eng), JaxPredictor(jeng)


def _pngs(d):
    return {n: np.asarray(Image.open(os.path.join(d, n))) for n in sorted(os.listdir(d))}


VOS_CASES = {
    "joint": ("gt", dict()),
    "joint, later object": ("gt_later", dict(track_object_appearing_later=True)),
    "joint, all masks, later object": ("gt_later", dict(
        use_all_masks=True, track_object_appearing_later=True)),
    "per object": ("gt_later", None),
}


@pytest.mark.parametrize("case", list(VOS_CASES))
def test_vos_inference_pngs_match_jax(video_predictors, vos_data, case):
    vp, jvp = video_predictors
    gt, kw = VOS_CASES[case]
    outs = {}
    for name, mod, pred in (("port", vos_inference, vp), ("jax", jax_vos, jvp)):
        out = vos_data / case.replace(" ", "_").replace(",", "") / name
        if kw is None:
            mod.vos_separate_inference_per_object(pred, str(vos_data / "frames"),
                                                  str(vos_data / gt), str(out))
        else:
            mod.vos_inference(pred, str(vos_data / "frames"), str(vos_data / gt),
                              str(out), **kw)
        outs[name] = _pngs(out)
    got, want = outs["port"], outs["jax"]
    assert sorted(got) == sorted(want) == [f"{i:05d}.png" for i in range(N)]
    for n in want:
        assert got[n].dtype == np.uint8 and got[n].shape == (H, W)
        agree = (got[n] == want[n]).mean()
        assert agree >= PIXEL_AGREE, f"{case} {n}: {agree}"
    objs = {int(v) for a in got.values() for v in np.unique(a)} - {0}
    assert objs == ({1, 2} if gt == "gt" else {1, 2, 3}), case
    if gt == "gt_later":
        assert 3 not in np.unique(got["00000.png"]) and (got["00002.png"] == 3).any()


def test_vos_inference_refuses_a_later_object(video_predictors, vos_data, tmp_path):
    vp, _ = video_predictors
    with pytest.raises(RuntimeError, match="track_object_appearing_later"):
        vos_inference.vos_inference(vp, str(vos_data / "frames"),
                                    str(vos_data / "gt_later"), str(tmp_path),
                                    use_all_masks=True)


def test_palette_and_png_io_equal_jax(tmp_path):
    np.testing.assert_array_equal(vos_inference.DAVIS_PALETTE, jax_vos.DAVIS_PALETTE)
    masks = {1: _rect_mask(0, 30, 0, 30), 7: _rect_mask(20, 60, 20, 90)}
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    vos_inference.save_palettised_png(masks, str(tmp_path / "p" / "00004.png"))
    jax_vos.save_palettised_png(masks, str(tmp_path / "j" / "00004.png"))
    assert (tmp_path / "p" / "00004.png").read_bytes() == (
        tmp_path / "j" / "00004.png").read_bytes()
    got = vos_inference.load_gt_masks(str(tmp_path / "p"))
    want = jax_vos.load_gt_masks(str(tmp_path / "p"))
    assert sorted(got) == [4]
    assert sorted(got) == sorted(want)
    for k in want:
        assert sorted(got[k]) == sorted(want[k]) == [1, 7]
        for o in want[k]:
            np.testing.assert_array_equal(got[k][o], want[k][o])
    with pytest.raises(ValueError, match="no masks"):
        vos_inference.save_palettised_png({}, str(tmp_path / "e.png"))


# ---------------------------------------------------------------------------
# SA-V browsing, frame extraction
# ---------------------------------------------------------------------------


def _sav_tree(root):
    """A DAVIS layout (JPEGImages/ + Annotations/) with vid0's palettised
    PNGs and vid1's SA-V RLE manifest, and a flat layout of frame dirs."""
    for v, seed in (("vid0", 5), ("vid1", 6)):
        (root / "JPEGImages" / v).mkdir(parents=True)
        for i, f in enumerate(make_frames(3, H, W, seed=seed)):
            Image.fromarray(f).save(root / "JPEGImages" / v / f"{i:05d}.jpg")
    ann_dir = root / "Annotations" / "vid0"
    ann_dir.mkdir(parents=True)
    for i in range(3):
        vos_inference.save_palettised_png({1: _rect_mask(20, 50, 8 + 3 * i, 32 + 3 * i),
                                           2: _rect_mask(60, 70, 60, 90)},
                                          str(ann_dir / f"{i:05d}.png"))
    rle = [mask_to_rle(_rect_mask(5, 25 + i, 5, 40)[None])[0] for i in range(3)]
    # per object, its per-frame RLEs (None where it is absent)
    (root / "vid1_manual.json").write_text(json.dumps(
        {"masklet": [[rle[0], rle[1], None], [None, rle[2], rle[0]]]}))
    flat = root / "flat"
    (flat / "vidA").mkdir(parents=True)
    for i, f in enumerate(make_frames(2, H, W, seed=7)):
        Image.fromarray(f).save(flat / "vidA" / f"{i:05d}.jpg")
    return root, flat


def test_sav_dataset_browsing_equals_jax(tmp_path):
    root, flat = _sav_tree(tmp_path)
    for r, video, idx, n_frames in ((root, "vid0", 1, 3), (root, "vid1", 2, 3),
                                    (flat, "vidA", 0, 0)):
        got, want = sav_utils.SAVDataset(str(r)), jax_sav_utils.SAVDataset(str(r))
        assert got.videos == want.videos and video in got.videos
        assert got.frame_paths(video) == want.frame_paths(video)
        np.testing.assert_array_equal(got.load_frame(video, idx),
                                      want.load_frame(video, idx))
        ga, wa = got.load_annotations(video), want.load_annotations(video)
        assert sorted(ga) == sorted(wa) and len(ga) == n_frames
        for f in wa:
            assert sorted(ga[f]) == sorted(wa[f])
            for o in wa[f]:
                np.testing.assert_array_equal(ga[f][o], wa[f][o])
        out = tmp_path / f"{video}.png"
        overlay = got.render_overlay(video, idx, out_path=str(out))
        np.testing.assert_array_equal(overlay, want.render_overlay(video, idx))
        assert overlay.shape == (H, W, 3) and out.exists()
    assert sorted(sav_utils.SAVDataset(str(root)).load_annotations("vid1")[1]) == [1, 2]
    with pytest.raises(FileNotFoundError):
        sav_utils.SAVDataset(str(root)).load_annotations("nope")


def _write_video(path, n, fps):
    import cv2

    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    for f in make_frames(n, H, W, seed=8):
        wr.write(f[..., ::-1].copy())
    wr.release()


@pytest.mark.parametrize("fps", [None, 10.0, 24.0])
def test_extract_frames_equals_jax(tmp_path, fps):
    src = tmp_path / "in.mp4"
    _write_video(src, 30, 30.0)
    n = extract_frames.extract_frames(str(src), str(tmp_path / "p"), fps=fps,
                                      start_number=3)
    m = jax_extract.extract_frames(str(src), str(tmp_path / "j"), fps=fps,
                                   start_number=3)
    assert n == m == {None: 30, 10.0: 10, 24.0: 24}[fps]
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) and names[0] == "00003.jpg"
    for name in names:
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    with pytest.raises(RuntimeError, match="cannot open"):
        extract_frames.extract_frames(str(tmp_path / "missing.mp4"), str(tmp_path / "x"))


# ---------------------------------------------------------------------------
# label refinement
# ---------------------------------------------------------------------------


def test_yolo_box_conversions_equal_jax():
    for line in ("0 0.5 0.5 0.25 0.5", "3 0.1 0.9 0.2 0.1", "12 0.333 0.25 0.5 0.4"):
        assert process_dataset.yolo_to_xyxy(line, W, H) == jax_process.yolo_to_xyxy(
            line, W, H)
        cls, box = process_dataset.yolo_to_xyxy(line, W, H)
        back = process_dataset.xyxy_to_yolo(cls, np.asarray(box), W, H)
        assert back == jax_process.xyxy_to_yolo(cls, np.asarray(box), W, H)
        assert back == " ".join([line.split()[0]] + [f"{float(v):.6f}"
                                                       for v in line.split()[1:]])


def test_process_dataset_equals_jax(tmp_path):
    images, labels = tmp_path / "images", tmp_path / "labels"
    images.mkdir()
    labels.mkdir()
    for i, f in enumerate(make_frames(3, H, W, seed=9)):
        Image.fromarray(f).save(images / f"{i:03d}.png")
        (labels / f"{i:03d}.txt").write_text(
            "0 0.30 0.25 0.40 0.35\n\n1 0.70 0.65 0.35 0.40\n2 0.02 0.02 0.01 0.01\n")
    (images / "skip.txt").write_text("not an image")
    Image.fromarray(make_frames(1, H, W)[0]).save(images / "nolabel.png")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ip, "prepare_frame", misc.prepare_frame)
        mp.setattr(jax_misc, "cv2", None)  # JAX's numpy resize taps
        jeng, eng = make_engines()
        process_dataset.process_dataset(SAM2ImagePredictor(eng), str(images), str(labels),
                                        str(tmp_path / "port"))
        jax_process.process_dataset(jax_ip.SAM2ImagePredictor(jeng), str(images),
                                    str(labels), str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == ["000.txt", "001.txt",
                                                            "002.txt"]
    refined = 0
    for n in names:
        got = (tmp_path / "port" / n).read_text()
        assert got == (tmp_path / "jax" / n).read_text(), n
        lines = got.splitlines()
        assert len(lines) == 3
        orig = (labels / n).read_text().split("\n")
        refined += sum(a != b for a, b in zip(lines, [orig[0], orig[2], orig[3]]))
    assert refined > 0  # some boxes were re-fit to their masks
