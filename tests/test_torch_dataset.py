"""The port's VOS data pipeline vs the JAX package's, on the same inputs.

The raw datasets read the same files (MOSE / DAVIS PNG layout, SA-V PNG and
JSON layouts, SA-1B) written to tmp_path with PIL; the augmentations, the
loaders and the host click sampler take the same seeds. The JAX package
warps, resizes and computes distance transforms with cv2, which these
tests import; the port computes the same in numpy / scipy without cv2.
Every comparison is bit for bit: frames, masks, batches and clicks must be
equal.
"""

import json
import os
import random

import cv2
import numpy as np
import pytest

import det_sam2_tpu.training.dataset as jd
from det_sam2_tpu.training.samplers import (
    sample_one_point_from_error_center_np as jax_center_click,
)

import det_sam2_tpu_torch.training.dataset as pd
from det_sam2_tpu_torch.training.samplers import (
    get_next_point,
    sample_one_point_from_error_center_np,
)


def _clips(h, w, n=2, seed=0):
    """(JAX clip, port clip) of n seeded noise frames and two masks a frame."""
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]
    masks = [{1: rng.random((h, w)) > 0.5, 3: rng.random((h, w)) > 0.8}
             for _ in range(n)]
    return jd.VideoClip(frames, masks), pd.VideoClip(frames, masks)


def _assert_clips_equal(a, b):
    assert len(a.frames) == len(b.frames)
    for x, y in zip(a.frames, b.frames):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    for x, y in zip(a.masks, b.masks):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


# ---------------------------------------------------------------------------
# cv2's geometry rebuilt in numpy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("angle", [-24.3, 0.0, 7.5, 25.0])
def test_rotation_matrix_equals_cv2(angle):
    for hw in ((720, 1280), (37, 53)):
        want = cv2.getRotationMatrix2D((hw[1] / 2, hw[0] / 2), angle, 1.0)
        got = pd.rotation_matrix_2d((hw[1] / 2, hw[0] / 2), angle, 1.0)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(720, 1280), (37, 53), (61, 90), (64, 64), (79, 127)])
def test_affine_clip_equals_jax_cv2(hw):
    """Rotation + shear drawn from the same rng: frames bilinear, masks
    nearest, bit for bit; widths that are not a multiple of 16 exercise
    cv2's scalar tail columns."""
    n = 1 if hw[0] > 100 else 2
    for seed in range(2 if hw[0] > 100 else 4):
        ja, pa = _clips(*hw, n=n, seed=seed)
        _assert_clips_equal(jd.affine_clip(ja, random.Random(seed)),
                            pd.affine_clip(pa, random.Random(seed)))


def test_affine_warp_matches_cv2_on_single_channel_and_shifts():
    """A plain shift and a rotation about a corner, frames and masks."""
    rng = np.random.default_rng(4)
    f = rng.integers(0, 256, (50, 75, 3), np.uint8)
    m = (rng.random((50, 75)) > 0.5).astype(np.uint8)
    for mat in (np.array([[1.0, 0.0, 0.3], [0.0, 1.0, -0.25]]),
                cv2.getRotationMatrix2D((0.0, 0.0), 13.0, 1.0)):
        warp = pd.AffineWarp(mat, 50, 75)
        np.testing.assert_array_equal(
            warp.frame(f), cv2.warpAffine(f, mat, (75, 50), flags=cv2.INTER_LINEAR))
        np.testing.assert_array_equal(
            warp.mask(m), cv2.warpAffine(m, mat, (75, 50), flags=cv2.INTER_NEAREST))


@pytest.mark.parametrize("hw, size", [((720, 1280), 1024), ((720, 1280), 128),
                                      ((37, 53), 64), ((50, 61), 33), ((48, 48), 48),
                                      ((100, 77), 20)])
def test_resize_clip_equals_jax_cv2(hw, size):
    ja, pa = _clips(*hw, n=1, seed=1)
    _assert_clips_equal(jd.resize_clip(ja, size), pd.resize_clip(pa, size))


def test_fma32_is_one_rounding():
    """float32 a * b + c with one rounding, against exact rational
    arithmetic rounded once: products that sit exactly halfway between two
    float32 values, plus a c of +-2^-50 that the float64 sum loses (two
    roundings would round the tie to even; one rounding goes c's way), and
    random inputs."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = (1 + rng.integers(0, 2 ** 23, 200_000) * 2.0 ** -23).astype(np.float32)
    b = rng.integers(1, 256, 200_000).astype(np.float32)
    p = a.astype(np.float64) * b
    tie = (p.view(np.uint64) & np.uint64(0x1FFFFFFF)) == np.uint64(0x10000000)
    a, b = a[tie], b[tie]
    c = np.where(rng.random(a.size) < 0.5, 2.0 ** -50, -(2.0 ** -50)).astype(np.float32)
    ra = rng.random(500).astype(np.float32)
    a = np.concatenate([a, ra])
    b = np.concatenate([b, rng.integers(-255, 256, 500).astype(np.float32)])
    c = np.concatenate([c, (rng.random(500) * 255).astype(np.float32)])
    assert tie.sum() > 300
    got = pd._fma32(a, b, c)

    def round_once(x: Fraction) -> np.float32:
        near = np.float32(float(x))
        cands = [near, np.nextafter(near, np.float32(np.inf)),
                 np.nextafter(near, np.float32(-np.inf))]
        dist = [abs(Fraction(float(v)) - x) for v in cands]
        best = [v for v, d in zip(cands, dist) if d == min(dist)]
        return min(best, key=lambda v: int(np.asarray(v).view(np.uint32)) & 1)

    wrong_if_twice = 0
    for i in range(a.size):
        x = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        want = round_once(x)
        assert got[i] == want, i
        wrong_if_twice += np.float32(np.float64(a[i]) * np.float64(b[i]) + np.float64(c[i])) != want
    assert wrong_if_twice > 100  # the cases where a float64 sum alone is wrong


# ---------------------------------------------------------------------------
# the other augmentations
# ---------------------------------------------------------------------------


def test_flip_grayscale_and_jitter_equal_jax():
    ja, pa = _clips(48, 40, n=3, seed=2)
    _assert_clips_equal(jd.hflip_clip(ja), pd.hflip_clip(pa))
    _assert_clips_equal(jd.grayscale_clip(ja), pd.grayscale_clip(pa))
    for consistent in (True, False):
        for hue in (None, 0.1):  # the hue op converts to HSV with cv2 on both sides
            kw = dict(brightness=0.1, contrast=0.05, saturation=0.05, hue=hue,
                      consistent=consistent)
            _assert_clips_equal(jd.color_jitter_clip(ja, random.Random(5), **kw),
                                pd.color_jitter_clip(pa, random.Random(5), **kw))


# ---------------------------------------------------------------------------
# raw datasets over files
# ---------------------------------------------------------------------------


def _palette_png(path, arr):
    from PIL import Image

    im = Image.new("P", (arr.shape[1], arr.shape[0]))
    im.putdata(arr.astype(np.uint8).reshape(-1).tolist())
    im.putpalette([0, 0, 0, 200, 30, 30, 30, 200, 30, 30, 30, 200] + [0] * 756)
    im.save(path)


@pytest.fixture
def mose_layout(tmp_path):
    """<root>/JPEGImages/<video>/*.jpg + <root>/Annotations/<video>/*.png with
    palettised masks of objects 1 and 2 (object 2 leaves after frame 2)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    img_root, gt_root = tmp_path / "JPEGImages", tmp_path / "Annotations"
    for v in ("bear", "cat"):
        (img_root / v).mkdir(parents=True)
        (gt_root / v).mkdir(parents=True)
        for t in range(5):
            Image.fromarray(rng.integers(0, 256, (36, 52, 3), np.uint8)).save(
                img_root / v / f"{t:05d}.jpg")
            m = np.zeros((36, 52), np.uint8)
            m[4 + t:18 + t, 6:20] = 1
            if t < 3:
                m[20:30, 30 + t:45 + t] = 2
            _palette_png(gt_root / v / f"{t:05d}.png", m)
    return str(img_root), str(gt_root)


def _dataset_equal(jds, pds, check_all=True):
    assert pds.videos == jds.videos
    for v in pds.videos:
        names = pds.frame_names(v)
        assert names == jds.frame_names(v)
        pick = names if check_all else names[:2]
        _assert_clips_equal(jds.load_frames(v, pick), pds.load_frames(v, pick))


def test_png_raw_dataset_equals_jax(mose_layout):
    img, gt = mose_layout
    _dataset_equal(jd.PNGRawDataset(img, gt), pd.PNGRawDataset(img, gt))
    _dataset_equal(jd.PNGRawDataset(img, gt, file_list=["cat"]),
                   pd.PNGRawDataset(img, gt, file_list=["cat"]))


def test_multiple_png_raw_dataset_equals_jax(tmp_path):
    """SA-V extracted layout: per-object mask directories, a missing PNG
    meaning an empty mask; and single_object_mode."""
    from PIL import Image

    rng = np.random.default_rng(1)
    img_root, gt_root = tmp_path / "JPEGImages_24fps", tmp_path / "Annotations_6fps"
    (img_root / "sav_1").mkdir(parents=True)
    for t in range(4):
        Image.fromarray(rng.integers(0, 256, (30, 40, 3), np.uint8)).save(
            img_root / "sav_1" / f"{t:05d}.jpg")
    for obj in (0, 4):
        d = gt_root / "sav_1" / f"{obj:03d}"
        d.mkdir(parents=True)
        for t in range(4):
            if obj == 4 and t == 1:
                continue
            m = np.zeros((30, 40), np.uint8)
            m[3 + t + obj:15 + t, 5:25 - obj] = 255
            Image.fromarray(m).save(d / f"{t:05d}.png")
    _dataset_equal(jd.MultiplePNGRawDataset(str(img_root), str(gt_root)),
                   pd.MultiplePNGRawDataset(str(img_root), str(gt_root)))
    one = str(gt_root / "sav_1" / "004")
    a = jd.MultiplePNGRawDataset(str(img_root), one, file_list=["sav_1"],
                                 single_object_mode=True)
    b = pd.MultiplePNGRawDataset(str(img_root), one, file_list=["sav_1"],
                                 single_object_mode=True)
    a._mask_root = b._mask_root = lambda video: one
    _dataset_equal(a, b)


def test_json_and_sa1b_raw_datasets_and_rle_equal_jax(tmp_path):
    """SA-V masklet JSON (compressed RLE, 6 fps annotations of 24 fps frames,
    a null masklet) and SA-1B (area and uncertainty filters)."""
    from PIL import Image
    from test_dataset_v2 import _encode_coco_rle

    rng = np.random.default_rng(2)
    img_root, gt_root = tmp_path / "frames", tmp_path / "json"
    (img_root / "sav_9").mkdir(parents=True)
    (gt_root / "sav_9").mkdir(parents=True)
    for t in range(9):
        Image.fromarray(rng.integers(0, 256, (24, 30, 3), np.uint8)).save(
            img_root / "sav_9" / f"{t:05d}.jpg")
    masklet = []
    for k in range(3):
        m1 = np.zeros((24, 30), bool)
        m1[2 + k:12 + k, 3:14] = True
        m2 = rng.random((24, 30)) > 0.7
        masklet.append([_encode_coco_rle(m1), None if k == 1 else _encode_coco_rle(m2)])
    with open(gt_root / "sav_9" / "sav_9_manual.json", "w") as f:
        json.dump({"masklet": masklet, "fps": 6}, f)
    _dataset_equal(jd.JSONRawDataset(str(img_root), str(gt_root)),
                   pd.JSONRawDataset(str(img_root), str(gt_root)))
    for rle in masklet[0] + [{"size": [4, 6], "counts": [3, 5, 2, 14]}]:
        np.testing.assert_array_equal(pd.decode_coco_rle(rle), jd.decode_coco_rle(rle))

    sa = tmp_path / "sa1b"
    sa.mkdir()
    Image.fromarray(rng.integers(0, 256, (28, 36, 3), np.uint8)).save(sa / "sa_7.jpg")
    anns = []
    for i, (area_frac, unc) in enumerate(((0.2, 0.9), (0.0, 0.9), (0.95, 0.9), (0.1, 0.2))):
        m = np.zeros((28, 36), bool)
        m[: int(28 * area_frac), : 36] = True
        anns.append({"area": int(m.sum()), "uncertain_iou": unc,
                     "segmentation": _encode_coco_rle(m)})
    with open(sa / "sa_7.json", "w") as f:
        json.dump({"annotations": anns}, f)
    for kw in ({}, {"mask_area_frac_thresh": 0.9, "uncertain_iou": 0.5, "num_frames": 2}):
        _dataset_equal(jd.SA1BRawDataset(str(sa), str(sa), **kw),
                       pd.SA1BRawDataset(str(sa), str(sa), **kw))


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------


class _TwoObjects:
    """SyntheticRawDataset plus a second moving square (both packages)."""

    @staticmethod
    def make(mod, **kw):
        class DS(mod.SyntheticRawDataset):
            def load_frames(self, video, names):
                clip = super().load_frames(video, names)
                h, w = self.hw
                for t, (f, per) in enumerate(zip(clip.frames, clip.masks)):
                    y = 10 + 2 * t
                    f[y:y + 20, 50:80] = (40, 200, 60)
                    m = np.zeros((h, w), bool)
                    m[y:y + 20, 50:80] = True
                    per[2] = m
                return clip

        return DS(**kw)


RECIPE = dict(hflip_prob=0.5, affine_prob=1.0, color_jitter_prob=1.0,
              color_jitter_strengths=(0.1, 0.03, 0.03),
              per_frame_jitter_strengths=(0.1, 0.05, 0.05), grayscale_prob=0.05)


@pytest.mark.parametrize("objects, kw", [(1, {}), (2, RECIPE)])
def test_vos_loader_batches_equal_jax(objects, kw):
    """The default loader and the MOSE recipe's augmentations, 96x144
    videos to 64^2, three batches of two tracks from one seed."""
    def loader(mod):
        ds = _TwoObjects.make(mod, num_videos=3, num_frames=6, hw=(96, 144), seed=3)
        return mod.VOSDataLoader(
            ds, mod.RandomUniformSampler(num_frames=3, max_num_objects=objects,
                                         reverse_time_prob=0.3),
            image_size=64, batch_size=2, seed=7, **kw)

    a, b = loader(jd), loader(pd)
    n = 0
    for (ji, jg), (pi, pg) in zip(a.batches(3), b.batches(3)):
        assert pi.dtype == ji.dtype == np.float32 and pg.dtype == jg.dtype
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pg, jg)
        n += 1
    assert n == 3 and pg.shape == ((3, 2, 64, 64) if objects == 1 else (3, 2, 2, 64, 64))
    # the rng carries over: a second call continues the stream
    np.testing.assert_array_equal(next(b.batches(1))[0], next(a.batches(1))[0])


def test_eval_sampler_and_mixed_loader_equal_jax():
    def mixed(mod):
        loaders = [
            mod.VOSDataLoader(mod.SyntheticRawDataset(num_videos=2, num_frames=4, seed=s,
                                                      hw=(40, 40)),
                              mod.RandomUniformSampler(num_frames=2), image_size=32,
                              batch_size=1, seed=s)
            for s in (0, 9)
        ]
        return mod.MixedDataLoader(loaders, weights=[0.3, 0.7], seed=4)

    for (ji, jg), (pi, pg) in zip(mixed(jd).batches(5), mixed(pd).batches(5)):
        np.testing.assert_array_equal(pi, ji)
        np.testing.assert_array_equal(pg, jg)
    names = [f"{i:05d}" for i in range(7)][::-1]
    assert pd.EvalSampler().sample(random.Random(0), names) == \
        jd.EvalSampler().sample(random.Random(0), names)
    ev = [mod.VOSDataLoader(_TwoObjects.make(mod, num_videos=1, num_frames=3, hw=(96, 96)),
                            mod.EvalSampler(), image_size=32, batch_size=1,
                            hflip_prob=0.0, color_jitter_prob=0.0)
          for mod in (jd, pd)]
    (ji, jg), (pi, pg) = next(ev[0].batches(1)), next(ev[1].batches(1))
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pg, jg)
    assert pg.shape == (3, 1, 2, 32, 32)


# ---------------------------------------------------------------------------
# the host click sampler
# ---------------------------------------------------------------------------


def test_center_click_sampler_equals_jax_cv2():
    """RITM centre clicks from cv2's distance transform (JAX) and scipy's
    (port) on random and rectangular error regions, with and without
    padding and a prediction."""
    rng = np.random.default_rng(0)
    for i in range(60):
        b, h, w = 3, int(rng.integers(8, 70)), int(rng.integers(8, 70))
        if i % 2:
            gt, pred = rng.random((b, h, w)) > 0.5, rng.random((b, h, w)) > 0.5
        else:
            gt, pred = np.zeros((b, h, w), bool), np.zeros((b, h, w), bool)
            for j in range(b):
                y, x = rng.integers(0, h // 2), rng.integers(0, w // 2)
                gt[j, y:y + rng.integers(2, h // 2 + 2), x:x + rng.integers(2, w // 2 + 2)] = 1
                y, x = rng.integers(0, h // 2), rng.integers(0, w // 2)
                pred[j, y:y + rng.integers(2, h // 2 + 2), x:x + rng.integers(2, w // 2 + 2)] = 1
        for padding in (True, False):
            for p in (pred, None):
                want = jax_center_click(gt, p, padding)
                got = sample_one_point_from_error_center_np(gt, p, padding)
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])
                assert got[0].dtype == np.float32 and got[1].dtype == np.int32


def test_get_next_point_uniform_and_refusal():
    import torch

    gt = torch.zeros(2, 16, 16)
    gt[:, 4:9, 3:12] = 1
    pts, labels = get_next_point(torch.Generator().manual_seed(0), gt, None)
    assert pts.shape == (2, 1, 2) and labels.tolist() == [[1], [1]]
    for (x, y) in pts[:, 0].tolist():
        assert gt[0, int(y), int(x)] == 1
    with pytest.raises(ValueError, match="center"):
        get_next_point(torch.Generator(), gt, None, method="center")
