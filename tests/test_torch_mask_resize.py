"""The port's cv2-exact resize of mask logits vs cv2 and the JAX package.

The JAX package resizes mask logits to video or image resolution with
``cv2.resize`` (``utils/misc.py:resize_masks_np``, 128 masks a call through
cv2's channel axis); cv2 takes IPP's arithmetic at 1, 3 or 4 channels and
its generic float INTER_LINEAR at any other count. The port rebuilds both in
numpy / torch (``utils/cv2_resize.py``, the plain version) and computes them
on the card with ``csrc/mask_resize.cu`` (held to the plain version bit for
bit in tests/test_torch_kernels_cuda.py and chip_smoke.py). Here, on the
CPU, every comparison is bit for bit with cv2 installed:

  * the plain versions against cv2.resize: the generic path at 2, 5, 8 and
    12 channels and at exact 2x downscales, IPP at 1, 3 and 4 channels over
    a sweep of scales whose clamped border columns (k a side) cover IPP's
    border rule;
  * ``resize_masks_np`` against JAX's with cv2 present at 1-5, 12, 128,
    129 and 130 masks, 256^2 -> 720x1280 and 1080x1920;
  * the kernel's packed taps, read as csrc/mask_resize.cu reads them (a
    numpy mirror of its schedule and arithmetic: row tiles with their
    two-row cache of horizontal values, 4-column groups and the tail),
    against the plain version, and its launch limits;
  * the video predictor's video-resolution masks (propagate_in_video and
    the prompt calls) and the image predictor's masks against JAX's
    resize of the same low-res logits.
"""

import cv2
import numpy as np
import pytest
import torch

import det_sam2_tpu.image_predictor as jax_ip
import det_sam2_tpu.utils.misc as jax_misc

from det_sam2_tpu_torch.image_predictor import SAM2ImagePredictor
from det_sam2_tpu_torch.ops import mask_resize
from det_sam2_tpu_torch.utils import cv2_resize, misc
from det_sam2_tpu_torch.utils.cv2_resize import _fma32
from det_sam2_tpu_torch.video_predictor import SAM2VideoPredictor
from test_torch_video_predictor import (
    H,
    W,
    drive_tracking,
    make_engines,
    make_frames,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
)


def _cv2(img, size):
    out = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
    return out[:, :, None] if out.ndim == 2 else out


def assert_same_bits(got, want, what=""):
    """float32 arrays equal bit for bit (compared as uint32: quick on 1 GB
    arrays, and -0.0 is not +0.0)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32, what
    same = got.view(np.uint32) == want.view(np.uint32)
    if not same.all():
        d = np.abs(got.astype(np.float64) - want)[~same]
        raise AssertionError(f"{what}: {d.size} of {same.size} values differ, "
                             f"by at most {d.max():.3g}")


def _logits(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 8).astype(np.float32)


def _clamped(ow: int, w: int):
    """Output columns whose source index is clamped, (left, right): an
    independent count of what ``ipp_border`` splits."""
    s = np.floor((np.arange(ow) + 0.5) * (w / ow) - 0.5)
    return int((s < 0).sum()), int((s >= w - 1).sum())


# ---------------------------------------------------------------------------
# the plain versions against cv2.resize
# ---------------------------------------------------------------------------

# (h, w) -> (oh, ow): up and down on each axis, a 33x upscale, 720p shapes
GENERIC_SIZES = [((32, 48), (33, 70)), ((64, 64), (144, 256)), ((256, 200), (300, 77)),
                 ((7, 7), (231, 231)), ((40, 30), (13, 9))]


@pytest.mark.parametrize("size", GENERIC_SIZES, ids=str)
@pytest.mark.parametrize("c", [2, 5, 8, 12])
def test_generic_float_resize_equals_cv2(c, size):
    (h, w), (oh, ow) = size
    img = _logits((h, w, c), c + h)
    got = cv2_resize.resize_linear_float_generic(img, (ow, oh))
    assert_same_bits(got, _cv2(img, (ow, oh)))


@pytest.mark.parametrize("size", [((64, 64), (32, 32)), ((32, 48), (16, 24)),
                                  ((256, 256), (128, 128)), ((64, 64), (32, 40))], ids=str)
@pytest.mark.parametrize("c", [2, 5, 12])
def test_generic_exact_2x_downscale_equals_cv2(c, size):
    """cv2 takes INTER_AREA's fast path at an exact 2x downscale on both
    axes (the last case, 2x on one axis only, stays bilinear)."""
    (h, w), (oh, ow) = size
    assert cv2_resize.area_fast((oh, ow), (h, w)) == (ow * 2 == w)
    img = _logits((h, w, c), c)
    got = cv2_resize.resize_linear_float_generic(img, (ow, oh))
    assert_same_bits(got, _cv2(img, (ow, oh)))


IPP_W = 8  # input width of the border-rule sweep: k clamped columns need ~2k x


def _ow_for(k: int) -> int:
    return next(ow for ow in range(IPP_W, 200 * IPP_W) if _clamped(ow, IPP_W)[0] == k)


@pytest.mark.parametrize("k", [3, 4, 5, 8, 15, 16, 17, 20, 24, 33])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_ipp_float_resize_equals_cv2_across_the_border_rule(c, k):
    """k clamped columns on the left (and k or k +- 1 on the right): blocks
    of 16 and a remainder, the remainder rounding twice from 5 columns on,
    the blocks too at 4 channels. Vertically one downscale, one upscale."""
    ow = _ow_for(k)
    left, right = _clamped(ow, IPP_W)
    assert left == k and abs(right - k) <= 1
    flag = cv2_resize.ipp_border(ow, IPP_W)
    assert (flag == 2).sum() == 16 * (left // 16 + right // 16)
    for h, oh in ((12, 5), (12, 40)):
        img = _logits((h, IPP_W, c), k + h)
        got = cv2_resize.resize_linear_float(img, (ow, oh))
        assert_same_bits(got, _cv2(img, (ow, oh)), f"{h} -> {oh}")


@pytest.mark.parametrize("size", [((32, 48), (16, 24)), ((48, 64), (20, 36)),
                                  ((256, 256), (100, 140)), ((64, 64), (200, 48)),
                                  ((256, 256), (720, 1280))], ids=str)
@pytest.mark.parametrize("c", [1, 3, 4])
def test_ipp_float_resize_equals_cv2_down_and_up(c, size):
    """Downscales (no clamped column, or one) and a 720p upscale."""
    (h, w), (oh, ow) = size
    img = _logits((h, w, c), c + w)
    assert_same_bits(cv2_resize.resize_linear_float(img, (ow, oh)), _cv2(img, (ow, oh)))


# ---------------------------------------------------------------------------
# resize_masks_np against JAX's with cv2 present
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("out_hw", [(720, 1280), (1080, 1920)], ids=str)
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 12, 128, 129, 130])
def test_resize_masks_np_equals_jax_with_cv2(n, out_hw):
    """Chunks of 128, each on cv2's path for its own channel count: 129 is
    128 generic + 1 IPP, 130 is 128 + 2, both generic."""
    assert jax_misc.cv2 is not None
    masks = _logits((n, 1, 256, 256), n)
    got = misc.resize_masks_np(masks, out_hw)
    assert got.shape == (n, 1) + out_hw and got.dtype == np.float32
    assert_same_bits(got, jax_misc.resize_masks_np(masks, out_hw))


def test_resize_masks_np_keeps_the_lead_axes_and_same_size_input():
    masks = _logits((2, 3, 1, 24, 20), 0)
    got = misc.resize_masks_np(masks, (50, 44))
    assert got.shape == (2, 3, 1, 50, 44)
    assert_same_bits(got, jax_misc.resize_masks_np(masks, (50, 44)))
    assert misc.resize_masks_np(masks, (24, 20)) is masks


# ---------------------------------------------------------------------------
# the kernel's taps and arithmetic, mirrored in numpy
# ---------------------------------------------------------------------------


def _kernel_mirror(src, out_hw, group=128, fault=0, rows=mask_resize.MAX_ROWS):
    """csrc/mask_resize.cu's schedule and arithmetic in numpy, on the taps
    that ops/mask_resize.py packs for it, read at the kernel's offsets: each
    mask in tiles of ``rows`` output rows; down a tile the horizontal values
    of the last two source rows kept (pa for y0's row, pb for y1's) and a
    source row's computed only when y0 or y1 moves on to it; each row
    written in groups of 4 columns, the last partial group column by column.
    The 4-column threads' arithmetic is elementwise, so the mirror runs a
    row's columns (rounded up to 4, the padded taps) at once."""
    n, h, w = src.shape
    oh, ow = out_hw
    ow4 = -(-ow // 4) * 4
    idx, wt = mask_resize.mask_resize_taps((h, w), (oh, ow))
    assert idx.shape == (6 * ow4 + 4 * oh,) and wt.shape == (3 * ow4 + 3 * oh,)
    xcol = lambda a, i: a[i * ow4:(i + 1) * ow4]  # noqa: E731
    ycol = lambda a, start, i: a[start + i * oh:start + (i + 1) * oh]  # noqa: E731
    gx0, gx1, ix0, ix1, copy, border = (xcol(idx, i) for i in range(6))
    gy0, gy1, iy0, iy1 = (ycol(idx, 6 * ow4, i) for i in range(4))
    ga0, ga1, itx = (xcol(wt, i) for i in range(3))
    gb0, gb1, ity = (ycol(wt, 3 * ow4, i) for i in range(3))
    full = ow // 4 * 4  # columns of whole groups: one 16-byte store a row
    out = np.full((n, oh, ow), np.nan, np.float32)
    for m in range(n):
        g, c = divmod(m, group)
        cs = min(group, n - group * g)
        ipp = cs in (1, 3, 4)
        if fault == 3 and g == 0:
            ipp = not ipp
        s = src[m]
        if ipp:
            b = np.zeros(ow4, np.int32) if fault == 2 else border
            twice = ((b == 1) & (cs == 3) & (c < 2)) | ((b != 0) & (cs == 4))
            y0s, y1s = iy0, iy1

            def hrow(y):
                p, q = s[y][ix0], s[y][ix1]
                return _fma32(itx, q - p, p)

            def vert(pa, pb, y):
                d = pb - pa
                return np.where(twice, pa + ity[y] * d, _fma32(ity[y], d, pa))
        else:
            y0s, y1s = gy0, gy1

            def hrow(y):
                r = s[y][gx0] * ga0 + s[y][gx1] * ga1
                return np.where(copy != 0, s[y][gx0], r)

            def vert(pa, pb, y):
                return pa * gb0[y] + pb * gb1[y]
        area = not ipp and 2 * ow == w and 2 * oh == h
        for ybeg in range(0, oh, rows):
            ca = cb = -1
            for y in range(ybeg, min(ybeg + rows, oh)):
                if area:
                    r0, r1 = s[2 * y], s[2 * y + 1]
                    v = (((r0[0::2] + r0[1::2]) + r1[0::2]) + r1[1::2]) * np.float32(0.25)
                else:
                    y0, y1 = y0s[y], y1s[y]
                    if y0 != ca:
                        if y0 == cb:
                            if fault != 4:
                                pa = pb
                        else:
                            pa = hrow(y0)
                        ca = y0
                    if y1 != cb:
                        pb = pa if y1 == y0 else hrow(y1)
                        cb = y1
                    v = vert(pa, pb, y)
                out[m, y, :full] = v[:full]
                for x in range(full, ow):
                    out[m, y, x] = v[x]
    return out


@pytest.mark.parametrize("n,group,in_hw,out_hw", [
    (1, 128, (32, 32), (64, 640)),  # IPP, one channel
    (3, 128, (32, 32), (64, 640)),  # IPP border rule at 3 channels (10 clamped a side)
    (4, 128, (32, 32), (48, 1100)),  # at 4 channels, a full block of 16 and a remainder
    (2, 128, (40, 36), (90, 130)),  # generic
    (6, 128, (32, 32), (16, 16)),  # generic at an exact 2x downscale: INTER_AREA
    (131, 128, (16, 12), (20, 30)),  # 128 generic + 3 IPP
    (3, 1, (32, 32), (64, 640)),  # one mask a call: three IPP calls of one channel
    (4, 128, (32, 32), (37, 854)),  # IPP, W % 4 == 2 (480p's 854), H not a multiple of a tile
    (2, 128, (40, 36), (33, 131)),  # generic, W % 4 == 3, H % 32 == 1
    (2, 128, (26, 38), (13, 19)),  # INTER_AREA, W % 4 == 3
    (129, 128, (16, 12), (40, 30)),  # 128 generic + 1 IPP
    (132, 128, (16, 12), (40, 30)),  # 128 generic + 4 IPP (its border rule)
], ids=str)
@pytest.mark.parametrize("rows", [8, 32])
def test_kernel_taps_give_the_plain_version(n, group, in_hw, out_hw, rows):
    src = _logits((n,) + in_hw, n)
    want = misc.resize_masks_np(src, out_hw, group)
    assert_same_bits(_kernel_mirror(src, out_hw, group, rows=rows), want)
    if group == 1:
        assert_same_bits(want, np.concatenate(
            [jax_misc.resize_masks_np(src[i:i + 1], out_hw) for i in range(n)]))


def test_kernel_mirror_planted_faults_change_the_bits():
    """The faults chip_smoke plants in the kernel, mirrored: each must
    change the bits at the case that reaches it. And one cv2 call a mask
    (group 1) is not one call for all."""
    src = _logits((4, 32, 32), 0)
    assert not np.array_equal(_kernel_mirror(src, (48, 1100), fault=2),
                              misc.resize_masks_np(src, (48, 1100)))
    src = _logits((2, 40, 36), 1)
    assert not np.array_equal(_kernel_mirror(src, (90, 130), fault=3),
                              misc.resize_masks_np(src, (90, 130)))
    assert not np.array_equal(misc.resize_masks_np(src, (90, 130), 1),
                              misc.resize_masks_np(src, (90, 130)))
    # a stale row cache: on the IPP and the generic path, in every tile
    # height the kernel takes
    for n in (4, 2):
        src = _logits((n, 32, 32), 2)
        want = misc.resize_masks_np(src, (37, 854))
        for rows in (8, 16, 32):
            bad = _kernel_mirror(src, (37, 854), fault=4, rows=rows)
            assert not np.array_equal(bad, want), (n, rows)


@pytest.mark.parametrize("n,oh,ow,sms,rows", [
    (4, 2160, 3840, 132, 16),  # 259200 threads at 32 rows: below one wave of 270336
    (192, 720, 1280, 132, 32),
    (192, 1024, 1024, 132, 32),
    (4, 1080, 1920, 132, 8),
    (1, 720, 1280, 132, 8),  # small: the least tile
    (1, 720, 1280, 1, 32),  # one SM: full tiles
    (1, 65535 * 8 + 1, 4, 10 ** 6, 9),  # at least the rows that keep grid.y <= 65535
])
def test_row_tile(n, oh, ow, sms, rows):
    assert mask_resize.row_tile(n, oh, ow, sms) == rows


def test_check_launch_refuses_what_the_kernel_does_not_take():
    """The kernel's limits, at the edge and one past it: masks are grid.z
    (<= 65535), tiles of at most 32 rows are grid.y (<= 65535), the taps'
    offsets are int32, and no size is empty. The wrapper checks before any
    launch and never falls back to the host."""
    ok = mask_resize.check_launch
    ok(65535, (256, 256), (720, 1280))
    ok(1, (256, 256), (65535 * 32, 4))
    ok(1, (1, 1), (1, 1))
    ow_max = (2 ** 31 - 1 - 4 * 8) // 6 // 4 * 4
    ok(1, (4, 4), (8, ow_max))
    for n, in_hw, out_hw in [(65536, (256, 256), (720, 1280)), (0, (256, 256), (720, 1280)),
                             (1, (256, 256), (65535 * 32 + 1, 4)),
                             (1, (0, 256), (720, 1280)), (1, (256, 256), (720, 0)),
                             (1, (4, 4), (8, ow_max + 4))]:
        with pytest.raises(ValueError, match="mask_resize"):
            ok(n, in_hw, out_hw)
    with pytest.raises(ValueError, match="channels"):
        mask_resize.resize_masks_cv2(torch.zeros(1, 4, 4), (8, 8), group=129)


def test_resize_masks_cv2_on_the_cpu_is_the_plain_version():
    x = torch.from_numpy(_logits((2, 3, 32, 32), 5))
    got = mask_resize.resize_masks_cv2(x, (70, 90))
    assert got.shape == (2, 3, 70, 90) and got.dtype == torch.float32
    assert_same_bits(got.numpy(), misc.resize_masks_np(x.numpy(), (70, 90)))
    xb = x.to(torch.bfloat16)
    assert_same_bits(mask_resize.resize_masks_cv2(xb, (70, 90)).numpy(),
                     jax_misc.resize_masks_np(xb.float().numpy(), (70, 90)))
    assert mask_resize.resize_masks_cv2(x, (32, 32)) is x
    with pytest.raises(ValueError):
        mask_resize.resize_masks_cv2(x, (70, 90), fault=1)


# ---------------------------------------------------------------------------
# the predictors' masks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine():
    return make_engines()[1]


def test_video_predictor_masks_equal_jax_cv2_resize(engine, monkeypatch):
    """Every video-resolution mask of a session equals what the JAX
    predictor computes from the same low-res logits with cv2: each frame
    propagate_in_video yields (1, 2 or 4 object slots in one resize,
    forward and reverse) and each object's row of a prompt call's
    consolidated frame (one resize a row)."""
    resizes, frames = [], []
    resize, video_res = SAM2VideoPredictor._resize, SAM2VideoPredictor._video_res_masks

    def spy_resize(self, masks, hw, **kw):
        out = resize(self, masks, hw, **kw)
        resizes.append((np.array(masks), hw, kw.get("group", 128), out))
        return out

    def spy_video_res(self, session, masks_np):
        out = video_res(self, session, masks_np)
        frames.append((np.array(masks_np), out))
        return out

    monkeypatch.setattr(SAM2VideoPredictor, "_resize", spy_resize)
    monkeypatch.setattr(SAM2VideoPredictor, "_video_res_masks", spy_video_res)
    rec = drive_tracking(SAM2VideoPredictor(engine))
    yielded = [m for step in ("box1", "prop1", "box2", "prop2", "click3", "prop3")
               for _, _, m in rec[step]]
    assert len(yielded) == 3 + 6 + 6 + 6 and len(frames) == len(yielded)
    for (low, out), m in zip(frames, yielded):
        assert m is out and m.shape == (low.shape[0], 1, H, W)
        # JAX's _video_res_masks: resize_masks_np of the frame's rows (a
        # prompt call's frame is consolidated at video size already)
        assert_same_bits(m, jax_misc.resize_masks_np(low, (H, W)))
    groups = [g for _, _, g, _ in resizes]
    assert groups.count(1) == 3 and groups.count(128) == 18
    assert {low.shape[0] for low, _, g, _ in resizes if g == 128} == {1, 2, 4}
    for low, hw, g, out in resizes:
        assert hw == (H, W)
        if g == 1:  # JAX's _consolidate: resize_masks_np of each object's row
            want = np.stack([jax_misc.resize_masks_np(m[None], hw)[0] for m in low])
        else:
            want = jax_misc.resize_masks_np(low, hw)
        assert_same_bits(out, want)


def _jax_postprocess(low_res, orig_hw, hole=0.0):
    """JAX's SAM2ImagePredictor._postprocess (its cv2 resize) on these
    logits, with its cleanup settings."""
    p = jax_ip.SAM2ImagePredictor.__new__(jax_ip.SAM2ImagePredictor)
    p._orig_hw, p.mask_threshold = orig_hw, 0.0
    p.max_hole_area = p.max_sprinkle_area = hole
    return p._postprocess(low_res, return_logits=True)


IMAGE_CALLS = {
    "box, 3 masks": dict(box=np.asarray([10.0, 8.0, 70.0, 60.0])),
    "click, 1 mask": dict(point_coords=np.asarray([[40.0, 50.0]]), point_labels=np.asarray([1]),
                          multimask_output=False),
    "two boxes, 6 masks": dict(box=np.asarray([[10.0, 8.0, 70.0, 60.0], [50, 40, 110, 95]])),
}


@pytest.mark.parametrize("hole", [0.0, 6.0])
@pytest.mark.parametrize("name", list(IMAGE_CALLS))
def test_image_predictor_masks_equal_jax_cv2_resize(engine, name, hole):
    pred = SAM2ImagePredictor(engine, max_hole_area=hole, max_sprinkle_area=hole)
    pred.set_image(make_frames(1, 96, 112, seed=3)[0])
    masks, _, low = pred.predict(return_logits=True, **IMAGE_CALLS[name])
    assert masks.shape[-2:] == (96, 112) and masks.dtype == np.float32
    assert_same_bits(masks, _jax_postprocess(low, (96, 112), hole))


def test_image_predictor_batch_of_64_prompts_resizes_in_two_chunks(engine):
    """The AMG's batch: 64 points x 3 masks = 192 channels, 128 + 64, both
    on cv2's generic path."""
    pred = SAM2ImagePredictor(engine)
    pred.set_image(make_frames(1, 96, 112, seed=4)[0])
    pts = np.random.default_rng(0).uniform(0, 96, (64, 1, 2)).astype(np.float32)
    masks, _, low = pred.predict_batch(pts, np.ones((64, 1), np.int32), return_logits=True)
    assert masks.shape == (64, 3, 96, 112)
    assert_same_bits(masks, _jax_postprocess(low, (96, 112)))
