"""The port's SAM2VideoPredictor vs the JAX package's: the preload memory
bank, release_old_frames and the per-frame path; then the port's banked mode
against its gather mode, the utils/misc copies and the builder.

Same weights and settings as test_torch_video_predictor.py (whose helpers
this file uses). The preload session: a box, propagation, save_session,
load_session_as_preload (its cond frame pinned), update_state with new
frames, propagation on the preload memory, release_old_frames with the
session's preload frame count and with an explicit pre_frames, and more
propagation. The per-frame path: clear_non_cond_mem_around_input=True, two
objects, mask_resize="device". Then _video_res_masks in both resize modes,
with and without non_overlap_masks.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import det_sam2_tpu.utils.misc as jax_misc
from det_sam2_tpu import build as jax_build
from det_sam2_tpu.convert import save_params_npz
from det_sam2_tpu.video_predictor import InferenceSession as JaxSession
from det_sam2_tpu.video_predictor import SAM2VideoPredictor as JaxPredictor

from det_sam2_tpu_torch import build, convert
from det_sam2_tpu_torch.configs import tiny_test_config
from det_sam2_tpu_torch.track import SAM2Engine
from det_sam2_tpu_torch.utils import misc
from det_sam2_tpu_torch.video_predictor import InferenceSession, SAM2VideoPredictor

from test_torch_video_predictor import (
    KW,
    assert_summaries_close,
    assert_yields_close,
    drive_tracking,
    make_engines,
    make_frames,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    summary,
)


def drive_preload(vp, path):
    rec = {}
    s = vp.init_state(list(make_frames(6, 128, 128, seed=3)))
    vp.add_new_points_or_box(s, 0, 1, box=[12, 20, 70, 64])
    rec["prop1"] = list(vp.propagate_in_video(s))
    vp.save_session(s, path)
    s2 = vp.load_session_as_preload(path)
    rec["loaded"] = summary(s2)
    vp.update_state(list(make_frames(8, 128, 128, seed=4, start=6)), s2)
    rec["prop2"] = list(vp.propagate_in_video(s2, start_frame_idx=6))
    rec["after_prop2"] = summary(s2)
    vp.release_old_frames(s2, 13, 4, release_images=True)  # pre_frames = 6
    rec["after_release"] = summary(s2)
    vp.release_old_frames(s2, 13, 2, pre_frames=3)
    rec["after_release_pre3"] = summary(s2)
    rec["prop3"] = list(vp.propagate_in_video(s2, start_frame_idx=12))
    rec["final"] = summary(s2)
    return rec


def drive_per_frame(vp):
    rec = {}
    s = vp.init_state(list(make_frames(6, 128, 128, seed=5)))
    rec["box1"] = [vp.add_new_points_or_box(s, 0, 1, box=[12, 20, 70, 64])]
    rec["box2"] = [vp.add_new_points_or_box(s, 0, 2, box=[50, 60, 110, 120])]
    rec["click1"] = [vp.add_new_points_or_box(s, 3, 1, points=[[40.0, 44.0]],
                                              labels=[1])]
    rec["prop"] = list(vp.propagate_in_video(s))
    rec["final"] = summary(s)
    return rec


@pytest.fixture(scope="module")
def engines():
    return make_engines()


@pytest.fixture(scope="module")
def preload(engines, tmp_path_factory):
    jeng, eng = engines
    d = tmp_path_factory.mktemp("sessions")
    return (drive_preload(SAM2VideoPredictor(eng), str(d / "port.pkl")),
            drive_preload(JaxPredictor(jeng), str(d / "jax.pkl")))


@pytest.fixture(scope="module")
def per_frame(engines):
    """Two objects on the per-frame path, masks resized on the device."""
    jeng, eng = engines
    kw = dict(clear_non_cond_mem_around_input=True, clear_non_cond_mem_for_multi_obj=True,
              mask_resize="device")
    return (drive_per_frame(SAM2VideoPredictor(eng, **kw)),
            drive_per_frame(JaxPredictor(jeng, **kw)))


@pytest.mark.parametrize("step", ["prop1", "prop2", "prop3"])
def test_preload_yields_match_jax(preload, step):
    got, want = preload
    assert_yields_close(got[step], want[step], step)


@pytest.mark.parametrize("point", ["loaded", "after_prop2", "after_release",
                                   "after_release_pre3", "final"])
def test_preload_state_matches_jax(preload, point):
    got, want = preload
    assert_summaries_close(got[point], want[point], point)


def test_preload_pins_and_release_keeps_them(preload):
    got, _ = preload
    lo = got["loaded"]
    assert lo["pre_frames"] == 6 and lo["preload"] == [0] and lo["started"]
    assert lo["bank"]["cond_pinned"][lo["bank"]["cond_frame_idx"] == 0].all()
    r = got["after_release"]  # drops 5 < idx <= 9
    assert r["frames"] == [0, 1, 2, 3, 4, 5, 10, 11, 12, 13]
    assert not [t for t in r["noncond"] if 5 < t <= 9]
    bank_frames = r["bank"]["noncond_frame_idx"]
    assert not [t for t in bank_frames if 0 <= t < 10]
    assert 0 in r["bank"]["cond_frame_idx"]  # the pinned preload frame
    r3 = got["after_release_pre3"]  # drops 2 < idx <= 11 from the outputs
    assert sorted(r3["noncond"]) == [1, 2, 12, 13] and r3["frames"] == r["frames"]
    assert [f for f, _, _ in got["prop3"]] == [12, 13]


@pytest.mark.parametrize("what", ["box1", "box2", "click1", "prop", "final"])
def test_per_frame_path_matches_jax(per_frame, what):
    got, want = per_frame
    if what == "final":
        assert_summaries_close(got["final"], want["final"], "per-frame final")
        return
    assert_yields_close(got[what], want[what], f"per-frame {what}")
    if what == "prop":
        assert [f for f, _, _ in got["prop"]] == list(range(6))


@pytest.mark.parametrize("mask_resize", ["host", "device"])
@pytest.mark.parametrize("non_overlap", [False, True], ids=["overlap", "non-overlap"])
def test_video_res_masks_match_jax(engines, mask_resize, non_overlap):
    """Low-res logits of 3 objects -> the 96x112 video, resized on the host or
    on the device, with or without the non-overlap constraint (the argmax
    object keeps its logits, the others are clamped to <= -10). Seeded
    logits well apart: the session's near-equal random-weight logits would
    make the argmax a coin toss at a few pixels."""
    jeng, eng = engines
    logits = np.random.default_rng(4).standard_normal((3, 1, 32, 32)).astype(np.float32) * 8
    got, want = (
        cls(e, mask_resize=mask_resize, non_overlap_masks=non_overlap)._video_res_masks(
            sess(e.cfg, 96, 112), logits)
        for cls, e, sess in ((SAM2VideoPredictor, eng, InferenceSession),
                             (JaxPredictor, jeng, JaxSession)))
    assert got.shape == (3, 1, 96, 112)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    if non_overlap:
        assert ((got > 0).sum(0) <= 1).all() and (got.max(0) > 0).any()


# ---------------------------------------------------------------------------
# the port's banked mode against its gather mode
# ---------------------------------------------------------------------------


def test_banked_predictor_matches_gather_predictor(engines):
    _, eng = engines
    cfg = tiny_test_config(**dict(KW, max_obj_ptrs_in_encoder=8))
    sd = eng.model.state_dict()
    runs = {}
    for banked in (False, True):
        e = SAM2Engine(cfg, params=sd, device="cpu", banked=banked)
        assert e.banked_layers == (cfg.memory_attention.num_layers if banked else 0)
        runs[banked] = drive_tracking(SAM2VideoPredictor(e))
    for step in ("box1", "prop1", "box2", "prop2", "click3", "prop3"):
        assert_yields_close(runs[True][step], runs[False][step], f"banked {step}")
    assert_summaries_close(runs[True]["final"], runs[False]["final"], "banked final")


# ---------------------------------------------------------------------------
# utils/misc: the port's copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src, dst", [(32, (96, 112)), (32, (1280, 720)), (256, (20, 24)),
                                      (7, (5, 9))])
def test_resize_masks_np_matches_jax(src, dst):
    """JAX's resize_masks_np with cv2 present (cv2 is installed here): the
    port rebuilds cv2's arithmetic, so equal bit for bit (6 masks: cv2's
    generic float path)."""
    assert jax_misc.cv2 is not None
    masks = np.random.default_rng(0).standard_normal((2, 3, 1, src, src)).astype(np.float32)
    got = misc.resize_masks_np(masks, dst)
    assert got.shape == (2, 3, 1) + dst
    np.testing.assert_array_equal(got, jax_misc.resize_masks_np(masks, dst))
    # and close to F.interpolate's bilinear, which computes nearly the same
    # function (the JAX package's device path)
    ref = torch.nn.functional.interpolate(torch.from_numpy(masks).reshape(-1, 1, src, src),
                                          size=dst, mode="bilinear", align_corners=False)
    np.testing.assert_allclose(got.reshape(ref.shape), ref.numpy(), atol=1e-4)


def test_concat_points_matches_jax():
    rng = np.random.default_rng(0)
    p1, l1 = rng.random((1, 2, 2)).astype(np.float32), np.asarray([[2, 3]], np.int32)
    p2, l2 = rng.random((1, 1, 2)).astype(np.float32), np.asarray([[1]], np.int32)
    for old in (None, {"point_coords": p1, "point_labels": l1}):
        got, want = misc.concat_points(old, p2, l2), jax_misc.concat_points(old, p2, l2)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def _frames_dir(tmp_path, frames):
    Image = pytest.importorskip("PIL.Image")
    for i, f in enumerate(frames):
        Image.fromarray(f).save(tmp_path / f"{i}.png")
    return str(tmp_path)


def test_load_video_frames_matches_jax(tmp_path):
    frames = make_frames(3, 128, 128, seed=6)
    d = _frames_dir(tmp_path, frames)
    for src in (frames, list(frames), d, [os.path.join(d, f"{i}.png") for i in range(3)]):
        got, gh, gw = misc.load_video_frames(src, 128)
        want, wh, ww = jax_misc.load_video_frames(src, 128)
        assert (gh, gw) == (wh, ww) == (128, 128)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == np.uint8
    assert misc.list_frame_dir(d) == jax_misc.list_frame_dir(d)
    loader, jloader = misc.AsyncFrameLoader(misc.list_frame_dir(d), 128), \
        jax_misc.AsyncFrameLoader(jax_misc.list_frame_dir(d), 128)
    for i in range(3):
        np.testing.assert_array_equal(loader[i], jloader[i])


@pytest.mark.parametrize("hw", [(96, 112), (300, 200), (256, 256), (720, 1280)])
def test_prepare_frame_equals_cv2(hw):
    cv2 = pytest.importorskip("cv2")
    frame = make_frames(1, *hw, seed=7)[0]
    got = misc.prepare_frame(frame, 128)
    want = cv2.resize(frame, (128, 128))
    assert got.shape == want.shape == (128, 128, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # float frames in [0, 1] and [0, 255] give the uint8 frame's result
    np.testing.assert_array_equal(misc.prepare_frame(frame.astype(np.float32), 128), got)
    np.testing.assert_array_equal(misc.prepare_frame(frame / 255.0, 128), got)
    # a model-size frame passes through unchanged
    np.testing.assert_array_equal(misc.prepare_frame(got, 128), got)


def test_async_init_state_matches_eager(engines, tmp_path):
    _, eng = engines
    d = _frames_dir(tmp_path, make_frames(4, 96, 112, seed=8))
    vp = SAM2VideoPredictor(eng)
    lazy, eager = vp.init_state(d, async_loading_frames=True), vp.init_state(d)
    assert (lazy.video_height, lazy.video_width) == (96, 112) == (
        eager.video_height, eager.video_width)
    assert sorted(lazy.frames) == sorted(eager.frames) == [0, 1, 2, 3]
    for i in range(4):
        np.testing.assert_array_equal(lazy.frames[i], eager.frames[i])


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def _short_session(vp):
    s = vp.init_state(list(make_frames(3, 128, 128, seed=9)))
    vp.add_new_points_or_box(s, 0, 1, box=[12, 20, 70, 64])
    return list(vp.propagate_in_video(s))


def test_build_video_predictor_from_pt_and_npz(engines, tmp_path):
    jeng, eng = engines
    cfg = eng.cfg
    want = _short_session(SAM2VideoPredictor(eng))
    pt, npz = str(tmp_path / "sam2.pt"), str(tmp_path / "params.npz")
    torch.save({"model": eng.model.state_dict()}, pt)
    save_params_npz(jeng.params, npz)
    for ckpt in (pt, npz):
        vp = build.build_sam2_video_predictor(cfg, ckpt, dtype=torch.float32, device="cpu")
        assert vp.engine.device.type == "cpu" and vp.engine.cfg == cfg
        got = _short_session(vp)
        for (f, ids, g), (_, _, w) in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=f"{ckpt} frame {f}")
    # the engine built from the JAX parameters holds the same weights
    ref = convert.from_jax_params(jeng.params)
    built = build.build_sam2_engine(cfg, npz, dtype=torch.float32, device="cpu")
    for k, v in built.model.state_dict().items():
        assert torch.equal(v, ref[k]), k


@pytest.mark.parametrize("model_cfg, overrides", [
    ("hiera_s", {}), ("facebook/sam2.1-hiera-base-plus", {}), ("sam2.1_hiera_l", {}),
    ("configs/sam2.1/hiera_t.yaml", {}), ("hiera_s", {"image_size": 768}),
    ("facebook/sam2.1-hiera-small", {"image_size": 512, "fill_hole_area": 0}),
])
def test_resolve_cfg_matches_jax(model_cfg, overrides):
    got = dataclasses.asdict(build._resolve_cfg(model_cfg, **dict(overrides)))
    want = dataclasses.asdict(jax_build._resolve_cfg(model_cfg, **dict(overrides)))
    assert got == want


def test_build_refuses_what_is_not_ported(engines, tmp_path):
    # reference YAMLs and the int8 trunk are ported (tests/test_torch_config_yaml.py,
    # tests/test_torch_quant.py); a YAML without a model tree or with a key
    # the reference builder does not know is refused
    yaml = tmp_path / "sam2.1_hiera_s.yaml"
    yaml.write_text("trainer: {}\n")
    with pytest.raises(ValueError, match="model"):
        build.build_sam2_engine(str(yaml), device="cpu")
    yaml.write_text("model:\n  image_size: 128\n  bogus: 1\n")
    with pytest.raises(ValueError, match="bogus"):
        build.build_sam2_engine(str(yaml), device="cpu")
    with pytest.raises(NotImplementedError, match="save_params_npz"):  # orbax dir
        build.build_sam2_engine(tiny_test_config(), str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="unknown model config"):
        build.build_sam2_engine("hiera_xl", device="cpu")
    if not torch.cuda.is_available():  # CUDA by default, no CPU fallback
        with pytest.raises(RuntimeError, match="CUDA"):
            build.build_sam2_video_predictor(tiny_test_config())
