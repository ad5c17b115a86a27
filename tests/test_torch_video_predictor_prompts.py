"""The port's SAM2VideoPredictor vs the JAX package's: mask prompts and the
removal of prompts and objects.

Same weights and settings as test_torch_video_predictor.py (whose helpers
this file uses). The session: boxes for two objects on frame 0, a 96x112
mask (not model size: resized with antialias, then thresholded) for the
second object on an untracked frame, propagation over both cond frames,
clear_all_prompts_in_frame demoting that mask's frame to a non-cond frame,
remove_object, a new object reusing the freed slot through a correction on a
tracked frame, propagation again, then clear_all_prompts_in_frame on the last
cond frame, which resets every tracking result, a fresh prompt after the
reset, and reset_state.
"""

import numpy as np
import pytest

from det_sam2_tpu.video_predictor import SAM2VideoPredictor as JaxPredictor

from det_sam2_tpu_torch.video_predictor import SAM2VideoPredictor

from test_torch_video_predictor import (
    assert_summaries_close,
    assert_yields_close,
    make_engines,
    make_frames,
    one_torch_thread,  # noqa: F401 (an autouse fixture)
    summary,
)

MASK = np.zeros((96, 112), bool)
MASK[30:70, 50:100] = True


def drive_prompts(vp):
    frames = make_frames(8, 128, 128, seed=2)
    rec = {}
    s = vp.init_state(list(frames))
    rec["box1"] = [vp.add_new_points_or_box(s, 0, 1, box=[10, 10, 60, 50])]
    rec["box2"] = [vp.add_new_points_or_box(s, 0, 2, box=[70, 60, 120, 110])]
    rec["mask2"] = [vp.add_new_mask(s, 4, 2, MASK)]  # an untracked frame: cond
    rec["mask_input"] = np.array(s.mask_inputs_per_obj[1][4])
    rec["after_mask2"] = summary(s)
    rec["prop1"] = list(vp.propagate_in_video(s))
    rec["after_prop1"] = summary(s)
    vp.clear_all_prompts_in_frame(s, 4, 2)  # demotes frame 4
    rec["after_demote"] = summary(s)
    vp.remove_object(s, 1)
    rec["after_remove"] = summary(s)
    # object 3 takes the freed slot 0, with a box on a tracked frame
    rec["box3"] = [vp.add_new_points_or_box(s, 2, 3, box=[20, 20, 70, 60])]
    rec["after_box3"] = summary(s)
    rec["prop2"] = list(vp.propagate_in_video(s, start_frame_idx=0))
    rec["after_prop2"] = summary(s)
    # frame 0 holds the last cond frame: clearing it resets the tracking
    vp.clear_all_prompts_in_frame(s, 0, 2)
    rec["after_reset"] = summary(s)
    rec["box4"] = [vp.add_new_points_or_box(s, 3, 3, box=[30, 30, 90, 80])]
    rec["after_box4"] = summary(s)
    vp.reset_state(s)  # everything but the frames
    rec["after_reset_state"] = summary(s)
    return rec


@pytest.fixture(scope="module")
def prompts():
    jeng, eng = make_engines()
    return drive_prompts(SAM2VideoPredictor(eng)), drive_prompts(JaxPredictor(jeng))


@pytest.mark.parametrize("step", ["box1", "box2", "mask2", "prop1", "box3", "prop2",
                                  "box4"])
def test_yielded_masks_match_jax(prompts, step):
    got, want = prompts
    assert_yields_close(got[step], want[step], step)


@pytest.mark.parametrize("point", ["after_mask2", "after_prop1", "after_demote",
                                   "after_remove", "after_box3", "after_prop2",
                                   "after_reset", "after_box4", "after_reset_state"])
def test_session_state_matches_jax(prompts, point):
    got, want = prompts
    assert_summaries_close(got[point], want[point], point)


def test_mask_prompt_resize_matches_jax(prompts):
    """The 96x112 mask resized to model size with antialias and thresholded
    (the port's F.interpolate, JAX's torch-exact weight matrices)."""
    got, want = prompts
    assert got["mask_input"].shape == (1, 128, 128, 1)
    np.testing.assert_array_equal(got["mask_input"], want["mask_input"])
    assert 0.1 < got["mask_input"].mean() < 0.5


def test_demotion_removal_and_reset(prompts):
    got, _ = prompts
    assert sorted(got["after_prop1"]["cond"]) == [0, 4]
    d = got["after_demote"]
    assert sorted(d["cond"]) == [0] and 4 in d["noncond"] and 4 not in d["tracked"]
    assert 4 in d["bank"]["noncond_frame_idx"] and 4 not in d["bank"]["cond_frame_idx"]
    assert d["bank"]["attend_cond_tiles"] == 1
    r = got["after_remove"]
    assert r["obj_ids"] == [2] and not r["bank"]["cond_obj_valid"][:, 0].any()
    assert got["after_box3"]["obj_idx_to_id"] == {0: 3, 1: 2}  # the slot reused
    assert got["after_box3"]["bank_objs"] == 2
    z = got["after_reset"]
    assert not z["cond"] and not z["noncond"] and not z["tracked"] and not z["started"]
    assert z["obj_ids"] == [2, 3] and (z["bank"]["cond_frame_idx"] == -1).all()
    assert sorted(got["after_box4"]["temp"]) == [(0, 3)]
    r = got["after_reset_state"]
    assert r["bank"] is None and not r["obj_ids"] and r["frames"] == list(range(8))
