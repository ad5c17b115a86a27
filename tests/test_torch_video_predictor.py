"""The port's SAM2VideoPredictor vs the JAX package's, on the same calls.

Both predictors run on the CPU with the same weights (tiny_test_config(
fill_hole_area=8, max_objects=4), the object-score bias raised to +1 as in
tests/test_torch_engine.py), fp32 with TF32 off, memory attention in gather
mode. The session: frames at model size with a declared non-square video of
96x112 (so point normalisation and the video-res resize run), a box, forward
propagation (the window path), update_state with 96x112 frames, a new object
after tracking has started (1 -> 2 slots, re-consolidation), a click on a
tracked frame for a third object (2 -> 4 slots), reverse propagation. Every
yielded mask, the output stores, the bookkeeping and the bank are compared
after each step.

update_state's frames are resized on the host; JAX's loader resizes with cv2,
and both packages' loaders are handed the port's prepare_frame here (cv2's
arithmetic in numpy, equal to it bit for bit: test_torch_frame_prep.py), so
the model sees the same pixels.

The helpers below are shared with test_torch_video_predictor_prompts.py and
test_torch_video_predictor_memory.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import det_sam2_tpu.utils.misc as jax_misc
from det_sam2_tpu.configs import tiny_test_config as jax_tiny_config
from det_sam2_tpu.track import SAM2Engine as JaxEngine
from det_sam2_tpu.video_predictor import SAM2VideoPredictor as JaxPredictor

from det_sam2_tpu_torch import convert
from det_sam2_tpu_torch.configs import tiny_test_config
from det_sam2_tpu_torch.track import SAM2Engine
from det_sam2_tpu_torch.utils import misc
from det_sam2_tpu_torch.video_predictor import SAM2VideoPredictor

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ATOL = 2e-3  # logits and pointers (tests/test_torch_engine.py)
MASK_TOL = dict(atol=2e-3, rtol=2 ** -10)  # fp16-stored mask logits
MIN_IOU = 0.999  # binary masks, wherever the union is non-empty
KW = dict(fill_hole_area=8, max_objects=4)
H, W = 96, 112  # the declared video size
BANK_FLOAT = ("cond_mem", "cond_ptr", "noncond_mem", "noncond_ptr")
BANK_EXACT = ("cond_frame_idx", "cond_pinned", "cond_obj_valid",
              "noncond_frame_idx", "noncond_obj_valid")


def make_engines(**kw):
    """(JAX engine, port engine) with the same seeded weights, the
    object-score head's output bias at +1 so objects count as present."""
    kw = dict(KW, **kw)
    jeng = JaxEngine(jax_tiny_config(**kw), seed=11)
    params = jax.tree_util.tree_map(np.array, jeng.params)
    params["sam_mask_decoder"]["pred_obj_score_head"]["layers_2"]["bias"][:] = 1.0
    jeng.params = jax.tree_util.tree_map(jnp.asarray, params)
    eng = SAM2Engine(tiny_test_config(**kw), params=convert.from_jax_params(params),
                     device="cpu")
    return jeng, eng


def make_frames(n, h, w, seed=0, start=0):
    """Seeded noise frames [n, h, w, 3] uint8 with two bright rectangles
    moving over the clip."""
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 90, (n, h, w, 3), np.uint8)
    for i in range(n):
        t = start + i
        y, x = (h * (10 + 2 * t)) // 128, (w * (8 + 3 * t)) // 128
        f[i, y:y + h // 3, x:x + w // 3] = (230, 60, 50)
        y, x = (h * (70 - 2 * t)) // 128, (w * (60 + t)) // 128
        f[i, y:y + h // 4, x:x + w // 4] = (40, 200, 220)
    return f


def summary(s) -> dict:
    """A copy of a session's state in numpy: output stores, bookkeeping,
    bank (the port's bank is updated in place, so it is copied now)."""

    def store(d):
        return {t: {k: np.array(v) for k, v in out.items()} for t, out in d.items()}

    bank = None
    if s.bank is not None:
        bank = {f: np.array(getattr(s.bank, f)) for f in BANK_FLOAT + BANK_EXACT}
        bank["attend_cond_tiles"] = s.bank.attend_cond_tiles
    return dict(
        cond=store(s.cond_outputs), noncond=store(s.noncond_outputs), bank=bank,
        bank_objs=s.bank_objs, obj_ids=list(s.obj_ids),
        obj_idx_to_id=dict(s.obj_idx_to_id),
        tracked={k: dict(v) for k, v in s.frames_already_tracked.items()},
        ranges=[tuple(r) for r in s.tracked_ranges],
        consolidated=sorted(s.consolidated_noncond),
        frames=sorted(s.frames.keys()), frames_dev=sorted(s.frames_dev.keys()),
        num_frames=s.num_frames, video_hw=(s.video_height, s.video_width),
        pre_frames=s.pre_frames, preload=list(s.preload_cond_indices),
        started=s.tracking_has_started,
        temp=sorted((o, t) for d in (s.temp_cond, s.temp_noncond)
                    for o, per in d.items() for t in per),
    )


def assert_masks_close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    np.testing.assert_allclose(got, want, **MASK_TOL, err_msg=what)
    for o in range(got.shape[0]):
        a, b = got[o] > 0, want[o] > 0
        union = np.logical_or(a, b).sum()
        if union:
            iou = np.logical_and(a, b).sum() / union
            assert iou >= MIN_IOU, f"{what}: object row {o} IoU {iou}"


def assert_yields_close(got, want, what):
    assert [(f, ids) for f, ids, _ in got] == [(f, ids) for f, ids, _ in want], what
    for (f, _, g), (_, _, w) in zip(got, want):
        assert_masks_close(g, w, f"{what}, frame {f}")


def assert_summaries_close(got, want, what):
    for k in got:
        if k in ("cond", "noncond", "bank"):
            continue
        assert got[k] == want[k], f"{what}: {k} {got[k]} vs {want[k]}"
    for k in ("cond", "noncond"):
        assert sorted(got[k]) == sorted(want[k]), f"{what}: {k} frames"
        for t, out in want[k].items():
            g = got[k][t]
            assert_masks_close(g["pred_masks"], out["pred_masks"], f"{what}: {k}[{t}]")
            assert g["pred_masks"].dtype == np.float16
            for f in ("obj_ptr", "object_score_logits"):
                np.testing.assert_allclose(g[f], out[f], atol=ATOL,
                                           err_msg=f"{what}: {k}[{t}] {f}")
            np.testing.assert_array_equal(g["valid"], out["valid"])
    if want["bank"] is None:
        assert got["bank"] is None, what
        return
    assert got["bank"]["attend_cond_tiles"] == want["bank"]["attend_cond_tiles"], what
    for f in BANK_EXACT:
        np.testing.assert_array_equal(got["bank"][f], want["bank"][f],
                                      err_msg=f"{what}: bank {f}")
    for f in BANK_FLOAT:
        np.testing.assert_allclose(got["bank"][f], want["bank"][f], atol=ATOL,
                                   err_msg=f"{what}: bank {f}")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side runs tiny tensors: one intra-op thread a process
    keeps parallel test workers from oversubscribing the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def shared_loader():
    """Both packages' frame loaders resize with the port's prepare_frame."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_misc, "prepare_frame", misc.prepare_frame)
        yield


# ---------------------------------------------------------------------------
# the tracking session
# ---------------------------------------------------------------------------

BOX1 = [10.0, 8.0, 50.0, 40.0]  # video pixels (x0, y0, x1, y1)
BOX2 = [60.0, 40.0, 100.0, 80.0]
CLICK3 = [[30.0, 70.0]]


def drive_tracking(vp):
    model_frames = make_frames(6, 128, 128)
    video_frames = make_frames(6, H, W, seed=1, start=6)
    rec = {}
    s = vp.init_state(list(model_frames), video_height=H, video_width=W)
    rec["init"] = summary(s)
    rec["box1"] = [vp.add_new_points_or_box(s, 0, 1, box=BOX1)]
    rec["after_box1"] = summary(s)
    rec["prop1"] = list(vp.propagate_in_video(s))
    rec["after_prop1"] = summary(s)
    vp.update_state(video_frames, s)
    # a new object after tracking has started: 1 -> 2 slots, frame 0
    # re-consolidated (with the empty-mask pointer for the new row)
    rec["box2"] = [vp.add_new_points_or_box(s, 6, 2, box=BOX2)]
    rec["after_box2"] = summary(s)
    rec["prop2"] = list(vp.propagate_in_video(s, start_frame_idx=6))
    rec["after_prop2"] = summary(s)
    # a click for a third object on a tracked frame: 2 -> 4 slots, a
    # memory-conditioned prompt, a non-cond correction
    rec["click3"] = [vp.add_new_points_or_box(s, 9, 3, points=CLICK3, labels=[1])]
    rec["after_click3"] = summary(s)
    rec["prop3"] = list(vp.propagate_in_video(s, start_frame_idx=9,
                                              max_frame_num_to_track=6, reverse=True))
    rec["final"] = summary(s)
    return rec


@pytest.fixture(scope="module")
def tracking(shared_loader):
    jeng, eng = make_engines()
    return drive_tracking(SAM2VideoPredictor(eng)), drive_tracking(JaxPredictor(jeng))


@pytest.mark.parametrize("step", ["box1", "prop1", "box2", "prop2", "click3", "prop3"])
def test_yielded_masks_match_jax(tracking, step):
    got, want = tracking
    assert_yields_close(got[step], want[step], step)
    for _, ids, m in got[step]:
        assert m.shape[-2:] == (H, W) and np.isfinite(m).all()


@pytest.mark.parametrize("point", ["init", "after_box1", "after_prop1", "after_box2",
                                   "after_prop2", "after_click3", "final"])
def test_session_state_matches_jax(tracking, point):
    got, want = tracking
    assert_summaries_close(got[point], want[point], point)


def test_session_went_where_it_should(tracking):
    """The path the session took, beyond agreeing with JAX: slot growth,
    the cond bucket, skips reused, objects present."""
    got, _ = tracking
    assert [got[p]["bank_objs"] for p in ("after_box1", "after_box2", "after_click3")] \
        == [1, 2, 4]
    assert got["after_prop2"]["bank"]["attend_cond_tiles"] == 2  # cond frames 0, 6
    assert [f for f, _, _ in got["prop1"]] == list(range(6))
    assert [f for f, _, _ in got["prop3"]] == [9, 8, 7, 6, 5, 4]
    assert got["final"]["consolidated"] == [9]  # the click is a non-cond correction
    assert sorted(got["final"]["cond"]) == [0, 6]
    assert got["final"]["video_hw"] == (H, W) and got["final"]["num_frames"] == 12
    for step in ("prop1", "prop2", "prop3"):  # some foreground on every frame
        assert all((m > 0).any() for _, _, m in got[step]), step
