"""The port's BatchedVideoStreamer / SAM2Engine.propagate_window_batched vs
the JAX package's, on the same calls.

Both packages run on the CPU with the same weights (tiny_test_config(
fill_hole_area=8, max_objects=4), the object-score bias raised to +1 as in
tests/test_torch_video_predictor.py), fp32 with TF32 off, in gather mode and
in banked mode (max_obj_ptrs_in_encoder=8; JAX with DET_SAM2_BANKED_ATTN=1,
its banked kernel in interpret mode). Two videos with 1 and 2 objects
(O_total = 3) prompted at different frames, so a window step skips for one
video only; same-frame prompts for two video subsets merged into one cond
slot; a step where every video skips. Tolerance: pointers and score logits
within ATOL, fp16 mask logits within MASK_TOL, mask signs equal on >= 0.999
of the pixels, integer bank fields equal (the packages read 4e-6 apart).
Then the port against itself: each video's rows against its own
single-video window, and a 1-video streamer bit-identical to the
single-video window.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from det_sam2_tpu.batched import BatchedVideoStreamer as JaxStreamer
from det_sam2_tpu.configs import tiny_test_config as jax_tiny_config
from det_sam2_tpu.track import SAM2Engine as JaxEngine

from det_sam2_tpu_torch import convert
from det_sam2_tpu_torch.batched import BatchedVideoStreamer
from det_sam2_tpu_torch.configs import tiny_test_config
from det_sam2_tpu_torch.state import cond_tile_bucket, init_bank
from det_sam2_tpu_torch.track import SAM2Engine

from test_torch_video_predictor import one_torch_thread  # noqa: F401 (autouse)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ATOL = 2e-3  # pointers and score logits (tests/test_torch_engine.py)
MASK_TOL = dict(atol=2e-3, rtol=2 ** -10)  # fp16 mask logits
SIGN_AGREE = 0.999
KW = {"gather": dict(fill_hole_area=8, max_objects=4),
      "banked": dict(fill_hole_area=8, max_objects=4, max_obj_ptrs_in_encoder=8)}
NUM_FRAMES = 12
S = 128  # the tiny config's image size
COUNTS = (1, 2)
P0 = (np.asarray([[[20.0, 24.0], [90.0, 100.0]]], np.float32),
      np.asarray([[2, 3]], np.int32))
P1 = (np.asarray([[[40.0, 10.0], [110.0, 80.0]], [[5.0, 60.0], [60.0, 120.0]]],
                 np.float32),
      np.asarray([[2, 3], [2, 3]], np.int32))
WINDOW = np.arange(1, 8, dtype=np.int32)
BANK_EXACT = ("cond_frame_idx", "cond_pinned", "cond_obj_valid",
              "noncond_frame_idx", "noncond_obj_valid")
BANK_FLOAT = ("cond_mem", "cond_ptr", "noncond_mem", "noncond_ptr")


def _frames(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((NUM_FRAMES, S, S, 3)) * 40 + 90).clip(0, 255).astype(
        np.uint8)


F0, F1 = _frames(1), _frames(2)


def _pair(frame_idx):
    return np.stack([F0[frame_idx], F1[frame_idx]])


def _window_frames(idx=WINDOW):
    return np.stack([F0[idx], F1[idx]], axis=1)  # [T, B, H, W, 3]


@pytest.fixture(scope="module", params=["gather", "banked"])
def engines(request):
    """(mode, JAX engine, port engine) with the same seeded weights."""
    mode = request.param
    jeng = JaxEngine(jax_tiny_config(**KW[mode]), seed=11)
    params = jax.tree_util.tree_map(np.array, jeng.params)
    params["sam_mask_decoder"]["pred_obj_score_head"]["layers_2"]["bias"][:] = 1.0
    jeng.params = jax.tree_util.tree_map(jnp.asarray, params)
    eng = SAM2Engine(tiny_test_config(**KW[mode]), params=convert.from_jax_params(params),
                     device="cpu", banked=mode == "banked")
    return mode, jeng, eng


def _jax_streamer(mode, jeng, monkeypatch, counts=COUNTS):
    # the JAX engine reads DET_SAM2_BANKED_ATTN when the streamer makes its bank
    monkeypatch.setenv("DET_SAM2_BANKED_ATTN", "1" if mode == "banked" else "0")
    return JaxStreamer(jeng, counts)


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _bank_np(bank, fields):
    return {f: (_np(getattr(bank, f)) if f in BANK_FLOAT + ("mem_k", "mem_v")
                else np.asarray(getattr(bank, f))) for f in fields}


def assert_rows_close(got, want, what):
    """(low, ptr, logits) of a window."""
    low, ptr, logits = (_np(x) for x in got)
    wlow, wptr, wlogits = (_np(x) for x in want)
    assert low.shape == wlow.shape, what
    np.testing.assert_allclose(low, wlow, **MASK_TOL, err_msg=f"{what}: masks")
    np.testing.assert_allclose(ptr, wptr, atol=ATOL, err_msg=f"{what}: obj_ptr")
    np.testing.assert_allclose(logits, wlogits, atol=ATOL, err_msg=f"{what}: logits")
    assert ((low > 0) == (wlow > 0)).mean() >= SIGN_AGREE, what


def assert_banks_close(got, want, what, banked):
    for f in BANK_EXACT:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f"{what}: {f}")
    assert got.attend_cond_tiles == want.attend_cond_tiles, what
    for f in BANK_FLOAT + (("mem_k", "mem_v") if banked else ()):
        np.testing.assert_allclose(_np(getattr(got, f)), _np(getattr(want, f)),
                                   atol=ATOL, err_msg=f"{what}: {f}")


def _two_video_run(streamer):
    """Video 0 prompted at frame 0, video 1 (2 objects) at frame 2; the
    lockstep window over frames 1-7 (frame 2 skips for video 1 only)."""
    streamer.add_prompts(0, NUM_FRAMES, _pair(0), {0: P0})
    streamer.add_prompts(2, NUM_FRAMES, _pair(2), {1: P1})
    return streamer.propagate_window(_window_frames(), WINDOW, NUM_FRAMES)


@pytest.fixture(scope="module")
def two_videos(engines):
    mode, jeng, eng = engines
    with pytest.MonkeyPatch.context() as mp:
        js = _jax_streamer(mode, jeng, mp)
        want = _two_video_run(js)
    ps = BatchedVideoStreamer(eng, COUNTS)
    got = _two_video_run(ps)
    return mode, eng, (ps, got), (js, want)


def test_two_video_window_matches_jax(two_videos):
    mode, _, (ps, got), (js, want) = two_videos
    np.testing.assert_array_equal(got[3], want[3])
    assert got[3][1].tolist() == [False, True]  # frame 2: video 1 prompted
    assert_rows_close(got[:3], want[:3], mode)
    assert got[0].dtype == torch.float16 and got[1].dtype == torch.float32
    for g, w in zip(ps.split(got[1]), js.split(want[1])):
        np.testing.assert_allclose(_np(g), _np(w), atol=ATOL)
    assert not got[0][1, 1:].any() and not got[1][1, 1:].any()  # skipped rows zero
    assert_banks_close(ps.bank, js.bank, mode, mode == "banked")
    assert ps.bank.mem_k is None if mode == "gather" else ps.bank.mem_k is not None


def _single_video_run(eng, frames, prompt_specs, frame_indices, num_objects):
    """One video through the port's single-video prompt + propagate_window."""
    bank = init_bank(eng.cfg, num_objects=num_objects, attend_cond_tiles=1,
                     banked_layers=eng.banked_layers, device="cpu")
    prompted = set()
    for frame_idx, pts, labels in prompt_specs:
        feats = eng.encode_image(frames[frame_idx][None])
        out = eng.prompt_step(feats, bank, frame_idx, NUM_FRAMES, pts, labels,
                              is_init=True)
        bank.attend_cond_tiles = cond_tile_bucket(eng.cfg, len(prompted | {frame_idx}))
        eng.encode_cond_memory(feats, bank, frame_idx, out["pred_masks"],
                               out["object_score_logits"], out["obj_ptr"])
        prompted.add(frame_idx)
    skips = np.asarray([int(f) in prompted for f in frame_indices], bool)
    run = ~skips
    img_idx = np.zeros((len(frame_indices),), np.int32)
    img_idx[run] = np.arange(int(run.sum()), dtype=np.int32)
    images = frames[np.asarray(frame_indices)][run]
    bank, rows = eng.propagate_window(images, bank, frame_indices, skips, NUM_FRAMES,
                                      img_idx=img_idx)
    return bank, rows


def test_each_video_equals_its_own_session(two_videos):
    """Each video's rows of the merged window against that video alone
    through the single-video window (the JAX package's own batched test):
    the batched encode is the only difference."""
    _, eng, (ps, got), _ = two_videos
    refs = (_single_video_run(eng, F0, [(0, *P0)], WINDOW, 1)[1],
            _single_video_run(eng, F1, [(2, *P1)], WINDOW, 2)[1])
    for v, ref in enumerate(refs):
        assert_rows_close([ps.split(x)[v] for x in got[:3]], ref, f"video {v}")


def _merge_run(streamer):
    shared = _pair(0)
    streamer.add_prompts(0, NUM_FRAMES, shared, {0: P0})
    streamer.add_prompts(0, NUM_FRAMES, shared, {1: P1})
    return streamer


def test_same_frame_prompts_merge_like_jax(engines):
    """Two add_prompts calls at the SAME frame for different video subsets
    merge into one cond slot: the first call's rows are restored after the
    second call's slot-matched write (cond_mem, cond_ptr, cond_obj_valid and,
    banked, the mem_k / mem_v rows), as in JAX; then a window."""
    mode, jeng, eng = engines
    with pytest.MonkeyPatch.context() as mp:
        js = _merge_run(_jax_streamer(mode, jeng, mp))
    ps = _merge_run(BatchedVideoStreamer(eng, COUNTS))
    slot = int(np.where(ps.bank.cond_frame_idx.numpy() == 0)[0][0])
    assert ps.bank.cond_obj_valid[slot].all()
    assert_banks_close(ps.bank, js.bank, f"{mode} after the merge", mode == "banked")
    got = ps.propagate_window(_window_frames(), WINDOW, NUM_FRAMES)
    want = js.propagate_window(_window_frames(), WINDOW, NUM_FRAMES)
    assert not got[3].any()
    assert_rows_close(got[:3], want[:3], f"{mode} window after the merge")


def test_restore_keeps_the_first_calls_rows(engines):
    """The restored rows are the first call's own: video 0's rows of the
    merged slot equal a streamer prompted for video 0 alone (bit for bit:
    the same encode of the same frame), video 1's are the new write."""
    _, _, eng = engines
    alone = BatchedVideoStreamer(eng, COUNTS)
    alone.add_prompts(0, NUM_FRAMES, _pair(0), {0: P0})
    merged = _merge_run(BatchedVideoStreamer(eng, COUNTS))
    fields = ["cond_mem", "cond_ptr", "cond_obj_valid"]
    if eng.banked_layers:
        fields += ["mem_k", "mem_v"]
    for f in fields:
        a, b = getattr(alone.bank, f)[0], getattr(merged.bank, f)[0]
        assert torch.equal(a[:1], b[:1]), f
        if f != "cond_obj_valid":
            assert not torch.equal(a[1:], b[1:]), f
    assert merged.bank.cond_obj_valid[0].tolist() == [True, True, True]


def test_all_skip_step_encodes_nothing(engines, monkeypatch):
    """A step where every video is prompted: no encode, no bank write, zero
    rows for every video; the other steps as in JAX."""
    mode, jeng, eng = engines
    with pytest.MonkeyPatch.context() as mp:
        js = _jax_streamer(mode, jeng, mp)
        js.add_prompts(3, NUM_FRAMES, _pair(3), {0: P0, 1: P1})
        want = js.propagate_window(_window_frames(), WINDOW, NUM_FRAMES)
    ps = BatchedVideoStreamer(eng, COUNTS)
    ps.add_prompts(3, NUM_FRAMES, _pair(3), {0: P0, 1: P1})
    encodes = []
    orig = eng.encode_image
    monkeypatch.setattr(eng, "encode_image", lambda img: encodes.append(1) or orig(img))
    got = ps.propagate_window(_window_frames(), WINDOW, NUM_FRAMES)
    assert got[3][2].all() and not got[3][[0, 1, 3, 4, 5, 6]].any()
    assert len(encodes) == len(WINDOW) - 1
    assert not got[0][2].any() and not got[1][2].any() and not got[2][2].any()
    assert 3 not in ps.bank.noncond_frame_idx.tolist()
    assert_rows_close(got[:3], want[:3], f"{mode} all-skip")
    assert_banks_close(ps.bank, js.bank, f"{mode} all-skip", mode == "banked")


def test_one_video_streamer_equals_single_video_window(engines):
    """B = 1: the streamer's window is the single-video window bit for bit
    (the same per-frame body on the same features), bank included."""
    _, _, eng = engines
    ps = BatchedVideoStreamer(eng, (2,))
    boxes = np.concatenate([P0[0], P1[0][:1]])
    labels = np.concatenate([P0[1], P1[1][:1]])
    ps.add_prompts(0, NUM_FRAMES, F0[0:1], {0: (boxes, labels)})
    low, ptr, logits, skips = ps.propagate_window(F0[WINDOW][:, None], WINDOW,
                                                  NUM_FRAMES)
    assert not skips.any()
    bank, (wlow, wptr, wlogits) = _single_video_run(eng, F0, [(0, boxes, labels)],
                                                    WINDOW, 2)
    assert torch.equal(low, wlow) and torch.equal(ptr, wptr)
    assert torch.equal(logits, wlogits)
    for f in dataclasses.fields(bank):
        a, b = getattr(ps.bank, f.name), getattr(bank, f.name)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), f.name


def test_empty_and_overflowing_prompts_raise(engines):
    _, _, eng = engines
    ps = BatchedVideoStreamer(eng, COUNTS)
    with pytest.raises(ValueError, match="empty prompts"):
        ps.add_prompts(0, NUM_FRAMES, _pair(0), {})
    with pytest.raises(ValueError, match="unknown video ids"):
        ps.add_prompts(0, NUM_FRAMES, _pair(0), {5: P0})
    with pytest.raises(ValueError, match="prompt rows"):
        ps.add_prompts(0, NUM_FRAMES, _pair(0), {0: P1})
    with pytest.raises(ValueError, match="expected 2 frames"):
        ps.add_prompts(0, NUM_FRAMES, F0[:1], {0: P0})
    cap = min(eng.cfg.cond_attn_size, eng.cfg.cond_bank_size)
    ps.prompt_frames = [set(range(cap - 1)), {cap - 1}]
    with pytest.raises(ValueError, match="split the videos"):
        ps.add_prompts(cap, NUM_FRAMES, _pair(0), {0: P0})
    with pytest.raises(ValueError, match=r"\(T=3, B=2\)"):
        ps.propagate_window(np.zeros((3, 1, S, S, 3), np.uint8), np.arange(3), NUM_FRAMES)
    with pytest.raises(NotImplementedError):
        BatchedVideoStreamer(SAM2Engine(
            dataclasses.replace(eng.cfg, non_overlap_masks_for_mem_enc=True),
            device="cpu"), COUNTS)


def test_window_guards_raise(engines):
    """propagate_window_batched's guards: the bank's object rows against
    counts, the non-overlap refusal, and the capacity of the non-cond bank
    for a window with per-video skips (noncond_bank_size < read span +
    skips)."""
    _, _, eng = engines
    cfg = eng.cfg
    bank = init_bank(cfg, num_objects=4, device="cpu")
    images = np.zeros((2, 2, S, S, 3), np.uint8)
    with pytest.raises(ValueError, match="object rows"):
        eng.propagate_window_batched(images, bank, [1, 2], np.zeros((2, 2), bool),
                                     NUM_FRAMES, COUNTS)
    overlap = SAM2Engine(dataclasses.replace(cfg, non_overlap_masks_for_mem_enc=True),
                         device="cpu")
    with pytest.raises(NotImplementedError, match="non_overlap"):
        overlap.propagate_window_batched(images, init_bank(cfg, 3, device="cpu"),
                                         [1, 2], np.zeros((2, 2), bool), NUM_FRAMES,
                                         COUNTS)
    ps = BatchedVideoStreamer(eng, COUNTS)
    span = (cfg.num_maskmem - 1) * max(1, cfg.memory_temporal_stride_for_eval)
    n_skip = cfg.noncond_bank_size - span + 1
    assert n_skip >= 1
    t = n_skip + 2
    ps.prompt_frames = [set(range(n_skip)), set()]
    with pytest.raises(ValueError, match="single-session-exact"):
        ps.propagate_window(np.zeros((t, 2, S, S, 3), np.uint8),
                            np.arange(t, dtype=np.int32), NUM_FRAMES)
