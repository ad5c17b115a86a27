"""The port's engine-level slice-5 methods vs the JAX SAM2Engine's.

propagate_window (forward and reverse, 6 steps of which 2 skip), mask_prompt_step
(init and memory-conditioned, on both config branches), empty_mask_ptr,
resize_masks and attach_bank_caches run in both packages on the CPU with the
same weights (tiny_test_config(fill_hole_area=8, max_objects=4), the
object-score bias raised to +1 as in tests/test_torch_engine.py), fp32, TF32
off, memory attention in gather mode. Then the port's window is held against
its own per-frame stream_step: both run the same per-frame code, so the banks
must be equal bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from det_sam2_tpu.configs import tiny_test_config as jax_tiny_config
from det_sam2_tpu.state import init_bank as jax_init_bank
from det_sam2_tpu.track import SAM2Engine as JaxEngine

from det_sam2_tpu_torch import convert
from det_sam2_tpu_torch.configs import tiny_test_config
from det_sam2_tpu_torch.state import MemoryBank, init_bank
from det_sam2_tpu_torch.track import SAM2Engine

from test_torch_video_predictor import one_torch_thread  # noqa: F401 (autouse)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ATOL = 2e-3  # logits and pointers (tests/test_torch_engine.py)
MASK_TOL = dict(atol=2e-3, rtol=2 ** -10)  # stored fp16 mask logits
KW = dict(fill_hole_area=8, max_objects=4)
# the banked tests: 8 pointers keep the pointer tokens in one 64-token tile
BANKED_KW = dict(KW, max_obj_ptrs_in_encoder=8)
BOXES = np.asarray([[[5.0, 10.0], [40.0, 52.0]], [[60.0, 30.0], [100.0, 90.0]]],
                   np.float32)
LABELS = np.asarray([[2, 3], [2, 3]], np.int32)
INT_FIELDS = ("cond_frame_idx", "cond_pinned", "cond_obj_valid",
              "noncond_frame_idx", "noncond_obj_valid")
FLOAT_FIELDS = ("cond_mem", "cond_ptr", "noncond_mem", "noncond_ptr")
N_FRAMES = 14
# (reverse, cond frame, window frame indices, skips)
WINDOWS = {
    "forward": (False, 0, [1, 2, 3, 4, 5, 6], [False, False, True, False, True, False]),
    "reverse": (True, 13, [12, 11, 10, 9, 8, 7], [False, True, False, False, True, False]),
}


@pytest.fixture(scope="module")
def setup():
    cfg = jax_tiny_config(**KW)
    jeng = JaxEngine(cfg, seed=11)
    params = jax.tree_util.tree_map(np.array, jeng.params)
    params["sam_mask_decoder"]["pred_obj_score_head"]["layers_2"]["bias"][:] = 1.0
    jeng.params = jax.tree_util.tree_map(jnp.asarray, params)
    frames = np.random.default_rng(5).integers(
        0, 255, (N_FRAMES, cfg.image_size, cfg.image_size, 3), np.uint8)
    sd = convert.from_jax_params(params)
    eng = SAM2Engine(tiny_test_config(**KW), params=sd, device="cpu")
    return jeng, eng, params, sd, frames


def _prompted(jeng, eng, frames, t):
    """Both packages' 2-object banks after box prompts on frame t and the
    cond-memory write."""
    jbank = jax_init_bank(jeng.cfg, num_objects=2, attend_cond_tiles=1)
    jf = jeng.encode_image(jnp.asarray(frames[t:t + 1]))
    jo = jeng.prompt_step(jf, jbank, t, N_FRAMES, jnp.asarray(BOXES),
                          jnp.asarray(LABELS), is_init=True)
    jbank = jeng.encode_cond_memory(jf, jbank, t, jo["pred_masks"],
                                    jo["object_score_logits"], jo["obj_ptr"])
    tbank = init_bank(eng.cfg, num_objects=2, attend_cond_tiles=1, device="cpu")
    tf = eng.encode_image(frames[t:t + 1])
    to = eng.prompt_step(tf, tbank, t, N_FRAMES, BOXES, LABELS, is_init=True)
    eng.encode_cond_memory(tf, tbank, t, to["pred_masks"], to["object_score_logits"],
                           to["obj_ptr"])
    return jbank, tbank


def _assert_banks_close(jbank, tbank, what):
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tbank, f).numpy(),
                                      np.asarray(getattr(jbank, f)), err_msg=f"{what} {f}")
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(tbank, f).numpy(),
                                   np.asarray(getattr(jbank, f)), atol=ATOL,
                                   err_msg=f"{what} {f}")


@pytest.mark.parametrize("direction", list(WINDOWS))
def test_propagate_window_matches_jax(setup, direction):
    jeng, eng, _, _, frames = setup
    reverse, cond_t, order, skips = WINDOWS[direction]
    jbank, tbank = _prompted(jeng, eng, frames, cond_t)
    run = [fi for fi, s in zip(order, skips) if not s]
    pos = {fi: i for i, fi in enumerate(run)}
    img_idx = [pos.get(fi, 0) for fi in order]
    valid = np.asarray([True, True])
    jbank, (jm, jp, jl) = jeng.propagate_window(
        frames[run], jbank, np.asarray(order, np.int32), np.asarray(skips), N_FRAMES,
        reverse=reverse, obj_valid=valid, img_idx=np.asarray(img_idx, np.int32))
    out_bank, (tm, tp, tl) = eng.propagate_window(
        frames[run], tbank, order, skips, N_FRAMES, reverse=reverse,
        obj_valid=valid, img_idx=img_idx)
    assert out_bank is tbank
    assert tm.dtype == torch.float16 and tuple(tm.shape) == (6, 2, 1, 32, 32)
    assert float(tl[~torch.tensor(skips)].min()) > 0, "objects absent"
    np.testing.assert_allclose(tm.float().numpy(), np.asarray(jm, np.float32),
                               **MASK_TOL, err_msg="pred_masks")
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL, err_msg="obj_ptr")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, err_msg="logits")
    # skip steps: zero rows, no inference, no bank write
    sk = torch.tensor(skips)
    assert not tm[sk].any() and not tp[sk].any() and not tl[sk].any()
    _assert_banks_close(jbank, tbank, direction)
    assert sorted(x for x in tbank.noncond_frame_idx.tolist() if x >= 0) == sorted(run)


@pytest.fixture(scope="module")
def variants(setup):
    """mask_as_output -> (JAX engine, port engine, their prompted banks),
    made once per config branch."""
    jeng, eng, _, sd, frames = setup
    cache = {}

    def get(mask_as_output: bool):
        if mask_as_output not in cache:
            kw = dict(KW, use_mask_input_as_output_without_sam=mask_as_output)
            j, t = jeng, eng
            if not mask_as_output:  # the setup engines run the default branch
                j = JaxEngine(jax_tiny_config(**kw), params=jeng.params)
                t = SAM2Engine(tiny_test_config(**kw), params=sd, device="cpu")
            cache[mask_as_output] = (j, t) + _prompted(j, t, frames, 0)
        return cache[mask_as_output]

    return get


BRANCHES = pytest.mark.parametrize("mask_as_output", [True, False],
                                   ids=["mask-as-output", "sam-heads"])


@BRANCHES
@pytest.mark.parametrize("is_init", [True, False], ids=["init", "conditioned"])
def test_mask_prompt_step_matches_jax(setup, variants, mask_as_output, is_init):
    frames = setup[4]
    jeng, eng, jbank, tbank = variants(mask_as_output)
    s = eng.cfg.image_size
    masks = np.zeros((2, s, s, 1), np.float32)
    masks[0, 20:70, 30:90] = 1.0
    masks[1, 64:, :50] = 1.0
    want = jeng.mask_prompt_step(jeng.encode_image(jnp.asarray(frames[3:4])), jbank, 3,
                                 N_FRAMES, jnp.asarray(masks), is_init=is_init)
    got = eng.mask_prompt_step(eng.encode_image(frames[3:4]), tbank, 3, N_FRAMES,
                               masks, is_init=is_init)
    assert float(got["object_score_logits"].min()) > 0, "objects absent"
    for k in ("pred_masks", "obj_ptr", "object_score_logits", "ious"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k], np.float32),
                                   atol=ATOL, err_msg=k)


@BRANCHES
def test_empty_mask_ptr_matches_jax(setup, variants, mask_as_output):
    frames = setup[4]
    jeng, eng, _, _ = variants(mask_as_output)
    want = jeng.empty_mask_ptr(jeng.encode_image(jnp.asarray(frames[2:3])), 2)
    got = eng.empty_mask_ptr(eng.encode_image(frames[2:3]), 2)
    assert tuple(got.shape) == (1, eng.cfg.hidden_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("out_hw", [(96, 112), (20, 24), (32, 32), (1280, 720)])
def test_resize_masks_matches_jax(setup, out_hw):
    jeng, eng, _, _, _ = setup
    logits = np.random.default_rng(2).standard_normal((3, 1, 32, 32)).astype(np.float32) * 8
    got = eng.resize_masks(logits, out_hw)
    want = np.asarray(jeng.resize_masks(jnp.asarray(logits), out_hw))
    assert tuple(got.shape) == (3, 1) + out_hw
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_attach_bank_caches_matches_jax(setup, monkeypatch):
    """The same seeded memories in both packages' banks; JAX builds its
    caches when DET_SAM2_BANKED_ATTN=1 (a jitted projection, no Pallas)."""
    jeng, _, _, sd, _ = setup
    jcfg, cfg = jax_tiny_config(**BANKED_KW), tiny_test_config(**BANKED_KW)
    jeng = JaxEngine(jcfg, params=jeng.params)
    eng = SAM2Engine(cfg, params=sd, device="cpu", banked=True)
    tbank = init_bank(cfg, num_objects=2, device="cpu")
    rng = np.random.default_rng(3)
    for f in ("cond_mem", "noncond_mem"):
        getattr(tbank, f).copy_(torch.from_numpy(
            rng.standard_normal(getattr(tbank, f).shape).astype(np.float32)))
    jbank = jax_init_bank(jcfg, num_objects=2).replace(
        cond_mem=jnp.asarray(tbank.cond_mem.numpy()),
        noncond_mem=jnp.asarray(tbank.noncond_mem.numpy()))
    monkeypatch.setenv("DET_SAM2_BANKED_ATTN", "1")
    want = jeng.attach_bank_caches(jbank)
    got = eng.attach_bank_caches(tbank)
    assert got.cond_mem is tbank.cond_mem  # the memories are shared
    assert tuple(got.mem_k.shape) == (cfg.cond_bank_size + cfg.noncond_bank_size + 1, 2,
                                      eng.banked_layers, 64, 256)
    for f in ("mem_k", "mem_v"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=ATOL, err_msg=f)
    # an engine on the gather path strips them
    gather = SAM2Engine(cfg, params=sd, device="cpu")
    stripped = gather.attach_bank_caches(got)
    assert stripped.mem_k is None and stripped.mem_v is None


def test_attach_bank_caches_rebuilds_what_a_banked_session_wrote(setup):
    _, _, _, sd, frames = setup
    cfg = tiny_test_config(**BANKED_KW)
    eng = SAM2Engine(cfg, params=sd, device="cpu", banked=True)
    bank = init_bank(cfg, num_objects=2, attend_cond_tiles=1,
                     banked_layers=eng.banked_layers, device="cpu")
    feats = eng.encode_image(frames[0:1])
    out = eng.prompt_step(feats, bank, 0, N_FRAMES, BOXES, LABELS, is_init=True)
    eng.encode_cond_memory(feats, bank, 0, out["pred_masks"],
                           out["object_score_logits"], out["obj_ptr"])
    eng.propagate_window(frames[1:5], bank, [1, 2, 3, 4], [False] * 4, N_FRAMES)
    rebuilt = eng.attach_bank_caches(dataclasses.replace(bank, mem_k=None, mem_v=None))
    kc = cfg.cond_bank_size
    written = torch.cat([bank.cond_frame_idx, bank.noncond_frame_idx]) >= 0
    assert int(written.sum()) == 5
    for f in ("mem_k", "mem_v"):
        torch.testing.assert_close(getattr(rebuilt, f)[:-1][written],
                                   getattr(bank, f)[:-1][written], atol=ATOL, rtol=0)
    assert not rebuilt.mem_k[-1].any()  # the staging row starts empty
    torch.testing.assert_close(rebuilt.mem_v[kc:-1], bank.noncond_mem)


@pytest.mark.parametrize("banked", [False, True], ids=["gather", "banked"])
def test_window_equals_per_frame_stream_steps(setup, banked):
    _, _, _, sd, frames = setup
    cfg = tiny_test_config(**(BANKED_KW if banked else KW))
    eng = SAM2Engine(cfg, params=sd, device="cpu", banked=banked)
    bank = init_bank(cfg, num_objects=2, attend_cond_tiles=1,
                     banked_layers=eng.banked_layers, device="cpu")
    feats = eng.encode_image(frames[0:1])
    out = eng.prompt_step(feats, bank, 0, N_FRAMES, BOXES, LABELS, is_init=True)
    eng.encode_cond_memory(feats, bank, 0, out["pred_masks"],
                           out["object_score_logits"], out["obj_ptr"])
    copy = MemoryBank(**{f.name: (getattr(bank, f.name).clone()
                                  if torch.is_tensor(getattr(bank, f.name))
                                  else getattr(bank, f.name))
                         for f in dataclasses.fields(bank)})
    _, (wm, wp, wl) = eng.propagate_window(frames[1:7], bank, list(range(1, 7)),
                                           [False] * 6, N_FRAMES)
    for i, t in enumerate(range(1, 7)):
        _, o = eng.stream_step(frames[t:t + 1], copy, t, N_FRAMES)
        assert torch.equal(wp[i], o["obj_ptr"]) and torch.equal(
            wl[i], o["object_score_logits"]), f"step {t}"
        # the window rounds to fp16 before the hole fill, stream_step after
        np.testing.assert_allclose(wm[i].float().numpy(), o["pred_masks"].numpy(),
                                   **MASK_TOL, err_msg=f"step {t}")
    for f in dataclasses.fields(bank):
        a, b = getattr(bank, f.name), getattr(copy, f.name)
        assert (torch.equal(a, b) if torch.is_tensor(a) else a == b), f.name
