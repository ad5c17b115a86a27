"""The port's streaming slice as a whole: prompt -> cond write -> stream_step.

The port's SAM2Engine and the JAX SAM2Engine run the same session on the
CPU with the same weights (tiny_test_config(fill_hole_area=8), so hole
filling runs on every step): box prompts on 2 objects at frame 0, the
cond-memory write, then stream_steps on seeded uint8 frames. Both use
gather-mode memory attention (the JAX banked session needs its interpret-
mode kernel, marked slow in the JAX suite). The port's banked mode is then
held against its own gather mode.

The object-score head's output bias is raised to +1 in the shared weights
so that both objects count as present: with the random init the scores sit
near 0, every mask would be the NO_OBJ_SCORE constant, and the mask, memory
and hole-filling paths would carry nothing to compare.
"""

import os
import subprocess
import sys

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
from det_sam2_tpu_torch.state import init_bank
from det_sam2_tpu_torch.track import SAM2Engine

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# logits tolerance: the JAX package's own between its two attention modes
# (tests/test_banked_attention.py); fp32 parity is ~1e-6 in practice
ATOL = 2e-3
N_STREAM = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT_KEYS = ("pred_masks", "obj_ptr", "object_score_logits", "ious")
BANK_FIELDS = ("cond_mem", "cond_ptr", "cond_frame_idx", "cond_pinned",
               "cond_obj_valid", "noncond_mem", "noncond_ptr",
               "noncond_frame_idx", "noncond_obj_valid")
BOXES = np.asarray([[[5.0, 10.0], [40.0, 52.0]], [[60.0, 30.0], [100.0, 90.0]]],
                   np.float32)
LABELS = np.asarray([[2, 3], [2, 3]], np.int32)


@pytest.fixture(scope="module")
def setup():
    cfg = jax_tiny_config(fill_hole_area=8)
    jeng = JaxEngine(cfg, seed=11)
    params = jax.tree_util.tree_map(np.array, jeng.params)
    params["sam_mask_decoder"]["pred_obj_score_head"]["layers_2"]["bias"][:] = 1.0
    jeng.params = jax.tree_util.tree_map(jnp.asarray, params)
    frames = np.random.default_rng(5).integers(
        0, 255, (1 + N_STREAM, cfg.image_size, cfg.image_size, 3), np.uint8)
    return cfg, jeng, convert.from_jax_params(params), frames


def _jax_session(jeng, cfg, frames):
    bank = jax_init_bank(cfg, num_objects=2, attend_cond_tiles=1)
    feats = jeng.encode_image(jnp.asarray(frames[0:1]))
    out = jeng.prompt_step(feats, bank, 0, 100, jnp.asarray(BOXES),
                           jnp.asarray(LABELS), is_init=True)
    bank = jeng.encode_cond_memory(feats, bank, 0, out["pred_masks"],
                                   out["object_score_logits"], out["obj_ptr"])
    outs = [out]
    for t in range(1, 1 + N_STREAM):
        bank, o = jeng.stream_step(jnp.asarray(frames[t:t + 1]), bank, t, 100)
        outs.append(o)
    return bank, outs


def _port_session(eng, frames, banked_layers):
    cfg = eng.cfg
    bank = init_bank(cfg, num_objects=2, attend_cond_tiles=1,
                     banked_layers=banked_layers, device="cpu")
    feats = eng.encode_image(frames[0:1])
    out = eng.prompt_step(feats, bank, 0, 100, BOXES, LABELS, is_init=True)
    bank = eng.encode_cond_memory(feats, bank, 0, out["pred_masks"],
                                  out["object_score_logits"], out["obj_ptr"])
    outs = [out]
    for t in range(1, 1 + N_STREAM):
        bank, o = eng.stream_step(frames[t:t + 1], bank, t, 100)
        outs.append(o)
    return bank, outs


@pytest.fixture(scope="module")
def port_gather(setup):
    _, _, sd, frames = setup
    eng = SAM2Engine(tiny_test_config(fill_hole_area=8), params=sd, device="cpu")
    return _port_session(eng, frames, banked_layers=0)


def test_port_matches_jax_gather_mode(setup, port_gather):
    cfg, jeng, _, frames = setup
    jbank, jouts = _jax_session(jeng, cfg, frames)
    tbank, touts = port_gather
    for step, (want, got) in enumerate(zip(jouts, touts)):
        assert float(got["object_score_logits"].min()) > 0, "objects absent"
        for k in OUT_KEYS:
            np.testing.assert_allclose(got[k].float().numpy(),
                                       np.asarray(want[k], np.float32), atol=ATOL,
                                       err_msg=f"step {step} {k}")
    for f in BANK_FIELDS:
        np.testing.assert_allclose(getattr(tbank, f).numpy().astype(np.float32),
                                   np.asarray(getattr(jbank, f), np.float32),
                                   atol=ATOL, err_msg=f)
    # the stream wrote N_STREAM non-cond frames next to the one cond frame
    assert sorted(tbank.noncond_frame_idx.tolist())[-N_STREAM:] == list(
        range(1, 1 + N_STREAM))
    assert tbank.cond_frame_idx.tolist().count(0) == 1


def test_port_banked_matches_port_gather(setup, port_gather):
    _, _, sd, frames = setup
    cfg = tiny_test_config(fill_hole_area=8)
    eng = SAM2Engine(cfg, params=sd, device="cpu")
    bbank, bouts = _port_session(eng, frames, banked_layers=cfg.memory_attention.num_layers)
    gbank, gouts = port_gather
    for step, (g, b) in enumerate(zip(gouts, bouts)):
        for k in OUT_KEYS:
            np.testing.assert_allclose(b[k].numpy(), g[k].numpy(), atol=ATOL,
                                       err_msg=f"step {step} {k}")
    for f in BANK_FIELDS:
        assert torch.allclose(getattr(bbank, f).float(), getattr(gbank, f).float(),
                              atol=ATOL), f
    # the banked caches: row i of mem_v is the memory written to slot i
    kc = cfg.cond_bank_size
    torch.testing.assert_close(bbank.mem_v[:kc], bbank.cond_mem)
    torch.testing.assert_close(bbank.mem_v[kc:-1], bbank.noncond_mem)


def test_engine_does_not_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        SAM2Engine(tiny_test_config())
    with pytest.raises(RuntimeError, match="CUDA"):
        init_bank(tiny_test_config(), num_objects=1)
    assert SAM2Engine(tiny_test_config(), device="cpu").banked_layers == 0
    assert init_bank(tiny_test_config(), num_objects=1,
                     device="cpu").cond_mem.device.type == "cpu"


def test_port_imports_no_jax():
    """Every submodule imports without JAX or the JAX package, and with
    neither cv2 nor PIL importable (the frame path needs no optional
    package)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['cv2'] = sys.modules['PIL'] = None  # import raises\n"
        "import det_sam2_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'det_sam2_tpu')]\n"
        "assert not bad, bad\n"
        "print(' '.join(m for m in sys.modules if m.startswith('det_sam2_tpu_torch')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    mods = res.stdout.split()
    # every submodule, training/, utils/, app/, serving/ and tools/ too
    assert len(mods) >= 61
    for m in ("utils.misc", "video_predictor", "build", "image_predictor",
              "automatic_mask_generator", "utils.amg", "utils.profiling",
              "app.detector", "app.rtsp", "app.video_processor", "app.postprocess",
              "app.pipeline", "app.eval", "app.frames2video", "app.result_visualize",
              "batched", "serving.inference_api", "serving.transcode",
              "serving.graphql", "serving.frontend", "serving.server",
              "tools.sav_benchmark", "tools.sav_utils", "tools.vos_inference",
              "tools.extract_frames", "tools.process_dataset", "training.dataset",
              "training.trainer", "training.checkpoint_utils", "training.launch",
              "parallel.mesh"):
        assert f"det_sam2_tpu_torch.{m}" in mods, m


def test_point_prompt_track_step_and_noncond_write_match_jax(setup):
    """The rest of the slice's surface: a point prompt (one positive click
    per object: the multimask path), encode_image + track_step, and a
    non-cond memory write, against the JAX engine in gather mode."""
    cfg, jeng, sd, frames = setup
    eng = SAM2Engine(tiny_test_config(fill_hole_area=8), params=sd, device="cpu")
    points = np.asarray([[[30.0, 40.0]], [[80.0, 60.0]]], np.float32)
    plabels = np.ones((2, 1), np.int32)
    jbank = jax_init_bank(cfg, num_objects=2, attend_cond_tiles=1)
    tbank = init_bank(eng.cfg, num_objects=2, attend_cond_tiles=1, device="cpu")
    jf = jeng.encode_image(jnp.asarray(frames[0:1]))
    tf = eng.encode_image(frames[0:1])
    jo = jeng.prompt_step(jf, jbank, 0, 100, jnp.asarray(points), jnp.asarray(plabels),
                          is_init=True)
    to = eng.prompt_step(tf, tbank, 0, 100, points, plabels, is_init=True)
    assert tuple(to["ious"].shape) == (2, 3)  # one click: multimask outputs
    jbank = jeng.encode_cond_memory(jf, jbank, 0, jo["pred_masks"],
                                    jo["object_score_logits"], jo["obj_ptr"])
    tbank = eng.encode_cond_memory(tf, tbank, 0, to["pred_masks"],
                                   to["object_score_logits"], to["obj_ptr"])
    jf1 = jeng.encode_image(jnp.asarray(frames[1:2]))
    tf1 = eng.encode_image(frames[1:2])
    jbank, jt = jeng.track_step(jf1, jbank, 1, 100)
    tbank, tt = eng.track_step(tf1, tbank, 1, 100)
    jbank = jeng.encode_noncond_memory(jf1, jbank, 2, jt["pred_masks"],
                                       jt["object_score_logits"], jt["obj_ptr"])
    tbank = eng.encode_noncond_memory(tf1, tbank, 2, tt["pred_masks"],
                                      tt["object_score_logits"], tt["obj_ptr"])
    for name, want, got in (("prompt", jo, to), ("track", jt, tt)):
        for k in OUT_KEYS:
            np.testing.assert_allclose(got[k].float().numpy(),
                                       np.asarray(want[k], np.float32), atol=ATOL,
                                       err_msg=f"{name} {k}")
    for f in BANK_FIELDS:
        np.testing.assert_allclose(getattr(tbank, f).numpy().astype(np.float32),
                                   np.asarray(getattr(jbank, f), np.float32),
                                   atol=ATOL, err_msg=f)
    assert sorted(tbank.noncond_frame_idx.tolist())[-2:] == [1, 2]
