"""The port Trainer's validation hooks vs the JAX package's, on the CPU.

``validate`` (GT-mask-prompted tracking loss and mean IoU) and
``validate_jf`` (the video predictor over held-out clips, scored with
sav_benchmark) on the same seeded weights and inputs as JAX's Trainer, with
the helpers of test_torch_trainer.py. Then ``validate_jf`` on a trainer
after an epoch: it must read the trained weights (equal to a fresh engine
built from the trained state dict), run every engine call without grad and
leave the module in the mode it found. fp32, TF32 off, one torch thread.
"""

import numpy as np
import pytest
import torch

from det_sam2_tpu.training import dataset as jd
from det_sam2_tpu.training.trainer import TrainerConf as JaxTrainerConf

from det_sam2_tpu_torch import convert
from det_sam2_tpu_torch.configs import tiny_test_config
from det_sam2_tpu_torch.track import SAM2Engine
from det_sam2_tpu_torch.training import dataset as pd
from det_sam2_tpu_torch.training.train_step import OptimConf
from det_sam2_tpu_torch.training.trainer import Trainer, TrainerConf

from test_torch_trainer import (  # noqa: F401  (fixtures)
    LOSS_RTOL,
    jax_trainer,
    loader,
    one_torch_thread,
    optim,
    port_trainer,
    weights,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
JF_ATOL = 2e-3  # J, F and J&F of 128^2 masks: a pixel or two apart at most


def test_validate_matches_jax(weights, tmp_path):
    """GT-mask-prompted validation loss and IoU on the same two batches."""
    want = jax_trainer(weights, JaxTrainerConf()).validate(loader(jd, 2), num_batches=2)
    t = port_trainer(weights, tmp_path)
    got = t.validate(loader(pd, 2), num_batches=2)
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["val_iou"], want["val_iou"], atol=1e-3)
    assert 0.0 < got["val_iou"] <= 1.0
    assert not t.model.training


def _jf_videos():
    """One 5-frame clip at model size with two moving objects."""
    t, h, w = 5, 128, 128
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 60, (t, h, w, 3), np.uint8)
    gt1, gt2 = np.zeros((t, h, w), bool), np.zeros((t, h, w), bool)
    for i in range(t):
        gt1[i, 16 + 4 * i:60 + 4 * i, 20:70] = True
        gt2[i, 70:110, 60 + 3 * i:100 + 3 * i] = True
        frames[i][gt1[i]] = (230, 60, 50)
        frames[i][gt2[i]] = (40, 200, 220)
    return [(frames, {1: gt1, 2: gt2})]


def test_validate_jf_matches_jax(weights):
    want = jax_trainer(weights, JaxTrainerConf()).validate_jf(_jf_videos())
    eng = SAM2Engine(tiny_test_config(), params=convert.from_jax_params(weights),
                     device="cpu")
    got = Trainer(eng.cfg, eng, OptimConf(**optim()), TrainerConf()).validate_jf(_jf_videos())
    assert set(got) == {"val_J", "val_F", "val_JF"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=JF_ATOL, err_msg=k)
    assert 0.0 < got["val_JF"] <= 1.0


WATCHED = ("encode_image", "propagate_window", "prompt_step", "mask_prompt_step")


def test_validate_jf_reads_the_trained_weights(weights, tmp_path):
    pt = port_trainer(weights, tmp_path, steps_per_epoch=2)
    pt.run(loader(pd))
    before = {k: v.clone() for k, v in pt.model.state_dict().items()}
    fresh = SAM2Engine(tiny_test_config(), params=before, device="cpu")
    ref = Trainer(fresh.cfg, fresh, OptimConf(**optim()), TrainerConf()).validate_jf(
        _jf_videos())
    grad_modes = []
    for name in WATCHED:
        orig = getattr(pt.engine, name)

        def watched(*a, _orig=orig, **kw):
            grad_modes.append(torch.is_grad_enabled())
            return _orig(*a, **kw)

        setattr(pt.engine, name, watched)
    pt.model.train()
    try:
        after = pt.validate_jf(_jf_videos())
    finally:
        for name in WATCHED:
            delattr(pt.engine, name)
    assert after == ref
    assert grad_modes and not any(grad_modes)
    assert pt.model.training
    for k, v in pt.model.state_dict().items():
        assert torch.equal(v, before[k]), k
