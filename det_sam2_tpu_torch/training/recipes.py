"""Packaged training recipes: the port's copy of the JAX package's
``training/recipes.py`` (the MOSE finetune recipe's resolved knobs)."""

from __future__ import annotations

import dataclasses
from typing import Optional

from det_sam2_tpu_torch.configs import SAM2Config, sam2_1_hiera_bplus, with_image_size
from det_sam2_tpu_torch.training.loss_fns import MultiStepMultiMasksAndIous
from det_sam2_tpu_torch.training.sam2_train import PromptSimConf
from det_sam2_tpu_torch.training.train_step import OptimConf


@dataclasses.dataclass(frozen=True)
class FinetuneRecipe:
    """Everything a trainer run needs, resolved from one reference YAML."""

    model: SAM2Config
    optim: OptimConf
    sample: PromptSimConf
    loss: MultiStepMultiMasksAndIous
    num_frames: int  # frames per sampled clip (scratch.num_frames)
    max_num_objects: int  # tracks per clip (scratch.max_num_objects)
    batch_size: int  # per-card batch (scratch.train_batch_size)
    num_epochs: int  # scratch.num_epochs * phases_per_epoch
    dataset_multiplier: int  # dataset.multiplier (repeat factor)
    loader_kwargs: dict = dataclasses.field(default_factory=dict)


def mose_finetune_recipe(total_steps: Optional[int] = None,
                         image_size: Optional[int] = None) -> FinetuneRecipe:
    """The MOSE finetune recipe (sam2.1_hiera_b+_MOSE_finetune.yaml):
    hiera-b+ at 1024^2 with drop-path 0.1, T = 8, <= 3 objects, batch 1, a
    cosine 5e-6 -> 5e-7 with vision_lr 3e-6 and trunk layer decay 0.9, loss
    weights {mask 20, dice 1, iou 1, class 1}.

    total_steps: the schedule's length (steps_per_epoch * 40 for a real
    run). image_size: another resolution (e.g. 512 for smoke runs)."""
    model = sam2_1_hiera_bplus()
    model = dataclasses.replace(  # trainer yaml trunk override (:71-73)
        model, hiera=dataclasses.replace(model.hiera, drop_path_rate=0.1))
    if image_size is not None and image_size != model.image_size:
        model = with_image_size(model, image_size)
    optim = OptimConf(
        base_lr=5.0e-6,  # scratch.base_lr
        vision_lr=3.0e-6,  # scratch.vision_lr
        weight_decay=0.1,
        grad_clip_norm=0.1,
        warmup_steps=0,  # the recipe has no warmup
        total_steps=total_steps if total_steps is not None else 10_000,
        layer_decay=0.9,
        cosine_end_ratio=0.1,
    )
    sample = PromptSimConf(
        prob_to_use_pt_input=0.5, prob_to_use_box_input=0.5,
        num_frames_to_correct=2, rand_frames_to_correct=True,
        num_init_cond_frames=2, rand_init_cond_frames=True,
        num_correction_pt_per_frame=7, prob_to_sample_from_gt=0.1,
    )
    loss = MultiStepMultiMasksAndIous(
        weight_dict={"loss_mask": 20.0, "loss_dice": 1.0, "loss_iou": 1.0,
                     "loss_class": 1.0},
        supervise_all_iou=True, iou_use_l1_loss=True,
        focal_gamma_obj_score=0.0, focal_alpha_obj_score=-1.0,
    )
    loader_kwargs = dict(
        image_size=model.image_size, batch_size=1, hflip_prob=0.5, affine_prob=1.0,
        color_jitter_prob=1.0, color_jitter_strengths=(0.1, 0.03, 0.03),
        per_frame_jitter_strengths=(0.1, 0.05, 0.05), grayscale_prob=0.05,
    )
    return FinetuneRecipe(model=model, optim=optim, sample=sample, loss=loss,
                          num_frames=8, max_num_objects=3, batch_size=1, num_epochs=40,
                          dataset_multiplier=2, loader_kwargs=loader_kwargs)
