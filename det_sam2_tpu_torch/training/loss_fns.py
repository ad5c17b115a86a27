"""Training losses: focal + dice + IoU + object score, multi-step multi-mask.

Counterpart of the JAX package's ``training/loss_fns.py`` (SAM 2's
``training/loss_fns.py``), in plain torch ops with the same formulas.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

CORE_LOSS_KEY = "core_loss"

DEFAULT_WEIGHTS = {
    # sam2.1_hiera_b+_MOSE_finetune.yaml:285-296
    "loss_mask": 20.0,
    "loss_dice": 1.0,
    "loss_iou": 1.0,
    "loss_class": 1.0,
}


def _bce_with_logits(logits, targets):
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(inputs, targets, num_objects, alpha: float = 0.25,
                       gamma: float = 2.0, loss_on_multimask: bool = False):
    prob = torch.sigmoid(inputs)
    ce = _bce_with_logits(inputs, targets)
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    if loss_on_multimask:
        return loss.reshape(*loss.shape[:2], -1).mean(-1) / num_objects
    return loss.mean(1).sum() / num_objects


def dice_loss(inputs, targets, num_objects, loss_on_multimask: bool = False):
    inputs = torch.sigmoid(inputs)
    if loss_on_multimask:
        inputs = inputs.reshape(*inputs.shape[:2], -1)
        targets = targets.reshape(*targets.shape[:2], -1)
    else:
        inputs, targets = inputs.flatten(1), targets.flatten(1)
    numerator = 2 * (inputs * targets).sum(-1)
    denominator = inputs.sum(-1) + targets.sum(-1)
    loss = 1 - (numerator + 1) / (denominator + 1)
    if loss_on_multimask:
        return loss / num_objects
    return loss.sum() / num_objects


def iou_loss(inputs, targets, pred_ious, num_objects, loss_on_multimask: bool = False,
             use_l1_loss: bool = False):
    pred_mask = inputs.reshape(*inputs.shape[:2], -1) > 0
    gt_mask = targets.reshape(*targets.shape[:2], -1) > 0
    area_i = (pred_mask & gt_mask).sum(-1).float()
    area_u = (pred_mask | gt_mask).sum(-1).float()
    actual_ious = area_i / area_u.clamp_min(1.0)
    if use_l1_loss:
        loss = (pred_ious - actual_ious).abs()
    else:
        loss = (pred_ious - actual_ious).square()
    if loss_on_multimask:
        return loss / num_objects
    return loss.sum() / num_objects


class MultiStepMultiMasksAndIous:
    """Multi-step loss over the prediction steps of every frame; per step,
    the multimask channel with the lowest focal + dice combination is
    supervised."""

    def __init__(self, weight_dict: Dict[str, float] = None, focal_alpha: float = 0.25,
                 focal_gamma: float = 2.0, supervise_all_iou: bool = False,
                 iou_use_l1_loss: bool = False, pred_obj_scores: bool = False,
                 focal_gamma_obj_score: float = 0.0,
                 focal_alpha_obj_score: float = -1.0):
        self.weight_dict = dict(weight_dict or DEFAULT_WEIGHTS)
        self.weight_dict.setdefault("loss_class", 0.0)
        self.focal_alpha = focal_alpha
        self.focal_gamma = focal_gamma
        self.supervise_all_iou = supervise_all_iou
        self.iou_use_l1_loss = iou_use_l1_loss
        self.pred_obj_scores = pred_obj_scores
        self.focal_gamma_obj_score = focal_gamma_obj_score
        self.focal_alpha_obj_score = focal_alpha_obj_score

    def __call__(self, outs_batch: List[Dict], targets_batch: torch.Tensor,
                 num_objects: Optional[torch.Tensor] = None):
        """outs_batch: per-frame dicts of ``forward_training``; targets_batch
        [T, N, H, W]. Object rows that are empty in every frame are padding:
        they are neither supervised nor counted in num_objects.
        num_objects: the normaliser, when it is not this batch's own count
        (data parallelism: the global count over the ranks / world size)."""
        assert len(outs_batch) == targets_batch.shape[0]
        row_valid = (targets_batch > 0).any(3).any(2).any(0)  # [N]
        if num_objects is None:
            num_objects = row_valid.sum().float().clamp_min(1.0)
        zero = targets_batch.new_zeros(())
        losses = {"loss_mask": zero, "loss_dice": zero, "loss_iou": zero,
                  "loss_class": zero}
        for outs, targets in zip(outs_batch, targets_batch):
            self._forward(losses, outs, targets, num_objects, row_valid)
        losses[CORE_LOSS_KEY] = self.reduce_loss(losses)
        return losses

    def _forward(self, losses, outputs, targets, num_objects, row_valid):
        target_masks = targets[:, None].float()  # [N, 1, H, W]
        for src_masks, ious, obj_logits in zip(
                outputs["multistep_pred_multimasks_high_res"],
                outputs["multistep_pred_ious"],
                outputs["multistep_object_score_logits"]):
            self._update_losses(losses, src_masks, target_masks, ious, num_objects,
                                obj_logits, row_valid)

    def _update_losses(self, losses, src_masks, target_masks, ious, num_objects,
                       obj_logits, row_valid):
        target_masks = target_masks.expand_as(src_masks)
        loss_multimask = sigmoid_focal_loss(src_masks, target_masks, num_objects,
                                            alpha=self.focal_alpha,
                                            gamma=self.focal_gamma,
                                            loss_on_multimask=True)
        loss_multidice = dice_loss(src_masks, target_masks, num_objects,
                                   loss_on_multimask=True)
        valid = row_valid[:, None].float()
        if not self.pred_obj_scores:
            loss_class = src_masks.new_zeros(())
            target_obj = src_masks.new_ones(loss_multimask.shape[0], 1)
        else:
            target_obj = (target_masks[:, 0] > 0).flatten(1).any(-1)[:, None].float()
            loss_class_rows = sigmoid_focal_loss(
                obj_logits, target_obj, num_objects, alpha=self.focal_alpha_obj_score,
                gamma=self.focal_gamma_obj_score, loss_on_multimask=True)
            loss_class = (loss_class_rows * valid).sum()

        loss_multiiou = iou_loss(src_masks, target_masks, ious, num_objects,
                                 loss_on_multimask=True, use_l1_loss=self.iou_use_l1_loss)
        if loss_multimask.shape[1] > 1:
            loss_combo = (loss_multimask * self.weight_dict["loss_mask"]
                          + loss_multidice * self.weight_dict["loss_dice"])
            best = loss_combo.argmin(-1, keepdim=True)
            loss_mask = loss_multimask.gather(1, best)
            loss_dice = loss_multidice.gather(1, best)
            if self.supervise_all_iou:
                loss_iou = loss_multiiou.mean(-1, keepdim=True)
            else:
                loss_iou = loss_multiiou.gather(1, best)
        else:
            loss_mask, loss_dice, loss_iou = loss_multimask, loss_multidice, loss_multiiou

        gate = target_obj * valid
        losses["loss_mask"] = losses["loss_mask"] + (loss_mask * gate).sum()
        losses["loss_dice"] = losses["loss_dice"] + (loss_dice * gate).sum()
        losses["loss_iou"] = losses["loss_iou"] + (loss_iou * gate).sum()
        losses["loss_class"] = losses["loss_class"] + loss_class

    def reduce_loss(self, losses):
        reduced = 0.0
        for key, weight in self.weight_dict.items():
            if key not in losses:
                raise ValueError(f"missing loss term {key}")
            if weight != 0:
                reduced = reduced + losses[key] * weight
        return reduced
