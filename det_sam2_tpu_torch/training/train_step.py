"""The training step: forward, multi-step loss, backward, clip, AdamW.

Counterpart of the JAX package's ``training/train_step.py`` without the
mesh and FSDP (later slices): global-norm clipping at 0.1, AdamW with the
MOSE recipe's parameter groups (vision lr, trunk layer decay, the
``pos_embed`` / ``patch_embed`` rules), no weight decay on biases, norms and
1-D parameters, and the warmup-cosine schedule to base_lr *
cosine_end_ratio. The backward runs through K1's autograd Function, so on
the card the attention gradients come from K3a / K3b.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import torch
from torch import nn

from det_sam2_tpu_torch.configs import SAM2Config
from det_sam2_tpu_torch.modeling.sam2_base import SAM2Model
from det_sam2_tpu_torch.state import resolve_device
from det_sam2_tpu_torch.training.loss_fns import (
    CORE_LOSS_KEY,
    DEFAULT_WEIGHTS,
    MultiStepMultiMasksAndIous,
)
from det_sam2_tpu_torch.training.sam2_train import PromptSchedule, forward_training


@dataclasses.dataclass
class OptimConf:
    """The MOSE finetune recipe's optimizer block
    (sam2.1_hiera_b+_MOSE_finetune.yaml:3-12, training/optimizer.py)."""

    base_lr: float = 5.0e-6
    # image-encoder lr (MOSE recipe: 3e-6); None = the trunk trains at base_lr
    vision_lr: Optional[float] = None
    weight_decay: float = 0.1
    grad_clip_norm: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.999
    # trunk-block lr decay (0.9 in the MOSE recipe); None disables
    layer_decay: Optional[float] = None
    # the lr goes by a cosine from base_lr to base_lr * cosine_end_ratio
    cosine_end_ratio: float = 0.1
    # when set, the weight decay follows a cosine weight_decay ->
    # weight_decay_end over total_steps as well
    weight_decay_end: Optional[float] = None


def decays(name: str, p: torch.Tensor) -> bool:
    """Weight decay applies to this parameter: not a bias, a norm's weight,
    a layer-scale gamma or any other 1-D parameter (the JAX package's
    ``_wd_mask``)."""
    return name.rsplit(".", 1)[-1] not in ("bias", "gamma") and p.ndim > 1


def lr_scale(name: str, cfg: SAM2Config, conf: OptimConf) -> float:
    """The lr multiplier (relative to base_lr) of parameter `name`, the JAX
    package's ``lr_scale_tree``: image_encoder.* trains at vision_lr; the
    trunk's blocks.i further at layer_decay ** (depth - i), patch_embed at
    layer_decay ** (depth + 1), and pos_embed* at 1 (the MOSE yaml's
    '*pos_embed*' override)."""
    depth = cfg.hiera.depth
    vlr = conf.base_lr if conf.vision_lr is None else conf.vision_lr
    keys = name.split(".")
    scale = 1.0
    if keys[0] == "image_encoder":
        scale *= vlr / conf.base_lr
        decay = conf.layer_decay
        if decay and decay != 1.0 and len(keys) >= 2 and keys[1] == "trunk":
            if "pos_embed" in name:
                pass
            elif "patch_embed" in name:
                scale *= decay ** (depth + 1)
            elif "blocks" in keys:
                scale *= decay ** (depth - int(keys[keys.index("blocks") + 1]))
    return scale


def warmup_cosine(count: int, conf: OptimConf) -> float:
    """optax.warmup_cosine_decay_schedule(init 0 (base_lr without warmup),
    peak base_lr, warmup_steps, decay_steps max(total, warmup + 1), end
    base_lr * cosine_end_ratio) at step `count`."""
    peak, warm = conf.base_lr, conf.warmup_steps
    if warm and count < warm:
        return peak * count / warm
    decay_steps = max(conf.total_steps, warm + 1) - warm
    c = min(count - warm, decay_steps)
    end = peak * conf.cosine_end_ratio
    alpha = 0.0 if peak == 0.0 else end / peak
    return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)


def cosine_param(count: int, start: float, end: float, total_steps: int) -> float:
    """fvcore CosineParamScheduler at where = count / total_steps."""
    where = min(max(count / max(total_steps, 1), 0.0), 1.0)
    return end + 0.5 * (start - end) * (1.0 + math.cos(math.pi * where))


class TrainOptimizer:
    """clip_by_global_norm(grad_clip_norm) -> AdamW with per-group lr,
    stepped by ``step()``.

    torch.optim.AdamW applies the decoupled decay p *= 1 - lr * wd and then
    p -= lr * adam_direction, i.e. p -= lr * (adam_direction + wd * p): the
    decay is added before the group lr multiplies the whole update, which is
    the order of the JAX package's chain (scale_by_adam ->
    add_decayed_weights -> per-leaf lr, train_step.py:186-193, 210-212).
    Each step sets every group's lr (base schedule times the group's scale)
    and, with weight_decay_end, its weight decay from the schedules."""

    def __init__(self, conf: OptimConf, named: Iterable[Tuple[str, nn.Parameter]],
                 scale_of: Callable[[str], float]):
        self.conf = conf
        self.count = 0
        groups: Dict[Tuple[float, bool], list] = {}
        self.params = []
        for name, p in named:
            if not p.requires_grad:
                continue
            groups.setdefault((scale_of(name), decays(name, p)), []).append(p)
            self.params.append(p)
        self.adamw = torch.optim.AdamW(
            [{"params": ps, "scale": s, "decay": d, "weight_decay": 0.0}
             for (s, d), ps in groups.items()],
            lr=conf.base_lr, betas=(conf.b1, conf.b2), eps=1e-8)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def clip(self) -> torch.Tensor:
        """Global-norm clipping as optax.clip_by_global_norm; returns the
        norm before clipping."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
        m = self.conf.grad_clip_norm
        factor = torch.where(norm < m, torch.ones_like(norm), m / norm)
        torch._foreach_mul_(grads, factor)
        return norm

    def step(self) -> torch.Tensor:
        """Clip, then one AdamW update at this step's lr; returns the
        gradient's global norm before clipping."""
        norm = self.clip()
        c = self.conf
        lr = warmup_cosine(self.count, c)
        wd = (c.weight_decay if c.weight_decay_end is None
              else cosine_param(self.count, c.weight_decay, c.weight_decay_end,
                                c.total_steps))
        for g in self.adamw.param_groups:
            g["lr"] = lr * g["scale"]
            g["weight_decay"] = wd if g["decay"] else 0.0
        self.adamw.step()
        self.count += 1
        return norm


def make_optimizer(conf: OptimConf, params: Union[nn.Module, Iterable] = None,
                   cfg: Optional[SAM2Config] = None) -> TrainOptimizer:
    """The recipe's optimizer over `params` (the model, or its
    named_parameters()). torch optimizers hold their parameters, so params
    is required; cfg is required when vision_lr or layer_decay ask for
    parameter groups (as in JAX, rather than silently train the whole model
    at base_lr)."""
    if params is None:
        raise TypeError("make_optimizer needs the parameters: pass the model")
    named = list(params.named_parameters() if isinstance(params, nn.Module) else params)
    wants_groups = conf.layer_decay is not None or (
        conf.vision_lr is not None and conf.vision_lr != conf.base_lr)
    if wants_groups and cfg is None:
        raise ValueError(
            "layer_decay/vision_lr need per-parameter groups: pass cfg to "
            "make_optimizer (otherwise they would be silently ignored and the "
            "whole model would train at base_lr)")
    if not wants_groups:
        return TrainOptimizer(conf, named, lambda name: 1.0)
    return TrainOptimizer(conf, named, lambda name: lr_scale(name, cfg, conf))


def make_train_step(cfg: SAM2Config, model: SAM2Model, optimizer: TrainOptimizer,
                    loss_fn: Optional[MultiStepMultiMasksAndIous] = None,
                    prompt_kind: str = "box", num_correction_steps: int = 0,
                    schedule: Optional[PromptSchedule] = None,
                    device=None) -> Callable:
    """Returns step(images [T, B, H, W, 3], gt_masks [T, B(, K), H, W],
    generator, schedule=None) -> metrics (the loss terms, core_loss and
    grad_norm, 0-d tensors), updating the model's parameters in place.

    The step runs on `device` (None = CUDA; raises without a card); the
    model is moved there. The image encoder is rematerialised, as in the
    JAX package (train_step.py:247-251). `generator` draws the prompt noise,
    the correction clicks and the drop-path masks; a per-call `schedule`
    overrides the one given here. Memory attention takes the gather path
    (K1 with a bias; K2 is inference only)."""
    device = resolve_device(device)
    model.to(device)
    cfg = dataclasses.replace(cfg, remat_image_encoder=True)
    if loss_fn is None:
        loss_fn = MultiStepMultiMasksAndIous(
            DEFAULT_WEIGHTS, supervise_all_iou=True, iou_use_l1_loss=True,
            pred_obj_scores=cfg.pred_obj_scores)
    default_schedule = schedule

    def step(images, gt_masks, generator: Optional[torch.Generator] = None,
             schedule: Optional[PromptSchedule] = None) -> Dict[str, torch.Tensor]:
        images = torch.as_tensor(images).to(device=device, dtype=torch.float32)
        gt_masks = torch.as_tensor(gt_masks).to(device=device, dtype=torch.float32)
        optimizer.zero_grad()
        outs = forward_training(
            model, cfg, images, gt_masks, generator=generator,
            schedule=schedule if schedule is not None else default_schedule,
            prompt_kind=prompt_kind, num_correction_steps=num_correction_steps)
        gt_rows = gt_masks
        if gt_rows.ndim == 5:  # [T, B, K, H, W] -> [T, B*K, H, W]
            gt_rows = gt_rows.reshape(gt_rows.shape[0], -1, *gt_rows.shape[3:])
        losses = loss_fn(outs, gt_rows)
        losses[CORE_LOSS_KEY].backward()
        grad_norm = optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = grad_norm.detach()
        return metrics

    return step
