"""The training step: forward, multi-step loss, backward, clip, AdamW.

Counterpart of the JAX package's ``training/train_step.py``: global-norm
clipping at 0.1, AdamW with the MOSE recipe's parameter groups (vision lr,
trunk layer decay, the ``pos_embed`` / ``patch_embed`` rules), no weight
decay on biases, norms and 1-D parameters, and the warmup-cosine schedule to
base_lr * cosine_end_ratio. The backward runs through K1's autograd
Function, so on the card the attention gradients come from K3a / K3b.

Data parallelism (the JAX step's ``mesh``): the model is wrapped in
DistributedDataParallel over the mesh's process group and each rank steps
on its rows of the global batch (``parallel.mesh.shard_batch``); with
``fsdp=True`` it is sharded with ``fully_shard`` instead, parameters under
``fsdp_min_size`` elements staying replicated as in the JAX step's
``leaf_sharding``. The loss is normalised by the global count of valid
object rows, so the averaged gradient equals the JAX step's on the whole
batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import torch
import torch.distributed as dist
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
    and, with weight_decay_end, its weight decay from the schedules.

    A parameter the step's graph did not reach gets a zero gradient, as
    JAX's gradient of an unused leaf is zero: its weight still decays, its
    Adam moments still decay, and every parameter counts the same steps in
    its bias correction (torch's AdamW would skip a parameter without a
    gradient). Frozen parameters (``freeze``) keep their place in the clip
    and leave the AdamW groups."""

    def __init__(self, conf: OptimConf, named: Iterable[Tuple[str, nn.Parameter]],
                 scale_of: Callable[[str], float]):
        self.conf = conf
        self.count = 0
        self._scale_of = scale_of
        self._frozen: set = set()
        self.rebind(named)

    def rebind(self, named: Iterable[Tuple[str, nn.Parameter]]) -> None:
        """(Re)build the AdamW groups over these parameters: the model's
        own, or the DTensor parameters that ``fully_shard`` put in their
        place. Only before the first step."""
        if self.count:
            raise RuntimeError("the optimizer has stepped: its state belongs to "
                               "the parameters it was built over")
        self._named = [(n, p) for n, p in named if p.requires_grad]
        self.params = [p for _, p in self._named]
        from torch.distributed.tensor import DTensor

        # a group holds sharded (DTensor) or plain parameters, never both:
        # the foreach AdamW takes a group's tensors in one call
        groups: Dict[Tuple[float, bool, bool], list] = {}
        for name, p in self._named:
            if name not in self._frozen:
                key = (self._scale_of(name), decays(name, p), isinstance(p, DTensor))
                groups.setdefault(key, []).append(p)
        self.adamw = torch.optim.AdamW(
            [{"params": ps, "scale": s, "decay": d, "weight_decay": 0.0}
             for (s, d, _), ps in groups.items()],
            lr=self.conf.base_lr, betas=(self.conf.b1, self.conf.b2), eps=1e-8)

    def freeze(self, names) -> None:
        """Leave these parameters out of the AdamW groups (see
        ``checkpoint_utils.freeze_wrapper``)."""
        self._frozen |= set(names)
        self.rebind(self._named)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def clip(self) -> torch.Tensor:
        """Global-norm clipping as optax.clip_by_global_norm; returns the
        norm before clipping. Under FSDP the sharded gradients' norm is
        reduced over the ranks (DTensor.full_tensor) before the factor;
        replicated gradients count once."""
        from torch.distributed.tensor import DTensor

        grads = [p.grad for p in self.params]
        plain = [g for g in grads if not isinstance(g, DTensor)]
        sharded = [g for g in grads if isinstance(g, DTensor)]

        def norm_of(gs):
            return torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g.float()) for g in gs]))

        if not sharded:
            norm = norm_of(plain)
        else:
            norm = norm_of(sharded)
            if isinstance(norm, DTensor):
                norm = norm.full_tensor()
            if plain:
                norm = torch.linalg.vector_norm(torch.stack([norm, norm_of(plain)]))
        m = self.conf.grad_clip_norm
        factor = torch.where(norm < m, torch.ones_like(norm), m / norm)
        for gs in (plain, sharded):
            if gs:
                torch._foreach_mul_(gs, factor)
        return norm

    def step(self) -> torch.Tensor:
        """Clip, then one AdamW update at this step's lr; returns the
        gradient's global norm before clipping."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
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


class _TrainForward(nn.Module):
    """``forward_training`` as one module call, so that DDP and FSDP see the
    step's whole forward (FSDP gathers the parameters outside its inner
    groups for it; DDP finds the parameters it did not reach)."""

    def __init__(self, model: SAM2Model, cfg: SAM2Config):
        super().__init__()
        self.model = model
        self.cfg = cfg

    def forward(self, images, gt_masks, generator=None, schedule=None,
                prompt_kind="box", num_correction_steps=0):
        return forward_training(self.model, self.cfg, images, gt_masks,
                                generator=generator, schedule=schedule,
                                prompt_kind=prompt_kind,
                                num_correction_steps=num_correction_steps)


def _fully_shard(wrapper: _TrainForward, mesh, min_size: int):
    """fully_shard each trunk block, the image encoder, memory attention and
    the memory encoder (each entered through its own call), then the rest
    under the step's forward. The prompt encoder and the mask decoder stay
    in that outer group: the step reads the decoder's high-res convs and the
    encoder's dense PE outside their calls. Parameters under min_size
    elements are not sharded (``ignored_params``) and are returned: their
    gradients are averaged over the ranks by the caller."""
    from torch.distributed.fsdp import fully_shard

    model = wrapper.model
    small = [p for p in wrapper.parameters() if p.numel() < min_size]
    groups = list(model.image_encoder.trunk.blocks) + [
        model.image_encoder, model.memory_attention, model.memory_encoder]
    for m in groups + [wrapper]:
        fully_shard(m, mesh=mesh, ignored_params=set(small))
    return small


def _trains(cfg: SAM2Config, schedule: Optional[PromptSchedule], prompt_kind: str,
            num_frames: int) -> bool:
    """False when no output of the step depends on a parameter: every frame
    is an initial conditioning frame whose GT mask is its output (JAX's
    gradient is then zero). The forward then runs without grad and the
    optimizer steps on zero gradients, as optax does."""
    if schedule is None:
        mask_prompt, n_cond = prompt_kind == "mask", 1
    else:
        mask_prompt, n_cond = not schedule.use_pt_input, len(set(schedule.init_cond_frames))
    return not (mask_prompt and cfg.use_mask_input_as_output_without_sam
                and n_cond >= num_frames)


def make_train_step(cfg: SAM2Config, model: SAM2Model, optimizer: TrainOptimizer,
                    loss_fn: Optional[MultiStepMultiMasksAndIous] = None,
                    prompt_kind: str = "box", num_correction_steps: int = 0,
                    schedule: Optional[PromptSchedule] = None,
                    device=None, mesh=None, fsdp: bool = False,
                    fsdp_min_size: int = 1 << 14) -> Callable:
    """Returns step(images [T, B, H, W, 3], gt_masks [T, B(, K), H, W],
    generator, schedule=None) -> metrics (the loss terms, core_loss and
    grad_norm, 0-d tensors), updating the model's parameters in place.

    The step runs on `device` (None = CUDA; raises without a card); the
    model is moved there. The image encoder is rematerialised, as in the
    JAX package (train_step.py:247-251). `generator` draws the prompt noise,
    the correction clicks and the drop-path masks; a per-call `schedule`
    overrides the one given here. Memory attention takes the gather path
    (K1 with a bias; K2 is inference only).

    mesh (``parallel.mesh.make_mesh``): the batch is data-parallel over its
    ranks; each rank passes its own rows (``shard_batch``) and its own
    generator. The model is wrapped in DistributedDataParallel (parameters
    a schedule does not reach are allowed), or with fsdp=True sharded in
    place with ``fully_shard`` (the optimizer is rebuilt over the sharded
    parameters, so make it first and do not step it before). The metrics
    are the global batch's: the loss terms averaged over the ranks, the
    norm of the averaged gradient."""
    device = resolve_device(device)
    model.to(device)
    cfg = dataclasses.replace(cfg, remat_image_encoder=True)
    if loss_fn is None:
        loss_fn = MultiStepMultiMasksAndIous(
            DEFAULT_WEIGHTS, supervise_all_iou=True, iou_use_l1_loss=True,
            pred_obj_scores=cfg.pred_obj_scores)
    default_schedule = schedule
    group = None if mesh is None else mesh.get_group()
    world = 1 if mesh is None else dist.get_world_size(group)
    if fsdp and mesh is None:
        raise ValueError("fsdp=True needs a mesh")
    forward = _TrainForward(model, cfg)
    replicated = []
    if fsdp:
        replicated = _fully_shard(forward, mesh, fsdp_min_size)
        optimizer.rebind(model.named_parameters())
    elif mesh is not None:
        cards = None  # CPU: DDP takes no device ids
        if device.type == "cuda":  # "cuda" alone: this rank's card (set_device)
            cards = [device.index if device.index is not None
                     else torch.cuda.current_device()]
        forward = nn.parallel.DistributedDataParallel(
            forward, device_ids=cards, process_group=group, find_unused_parameters=True)

    def step(images, gt_masks, generator: Optional[torch.Generator] = None,
             schedule: Optional[PromptSchedule] = None) -> Dict[str, torch.Tensor]:
        images = torch.as_tensor(images).to(device=device, dtype=torch.float32)
        gt_masks = torch.as_tensor(gt_masks).to(device=device, dtype=torch.float32)
        optimizer.zero_grad()
        schedule = schedule if schedule is not None else default_schedule
        trains = _trains(cfg, schedule, prompt_kind, images.shape[0])
        with torch.set_grad_enabled(trains):
            outs = forward(images, gt_masks, generator=generator, schedule=schedule,
                           prompt_kind=prompt_kind,
                           num_correction_steps=num_correction_steps)
        gt_rows = gt_masks
        if gt_rows.ndim == 5:  # [T, B, K, H, W] -> [T, B*K, H, W]
            gt_rows = gt_rows.reshape(gt_rows.shape[0], -1, *gt_rows.shape[3:])
        num_objects = None
        if mesh is not None:
            # the reference's all-reduce (loss_fns.py:171-174): each rank
            # divides by the global count over the ranks, so that DDP's
            # average of the ranks' gradients is the gradient of the global
            # loss (JAX counts the global batch's rows, loss_fns.py:5-8)
            count = (gt_rows > 0).flatten(2).any(2).any(0).sum().float()
            dist.all_reduce(count, group=group)
            num_objects = count.clamp_min(1.0) / world
        losses = loss_fn(outs, gt_rows, num_objects=num_objects)
        if trains:
            losses[CORE_LOSS_KEY].backward()
        if replicated:  # FSDP's unsharded parameters: average as DDP would
            for p in replicated:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            flat = torch.cat([p.grad.reshape(-1) for p in replicated])
            dist.all_reduce(flat, group=group)
            flat /= world
            for p, g in zip(replicated, flat.split([p.numel() for p in replicated])):
                p.grad.copy_(g.view_as(p.grad))
        grad_norm = optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        if mesh is not None:
            keys = sorted(metrics)
            vals = torch.stack([metrics[k].float() for k in keys])
            dist.all_reduce(vals, group=group)
            metrics = dict(zip(keys, vals / world))
        metrics["grad_norm"] = grad_norm.detach()
        return metrics

    return step
