"""Trainer: epoch loop, data-parallel steps, checkpoints, meters.

Counterpart of the JAX package's ``training/trainer.py`` (after the
reference's training/trainer.py: Trainer :141, run :499, train_epoch :703,
_run_step :845, save_checkpoint :324, load_checkpoint :382). The trainer
trains ``engine.model`` in place (fp32), so the engine tracks with the
trained weights; the JAX package keeps a separate params tree instead.
  * data parallelism: a ``parallel.mesh`` mesh makes the step
    DistributedDataParallel over its ranks, each stepping on its rows;
  * checkpoints: ``torch.save`` files ``ckpt_{epoch:04d}.pt`` holding the
    model's state dict, the optimizer's state and step count, the epoch and
    the global step, written to a temporary name and renamed into place;
  * the schedule rng ``np.random.default_rng(seed)`` and the step seeds
    ``seed * 100003 + global_step`` are the JAX trainer's, so the port
    samples the same prompt schedules;
  * meters, ``scalars.jsonl`` and TensorBoard when it is importable; the
    NaN / Inf abort (reference trainer.py:874-878); auto-resume and the
    SIGTERM checkpoint with exit 143 (the requeue story of ``launch``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from det_sam2_tpu_torch.configs import SAM2Config
from det_sam2_tpu_torch.parallel.mesh import shard_batch
from det_sam2_tpu_torch.track import SAM2Engine
from det_sam2_tpu_torch.training.loss_fns import (
    CORE_LOSS_KEY,
    DEFAULT_WEIGHTS,
    MultiStepMultiMasksAndIous,
)
from det_sam2_tpu_torch.training.sam2_train import (
    PromptSchedule,
    PromptSimConf,
    forward_training,
    sample_prompt_schedule,
)
from det_sam2_tpu_torch.training.train_step import (
    OptimConf,
    make_optimizer,
    make_train_step,
)

logger = logging.getLogger("det_sam2_tpu_torch.trainer")


@dataclasses.dataclass
class TrainerConf:
    num_epochs: int = 1
    steps_per_epoch: int = 100
    log_every: int = 10
    checkpoint_every_epochs: int = 1
    checkpoint_dir: Optional[str] = None
    # legacy single-knob mode (one prompt kind per step, corrections on the
    # init frame only); superseded by prompt_sim
    prompt_kind_probs: dict = dataclasses.field(
        default_factory=lambda: {"box": 0.5, "point": 0.3, "mask": 0.2}
    )
    num_correction_steps: int = 2
    # the reference's prompt simulation (SAM2Train prepare_prompt_inputs),
    # sampled per step; when set, prompt_kind_probs is ignored
    prompt_sim: Optional[PromptSimConf] = None
    clip_length: int = 8  # frames per clip
    seed: int = 0
    # requeue / preemption: run() first restores the newest ckpt_* under
    # checkpoint_dir, and a SIGTERM checkpoints the current epoch before the
    # process exits 143 so that the relaunched job resumes there
    auto_resume: bool = False
    checkpoint_on_sigterm: bool = False


class AverageMeter:
    """(training/utils/train_utils.py:158-180)"""

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.sum += val * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)


def human_readable_time(time_seconds: float) -> str:
    """(train_utils.py:224-229)"""
    t = int(time_seconds)
    minutes, seconds = divmod(t, 60)
    hours, minutes = divmod(minutes, 60)
    days, hours = divmod(hours, 24)
    return f"{days:02}d {hours:02}h {minutes:02}m"


class MemMeter:
    """Peak device memory in GiB per update
    (train_utils.py:185-222: torch.cuda.max_memory_allocated); 0 for a CPU
    device."""

    def __init__(self, name: str, device=None):
        self.name = name
        self.device = device
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.peak = 0.0

    def update(self, n: int = 1):
        dev = torch.device(self.device) if self.device is not None else (
            torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu"))
        self.val = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                    if dev.type == "cuda" else 0.0)
        self.sum += self.val * n
        self.count += n
        self.peak = max(self.peak, self.val)

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.name}: {self.val:.2f} ({self.avg:.2f}/{self.peak:.2f})"


class DurationMeter:
    """(train_utils.py:232-249)"""

    def __init__(self, name: str):
        self.name = name
        self.val = 0.0

    def reset(self):
        self.val = 0.0

    def update(self, val: float):
        self.val = val

    def add(self, val: float):
        self.val += val

    def __str__(self):
        return f"{self.name}: {human_readable_time(self.val)}"


class ProgressMeter:
    """Formats '[batch/total] | meter | meter' lines
    (train_utils.py:252-281)."""

    def __init__(self, num_batches: int, meters, prefix: str = ""):
        digits = len(str(num_batches))
        self._fmt = "[{:" + str(digits) + "d}/" + str(num_batches) + "]"
        self.meters = meters
        self.prefix = prefix

    def format(self, batch: int) -> str:
        entries = [self.prefix + self._fmt.format(batch)]
        for m in self.meters:
            if isinstance(m, AverageMeter):
                entries.append(f"{m.name}: {m.avg:.4f}")
            else:
                entries.append(str(m))
        return " | ".join(entries)

    def display(self, batch: int) -> None:
        logger.info("%s", self.format(batch))


def kind_schedule(kind: str, num_correction_steps: int) -> PromptSchedule:
    """The schedule of the legacy one-kind-per-step mode (a box, a click or
    the GT mask on frame 0, corrections on frame 0 except for masks), as
    ``forward_training`` builds it from prompt_kind."""
    ncs = num_correction_steps if kind != "mask" else 0
    return PromptSchedule(
        init_cond_frames=(0,), frames_to_correct=(0,) if ncs > 0 else (),
        use_pt_input=kind != "mask", use_box_per_frame=(kind == "box",),
        num_correction_pt=ncs)


def schedule_kind(schedule: PromptSchedule) -> str:
    """'pt/cond2/corr2'-style label of a sampled schedule."""
    return (("pt" if schedule.use_pt_input else "mask")
            + f"/cond{len(schedule.init_cond_frames)}"
            + f"/corr{len(schedule.frames_to_correct)}")


class Trainer:
    def __init__(
        self,
        cfg: SAM2Config,
        engine: SAM2Engine,
        optim_conf: Optional[OptimConf] = None,
        trainer_conf: Optional[TrainerConf] = None,
        mesh=None,
        loss_fn: Optional[MultiStepMultiMasksAndIous] = None,
    ):
        """engine: an fp32 SAM2Engine (its device is the trainer's); its
        model trains in place. mesh: ``parallel.mesh.make_mesh()`` for data
        parallelism over the process group's ranks, None for one process.
        loss_fn: the recipe's loss (default: DEFAULT_WEIGHTS)."""
        if engine.dtype != torch.float32:
            raise ValueError("the trainer trains fp32 parameters: build the engine "
                             "with dtype=torch.float32")
        self.cfg = cfg
        self.engine = engine
        self.model = engine.model
        self.device = engine.device
        self.optim_conf = optim_conf or OptimConf()
        self.conf = trainer_conf or TrainerConf()
        self.mesh = mesh
        self.loss_fn = loss_fn or MultiStepMultiMasksAndIous(
            DEFAULT_WEIGHTS, supervise_all_iou=True, iou_use_l1_loss=True,
            pred_obj_scores=cfg.pred_obj_scores)
        self.optimizer = make_optimizer(self.optim_conf, self.model, cfg)
        self._step = make_train_step(cfg, self.model, self.optimizer,
                                     loss_fn=self.loss_fn, device=self.device, mesh=mesh)
        self.global_step = 0
        self.start_epoch = 0
        self._tb = None
        if self.conf.checkpoint_dir and self._is_writer:
            os.makedirs(self.conf.checkpoint_dir, exist_ok=True)
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # TensorBoard is optional
                pass
            else:
                self._tb = SummaryWriter(os.path.join(self.conf.checkpoint_dir, "tb"))

    @property
    def _is_writer(self) -> bool:
        """Rank 0 writes the checkpoints and scalars."""
        return self.mesh is None or dist.get_rank(self.mesh.get_group()) == 0

    @property
    def _world(self):
        if self.mesh is None:
            return 1, 0
        g = self.mesh.get_group()
        return dist.get_world_size(g), dist.get_rank(g)

    # ------------------------------------------------------------------
    # checkpointing (trainer.py:324-447)
    # ------------------------------------------------------------------

    def checkpoint_state(self, epoch: int) -> dict:
        """What a checkpoint holds: the model's state dict, the optimizer's
        (AdamW state and the schedule's step count), epoch, global step."""
        return {
            "model": self.model.state_dict(),
            "optimizer": {"adamw": self.optimizer.adamw.state_dict(),
                          "count": self.optimizer.count},
            "epoch": epoch,
            "global_step": self.global_step,
        }

    def save_checkpoint(self, epoch: int) -> None:
        if not self.conf.checkpoint_dir:
            return
        if self._is_writer:
            path = os.path.join(self.conf.checkpoint_dir, f"ckpt_{epoch:04d}.pt")
            tmp = path + ".tmp"
            torch.save(self.checkpoint_state(epoch), tmp)
            # a rename never leaves a partial ckpt_NNNN.pt for resume to pick
            os.replace(tmp, path)
            logger.info("saved checkpoint %s", path)
        if self.mesh is not None:
            dist.barrier(self.mesh.get_group())

    def load_checkpoint(self, path: str) -> None:
        # read to the host: load_state_dict copies the parameters and the
        # Adam moments to their parameters' device and keeps the step
        # counts on the host, as the live optimizer holds them
        state = torch.load(path, map_location="cpu", weights_only=True)
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.adamw.load_state_dict(state["optimizer"]["adamw"])
        self.optimizer.count = int(state["optimizer"]["count"])
        self.start_epoch = int(state["epoch"]) + 1
        self.global_step = int(state["global_step"])
        logger.info("restored checkpoint %s (epoch %d)", path, self.start_epoch)

    def latest_checkpoint(self) -> Optional[str]:
        """Newest ckpt_NNNN.pt under checkpoint_dir, or None; the exact
        name only, never a temporary file of a killed save."""
        if not self.conf.checkpoint_dir or not os.path.isdir(self.conf.checkpoint_dir):
            return None
        names = sorted(n for n in os.listdir(self.conf.checkpoint_dir)
                       if re.fullmatch(r"ckpt_\d+\.pt", n))
        return os.path.join(self.conf.checkpoint_dir, names[-1]) if names else None

    # ------------------------------------------------------------------

    def _log_scalars(self, scalars: dict) -> None:
        if not self._is_writer:
            return
        if self.conf.checkpoint_dir:
            with open(os.path.join(self.conf.checkpoint_dir, "scalars.jsonl"), "a") as f:
                f.write(json.dumps(scalars) + "\n")
        if self._tb is not None:
            for k, v in scalars.items():
                if isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, self.global_step)

    def _pick_prompt_kind(self, rng: np.random.Generator) -> str:
        kinds = list(self.conf.prompt_kind_probs)
        probs = np.asarray([self.conf.prompt_kind_probs[k] for k in kinds], np.float64)
        probs = probs / probs.sum()
        return str(rng.choice(kinds, p=probs))

    def _generator(self) -> torch.Generator:
        """This step's generator: the JAX trainer's step key
        seed * 100003 + global_step, one stream per rank."""
        world, rank = self._world
        g = torch.Generator(device=self.device)
        return g.manual_seed((self.conf.seed * 100003 + self.global_step) * world + rank)

    def _reduce(self, values: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        if self.mesh is not None:
            dist.all_reduce(values, op=op, group=self.mesh.get_group())
        return values

    @torch.no_grad()
    def validate(self, data_loader, num_batches: int = 10) -> dict:
        """Validation pass (reference val_epoch, trainer.py:583-): the
        GT-mask-prompted tracking loss and the mean IoU of the final masks
        over the batch, no gradients, no drop-path."""
        loss_meter = AverageMeter("val_loss")
        iou_meter = AverageMeter("val_iou")
        cfg = dataclasses.replace(self.cfg, hiera=dataclasses.replace(
            self.cfg.hiera, drop_path_rate=0.0))
        world, _ = self._world
        was_training = self.model.training
        self.model.eval()
        try:
            for images, gt in data_loader.batches(num_batches):
                images, gt = shard_batch(self.mesh, (images, gt), axis=1)
                images = torch.as_tensor(images).to(self.device, torch.float32)
                gt = torch.as_tensor(gt).to(self.device, torch.float32)
                outs = forward_training(self.model, cfg, images, gt, prompt_kind="mask")
                rows = gt.reshape(gt.shape[0], -1, *gt.shape[-2:])
                count = self._reduce((rows > 0).flatten(2).any(2).any(0).sum().float())
                losses = self.loss_fn(outs, rows, num_objects=count.clamp_min(1.0) / world)
                inter = sum(((o["pred_masks_high_res"][:, 0] > 0) & (g > 0)).sum()
                            for o, g in zip(outs, rows))
                union = sum(((o["pred_masks_high_res"][:, 0] > 0) | (g > 0)).sum()
                            for o, g in zip(outs, rows))
                vals = self._reduce(torch.stack([losses[CORE_LOSS_KEY].float(),
                                                 inter.float(), union.float()]))
                loss_meter.update(float(vals[0]) / world)
                iou_meter.update(float(vals[1] / vals[2].clamp_min(1.0)))
        finally:
            self.model.train(was_training)
        out = {"val_loss": loss_meter.avg, "val_iou": iou_meter.avg}
        self._log_scalars({"step": self.global_step, **out})
        return out

    @torch.no_grad()
    def validate_jf(self, videos, max_frame_num_to_track=None) -> dict:
        """Video-tracking validation: J&F on held-out clips with the current
        weights. Each clip is tracked through the full video predictor over
        the trained module (first-appearance mask prompts, the
        semi-supervised VOS protocol) and scored with
        tools/sav_benchmark.evaluate_videos. The predictor makes every bank
        and cache anew from the current weights; the module is put in eval
        mode and back.

        videos: iterable of (frames, gt_per_obj), frames [T, H, W, 3] uint8,
        gt_per_obj {obj_id: [T, H, W] bool}. -> {"val_J", "val_F", "val_JF"}.
        """
        from det_sam2_tpu_torch.tools.sav_benchmark import evaluate_videos
        from det_sam2_tpu_torch.video_predictor import SAM2VideoPredictor

        was_training = self.model.training
        self.model.eval()
        try:
            predictor = SAM2VideoPredictor(self.engine)
            results = {}
            for vid, (frames, gt_per_obj) in enumerate(videos):
                session = predictor.init_state(list(np.asarray(frames)))
                for obj_id, gt in sorted(gt_per_obj.items()):
                    first = next((t for t in range(len(gt)) if np.any(gt[t])), 0)
                    predictor.add_new_mask(session, first, obj_id, gt[first])
                preds = {obj_id: [np.zeros(g[0].shape, bool) for _ in g]
                         for obj_id, g in gt_per_obj.items()}
                for frame_idx, obj_ids, masks in predictor.propagate_in_video(
                        session, max_frame_num_to_track=max_frame_num_to_track):
                    for i, obj_id in enumerate(obj_ids):
                        if obj_id in preds:
                            preds[obj_id][frame_idx] = np.asarray(masks[i, 0]) > 0
                results[f"video_{vid}"] = {
                    obj_id: (list(np.asarray(gt, bool)), preds[obj_id])
                    for obj_id, gt in gt_per_obj.items()
                }
        finally:
            self.model.train(was_training)
        scores = evaluate_videos(results)
        out = {"val_J": scores["J"], "val_F": scores["F"], "val_JF": scores["J&F"]}
        self._log_scalars({"step": self.global_step, **out})
        return out

    def run(self, data_loader) -> None:
        """data_loader: an object with .batches(n) -> iterator of (images
        [T, B, S, S, 3], gt [T, B(, K), S, S]) numpy pairs: the global
        batch, or this rank's rows (``launch.DistributedDataLoader``)."""
        if self.conf.auto_resume:
            latest = self.latest_checkpoint()
            if latest is not None:
                self.load_checkpoint(latest)

        self._current_epoch = self.start_epoch
        sigterm_prev = None
        if self.conf.checkpoint_on_sigterm:
            import signal

            def _on_sigterm(signum, frame):
                logger.warning("SIGTERM: checkpointing epoch %d before exit",
                               self._current_epoch)
                self.save_checkpoint(self._current_epoch - 1)
                raise SystemExit(143)

            sigterm_prev = signal.signal(signal.SIGTERM, _on_sigterm)
        try:
            self._run_epochs(data_loader)
        finally:
            if sigterm_prev is not None:
                import signal

                signal.signal(signal.SIGTERM, sigterm_prev)

    def _run_epochs(self, data_loader) -> None:
        rng = np.random.default_rng(self.conf.seed)
        self.model.train()
        for epoch in range(self.start_epoch, self.conf.num_epochs):
            self._current_epoch = epoch
            meter = AverageMeter("core_loss")
            tic = time.time()
            for i, (images, gt) in enumerate(data_loader.batches(self.conf.steps_per_epoch)):
                if self.conf.prompt_sim is not None:
                    schedule = sample_prompt_schedule(rng, int(images.shape[0]),
                                                      self.conf.prompt_sim)
                    kind = schedule_kind(schedule)
                else:
                    kind = self._pick_prompt_kind(rng)
                    schedule = kind_schedule(kind, self.conf.num_correction_steps)
                images, gt = shard_batch(self.mesh, (images, gt), axis=1)
                metrics = self._step(images, gt, self._generator(), schedule=schedule)
                loss = float(metrics[CORE_LOSS_KEY])
                if not np.isfinite(loss):
                    # NaN / Inf abort (trainer.py:874-878)
                    raise FloatingPointError(f"loss is {loss} at step {self.global_step}")
                meter.update(loss)
                self.global_step += 1
                if (i + 1) % self.conf.log_every == 0:
                    scalars = {
                        "epoch": epoch,
                        "step": self.global_step,
                        "loss": meter.avg,
                        "grad_norm": float(metrics["grad_norm"]),
                        "steps_per_sec": (i + 1) / (time.time() - tic),
                        "prompt_kind": kind,
                    }
                    logger.info("%s", scalars)
                    self._log_scalars(scalars)
            if (epoch + 1) % self.conf.checkpoint_every_epochs == 0:
                self.save_checkpoint(epoch)
        self.model.eval()
