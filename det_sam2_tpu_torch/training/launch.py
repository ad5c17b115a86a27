"""Multi-process training entry: torch.distributed + rank-local data.

Counterpart of the JAX package's ``training/launch.py`` (after the
reference's training/train.py:28-123: one process per card, NCCL
rendezvous, a requeue supervisor). Start it with torchrun, which sets
RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT:

    torchrun --nproc-per-node 4 -m det_sam2_tpu_torch.training.launch \\
        --img-folder MOSE/train/JPEGImages --gt-folder MOSE/train/Annotations

or give each process --coordinator-address host:port, --num-processes and
--process-id. Without either the run is one process (world size 1, no
process group). Each process loads and augments its own clips (its own
loader seed) and steps on them; DistributedDataParallel averages the
gradients. ``main`` reads image files with PIL.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from det_sam2_tpu_torch.parallel.mesh import RankLocal, make_mesh

logger = logging.getLogger("det_sam2_tpu_torch.launch")

# Exit code the Trainer raises after its SIGTERM checkpoint (SystemExit 143
# in Trainer.run); the supervisor treats it as "requeue me".
REQUEUE_EXIT_CODE = 143


def supervise(cmd: Sequence[str], max_requeues: int = 16,
              env: Optional[dict] = None) -> int:
    """Requeue supervisor (the reference's SubmititRunner requeue,
    training/train.py:68-103): run the command, and while it exits with
    REQUEUE_EXIT_CODE (the trainer's SIGTERM checkpoint) run it again, up
    to max_requeues times; auto_resume picks up the checkpoint. Any other
    exit code is final and returned. SIGTERM / SIGINT delivered to the
    supervisor are forwarded to the child (whose handler checkpoints and
    exits 143), and the supervisor survives them to relaunch."""
    import signal
    import subprocess

    requeues = 0
    while True:
        proc = subprocess.Popen(list(cmd), env=env)

        def _forward(signum, frame):
            try:
                proc.send_signal(signum)
            except (ProcessLookupError, OSError):
                pass

        prev = {s: signal.signal(s, _forward) for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            rc = proc.wait()
        finally:
            for s, h in prev.items():
                signal.signal(s, h)
        if rc != REQUEUE_EXIT_CODE:
            return rc
        requeues += 1
        if requeues > max_requeues:
            logger.error("requeue budget exhausted (%d); giving up", max_requeues)
            return rc
        logger.warning("preemption exit (%d): requeue %d/%d", rc, requeues, max_requeues)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None) -> Tuple[int, int]:
    """Join the process group; returns (rank, world size).

    coordinator_address ("host:port"), num_processes and process_id, or
    else torchrun's RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT. With
    neither, a single process stays without a process group: (0, 1).
    device: "cuda" (None, the default: NCCL, and this process's card is
    LOCAL_RANK, or the rank) or "cpu" (gloo)."""
    env = os.environ
    if coordinator_address is None and num_processes is None:
        if "RANK" not in env or "WORLD_SIZE" not in env:
            return 0, 1
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        init_method = "env://"
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("give the coordinator address, the process count "
                             "and this process's id together")
        rank, world = int(process_id), int(num_processes)
        init_method = f"tcp://{coordinator_address}"
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed runs NCCL on CUDA and no CUDA device "
                               "is available; pass device='cpu' for gloo")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group("gloo" if on_cpu else "nccl", init_method=init_method,
                            rank=rank, world_size=world)
    return rank, world


def make_global_mesh(device=None):
    """The 1-D ``data`` mesh over every rank of the process group, or None
    when there is none (one process)."""
    if not dist.is_initialized():
        return None
    on_cpu = device is not None and torch.device(device).type == "cpu"
    return make_mesh("cpu" if on_cpu else "cuda")


def host_local_batch_to_global(mesh, arrays, axis: int = 1):
    """Each process's local batch is its rows of the global batch. JAX
    assembles a global array from them; under DDP each rank keeps and steps
    on its own rows, so this is the identity, marked ``RankLocal`` so that
    ``shard_batch`` does not split it again."""
    return RankLocal(arrays)


class DistributedDataLoader:
    """A host loader whose batches are this rank's rows of the global batch
    (the reference's per-rank DistributedSampler): each process gives its
    own loader its own seed."""

    def __init__(self, loader, mesh):
        self.loader = loader
        self.mesh = mesh

    def batches(self, n: int):
        for images, gt in self.loader.batches(n):
            yield host_local_batch_to_global(self.mesh, (images, gt), axis=1)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CLI with the JAX launcher's flags (the reference launcher's surface);
    the dataset root has the MOSE / DAVIS layout. --device cpu runs on the
    CPU (gloo); the default is CUDA."""
    # allow_abbrev=False: the supervisor strips the literal "--supervise"
    # token from the children's argv; an abbreviation would survive it
    p = argparse.ArgumentParser(description="det_sam2_tpu_torch trainer",
                                allow_abbrev=False)
    p.add_argument("--img-folder", required=True)
    p.add_argument("--gt-folder", required=True)
    p.add_argument("--model", default="hiera_b+",
                   choices=["hiera_t", "hiera_s", "hiera_b+", "hiera_l"])
    p.add_argument("--image-size", type=int, default=1024)
    p.add_argument("--num-epochs", type=int, default=40)
    p.add_argument("--steps-per-epoch", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=1, help="per process")
    p.add_argument("--num-frames", type=int, default=8)
    p.add_argument("--max-objects", type=int, default=3)
    p.add_argument("--base-lr", type=float, default=5e-6)
    p.add_argument("--vision-lr", type=float, default=3e-6)
    p.add_argument("--layer-decay", type=float, default=0.9)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--restore", default=None)
    p.add_argument("--torch-ckpt", default=None,
                   help="SAM 2.1 .pt (or a port checkpoint) to finetune from")
    p.add_argument("--coordinator-address", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument(
        "--supervise", type=int, default=0, metavar="N",
        help="run under the requeue supervisor: relaunch this command up to N "
        f"times while it exits with the preemption code ({REQUEUE_EXIT_CODE})",
    )
    args = p.parse_args(argv)

    if args.supervise:
        import sys

        rest = list(argv) if argv is not None else sys.argv[1:]
        rest = [a for i, a in enumerate(rest)
                if not (a.startswith("--supervise")
                        or (i > 0 and rest[i - 1] == "--supervise"))]
        raise SystemExit(supervise(
            [sys.executable, "-m", "det_sam2_tpu_torch.training.launch", *rest],
            max_requeues=args.supervise,
        ))

    rank, world = init_distributed(args.coordinator_address, args.num_processes,
                                   args.process_id, device=args.device)
    logger.info("process %d/%d", rank, world)

    from det_sam2_tpu_torch.build import build_sam2_engine
    from det_sam2_tpu_torch.configs import MODEL_CONFIGS, with_image_size
    from det_sam2_tpu_torch.training.dataset import (
        PNGRawDataset,
        RandomUniformSampler,
        VOSDataLoader,
    )
    from det_sam2_tpu_torch.training.sam2_train import PromptSimConf
    from det_sam2_tpu_torch.training.train_step import OptimConf
    from det_sam2_tpu_torch.training.trainer import Trainer, TrainerConf

    cfg = with_image_size(MODEL_CONFIGS[args.model](), args.image_size)
    engine = build_sam2_engine(cfg, checkpoint=args.torch_ckpt, dtype=torch.float32,
                               device=args.device)
    mesh = make_global_mesh(args.device)
    loader = VOSDataLoader(
        PNGRawDataset(args.img_folder, args.gt_folder),
        RandomUniformSampler(num_frames=args.num_frames, max_num_objects=args.max_objects),
        image_size=args.image_size,
        batch_size=args.batch_size,
        affine_prob=1.0,
        grayscale_prob=0.05,
        seed=1000 + rank,  # per-process data stream
    )
    trainer = Trainer(
        cfg, engine,
        optim_conf=OptimConf(
            base_lr=args.base_lr, vision_lr=args.vision_lr,
            layer_decay=args.layer_decay,
            total_steps=args.num_epochs * args.steps_per_epoch,
        ),
        trainer_conf=TrainerConf(
            num_epochs=args.num_epochs, steps_per_epoch=args.steps_per_epoch,
            checkpoint_dir=args.checkpoint_dir, prompt_sim=PromptSimConf(),
            clip_length=args.num_frames,
        ),
        mesh=mesh,
    )
    if args.restore:
        trainer.load_checkpoint(args.restore)
    trainer.run(DistributedDataLoader(loader, mesh) if mesh is not None else loader)


if __name__ == "__main__":
    main()
