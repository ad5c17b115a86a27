"""The port's launcher and data parallelism on the CPU (gloo).

The requeue supervisor; init_distributed alone, with explicit arguments and
from torchrun's environment; shard_batch / RankLocal / DistributedDataLoader;
two gloo processes (started as torchrun would start them) taking a
DistributedDataParallel step and a fully_shard step on their halves of a
batch, against one process's step on the whole batch: the global batch has
object rows that are empty on one rank only, so each rank's own count of
valid rows differs from the other's and only the all-reduced count gives
the single process's loss normaliser. Then the CLI on a tiny PNG layout.
The parallel steps need only the port, so this file imports no JAX.
"""

import os
import signal
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from det_sam2_tpu_torch import convert
from det_sam2_tpu_torch.configs import tiny_test_config
from det_sam2_tpu_torch.modeling.sam2_base import SAM2Model
from det_sam2_tpu_torch.parallel.mesh import RankLocal, make_mesh, shard_batch
from det_sam2_tpu_torch.training import launch
from det_sam2_tpu_torch.training.sam2_train import PromptSchedule
from det_sam2_tpu_torch.training.train_step import OptimConf, make_optimizer, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 128
# GT-mask prompts: the step draws nothing at random, so the ranks' steps and
# the single process's are one computation in another summation order
SCHEDULE = PromptSchedule(init_cond_frames=(0,), use_pt_input=False,
                          use_box_per_frame=(False,))
OPTIM = OptimConf(base_lr=1e-4, warmup_steps=0, total_steps=10)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_model():
    cfg = tiny_test_config()
    m = SAM2Model(cfg)
    sd = convert.init_params(m, 3)
    sd["sam_mask_decoder.pred_obj_score_head.layers.2.bias"].fill_(1.0)
    m.load_state_dict(sd)
    return cfg, m


def make_batch():
    """[T=3, B=2 videos, K=2 objects] clips; video 1's second object is
    empty, so rank 0 holds two valid rows and rank 1 one."""
    rng = np.random.default_rng(0)
    t, b, k = 3, 2, 2
    images = (rng.standard_normal((t, b, S, S, 3)) * 0.3).astype(np.float32)
    gt = np.zeros((t, b, k, S, S), np.float32)
    for i in range(t):
        gt[i, 0, 0, 20 + 3 * i:60 + 3 * i, 30:80] = 1
        gt[i, 0, 1, 70:100, 10:50] = 1
        gt[i, 1, 0, 40:90, 40 + 2 * i:90 + 2 * i] = 1
    return images, gt


def one_step(mesh=None, fsdp=False):
    """(metrics, full state dict after the step) of one MOSE-optimizer step."""
    from torch.distributed.tensor import DTensor

    cfg, m = make_model()
    opt = make_optimizer(OPTIM, m)
    step = make_train_step(cfg, m, opt, device="cpu", mesh=mesh, fsdp=fsdp)
    images, gt = shard_batch(mesh, make_batch(), axis=1)
    met = step(images, gt, torch.Generator().manual_seed(0), schedule=SCHEDULE)
    sd = {k: (v.full_tensor() if isinstance(v, DTensor) else v).detach().clone()
          for k, v in m.state_dict().items()}
    return {k: float(v) for k, v in met.items()}, sd


WORKER = textwrap.dedent("""
    import sys, torch
    torch.set_num_threads(1)
    sys.path.insert(0, {tests!r})
    from test_torch_launch import one_step
    from det_sam2_tpu_torch.training import launch
    rank, world = launch.init_distributed(device="cpu")
    mesh = launch.make_global_mesh("cpu")
    out = {{"rank": rank, "world": world, "ranks": mesh.size()}}
    for mode in ("ddp", "fsdp"):
        out[mode] = one_step(mesh, fsdp=mode == "fsdp")
    if rank == 0:
        torch.save(out, {path!r})
    torch.distributed.destroy_process_group()
""")


@pytest.fixture(scope="module")
def two_rank_steps(tmp_path_factory):
    """Both parallel steps from two gloo processes started with torchrun's
    environment, and the single-process step on the whole batch."""
    path = str(tmp_path_factory.mktemp("ranks") / "rank0.pt")
    port = free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        code = WORKER.format(tests=os.path.join(REPO, "tests"), path=path)
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    for p in procs:
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0, out[-3000:]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = one_step()
    finally:
        torch.set_num_threads(n)
    return torch.load(path, weights_only=False), single


def _same_step(got, want):
    gm, gsd = got
    wm, wsd = want
    assert set(gm) == set(wm)
    for k in wm:  # loss terms and the gradient norm of the global batch
        np.testing.assert_allclose(gm[k], wm[k], rtol=2e-6, err_msg=k)
    init = make_model()[1].state_dict()
    moved = 0
    for k, v in wsd.items():
        # AdamW's first step moves every parameter by ~lr; the ranks' sums
        # of the averaged gradient round differently, nothing more
        torch.testing.assert_close(gsd[k], v, atol=2e-7, rtol=1e-6, msg=k)
        moved += not torch.equal(v, init[k])
    assert moved > 100


def test_ranks_hold_unequal_object_counts():
    images, gt = make_batch()
    rows = gt.reshape(gt.shape[0], -1, S, S)
    assert (rows > 0).any((0, 2, 3)).tolist() == [True, True, True, False]


def test_ddp_step_equals_the_single_process_step(two_rank_steps):
    ranks, single = two_rank_steps
    assert (ranks["rank"], ranks["world"], ranks["ranks"]) == (0, 2, 2)
    _same_step(ranks["ddp"], single)


def test_fsdp_step_equals_the_single_process_step(two_rank_steps):
    """fully_shard over gloo: every trunk block, the image encoder, memory
    attention and memory encoder, and the rest; parameters under 16384
    elements replicated with their gradients averaged by the step; the
    clip's norm reduced over the ranks."""
    ranks, single = two_rank_steps
    _same_step(ranks["fsdp"], single)
    np.testing.assert_allclose(ranks["fsdp"][0]["grad_norm"], ranks["ddp"][0]["grad_norm"],
                               rtol=2e-6)


def test_init_distributed_alone_and_with_arguments():
    """No torchrun environment and no arguments: one process, no group. With
    a coordinator, count and id: a gloo group of one, a 1-D 'data' mesh,
    and shard_batch handing the whole batch to the only rank."""
    env_keys = ("RANK", "WORLD_SIZE")
    saved = {k: os.environ.pop(k) for k in env_keys if k in os.environ}
    try:
        assert launch.init_distributed() == (0, 1)
        assert not dist.is_initialized() and launch.make_global_mesh("cpu") is None
        with pytest.raises(ValueError, match="together"):
            launch.init_distributed("127.0.0.1:1", 1)
        assert launch.init_distributed(f"127.0.0.1:{free_port()}", 1, 0, device="cpu") == (0, 1)
        try:
            mesh = make_mesh("cpu")
            assert mesh.mesh_dim_names == ("data",) and mesh.size() == 1
            images, gt = make_batch()
            got = shard_batch(mesh, (images, gt), axis=1)
            assert got[0] is not images and np.array_equal(got[0], images)
        finally:
            dist.destroy_process_group()
    finally:
        os.environ.update(saved)


def test_rank_local_batches_pass_through():
    """Under the launcher each process's loader yields its own rows:
    DistributedDataLoader marks them RankLocal and shard_batch leaves them
    whole; without a mesh a batch passes as it is."""
    images, gt = make_batch()

    class Loader:
        def batches(self, n):
            for _ in range(n):
                yield images, gt

    (batch,) = list(launch.DistributedDataLoader(Loader(), mesh=None).batches(1))
    assert isinstance(batch, RankLocal)
    out = shard_batch(object(), batch, axis=1)
    assert out[0] is images and out[1] is gt
    assert shard_batch(None, (images, gt)) == (images, gt)


def test_supervise_requeues_until_clean_exit(tmp_path):
    counter = tmp_path / "launches"
    child = tmp_path / "child.py"
    child.write_text(textwrap.dedent(f"""
        import pathlib, sys
        p = pathlib.Path({str(counter)!r})
        n = int(p.read_text()) if p.exists() else 0
        p.write_text(str(n + 1))
        sys.exit({launch.REQUEUE_EXIT_CODE} if n < 2 else 0)
    """))
    assert launch.supervise([sys.executable, str(child)], max_requeues=5) == 0
    assert counter.read_text() == "3"  # two preemptions, one clean run
    always = tmp_path / "always.py"
    always.write_text(f"import sys; sys.exit({launch.REQUEUE_EXIT_CODE})")
    assert launch.supervise([sys.executable, str(always)], max_requeues=2) == \
        launch.REQUEUE_EXIT_CODE


def test_supervise_forwards_sigterm_and_survives_to_requeue(tmp_path):
    running, preempted = tmp_path / "running", tmp_path / "preempted"
    child = tmp_path / "child.py"
    child.write_text(textwrap.dedent(f"""
        import pathlib, signal, sys, time
        preempted = pathlib.Path({str(preempted)!r})
        if preempted.exists():
            sys.exit(0)
        def on_term(signum, frame):
            preempted.write_text("checkpointed")
            sys.exit({launch.REQUEUE_EXIT_CODE})
        signal.signal(signal.SIGTERM, on_term)
        pathlib.Path({str(running)!r}).write_text("up")
        time.sleep(60)
        sys.exit(1)
    """))
    sup = subprocess.Popen([sys.executable, "-c", textwrap.dedent(f"""
        import sys
        from det_sam2_tpu_torch.training.launch import supervise
        sys.exit(supervise([sys.executable, {str(child)!r}], max_requeues=3))
    """)], cwd=REPO)
    deadline = time.time() + 60
    while not running.exists() and time.time() < deadline:
        time.sleep(0.05)
    assert running.exists()
    sup.send_signal(signal.SIGTERM)
    assert sup.wait(timeout=60) == 0
    assert preempted.read_text() == "checkpointed"


def _write_png_layout(root):
    from PIL import Image

    img_root, gt_root = os.path.join(root, "JPEGImages"), os.path.join(root, "Annotations")
    rng = np.random.default_rng(0)
    for vid in ("video_a", "video_b"):
        os.makedirs(os.path.join(img_root, vid))
        os.makedirs(os.path.join(gt_root, vid))
        for f in range(3):
            Image.fromarray(rng.integers(0, 256, (96, 112, 3), np.uint8)).save(
                os.path.join(img_root, vid, f"{f:05d}.jpg"))
            mask = np.zeros((96, 112), np.uint8)
            mask[10 + f:50 + f, 20:60] = 1
            Image.fromarray(mask).save(os.path.join(gt_root, vid, f"{f:05d}.png"))
    return img_root, gt_root


def test_main_cli_smoke(tmp_path, monkeypatch):
    """The CLI end to end on the CPU: tiny model, one epoch of one step with
    the recipe's augmentations over a PNG layout, a checkpoint written."""
    from det_sam2_tpu_torch import configs

    monkeypatch.setitem(configs.MODEL_CONFIGS, "hiera_t", lambda: tiny_test_config())
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    img_root, gt_root = _write_png_layout(str(tmp_path))
    ckpt_dir = str(tmp_path / "ckpts")
    try:
        launch.main(["--img-folder", img_root, "--gt-folder", gt_root, "--model", "hiera_t",
                     "--image-size", "128", "--num-epochs", "1", "--steps-per-epoch", "1",
                     "--batch-size", "1", "--num-frames", "2", "--max-objects", "1",
                     "--checkpoint-dir", ckpt_dir, "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    assert "ckpt_0000.pt" in os.listdir(ckpt_dir)
    state = torch.load(os.path.join(ckpt_dir, "ckpt_0000.pt"), weights_only=True)
    assert state["global_step"] == 1 and state["optimizer"]["count"] == 1
