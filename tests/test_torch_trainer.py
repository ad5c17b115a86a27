"""The port's Trainer vs the JAX package's, on the CPU.

Both trainers start from the same seeded weights (tiny_test_config, the
object-score bias at +1 as in tests/test_torch_train_step.py) and read the
same clips: each package's VOSDataLoader with one seed gives equal batches
(tests/test_torch_dataset.py). One epoch of GT-mask prompts without
drop-path has no random draw, so the two epochs are the same computation:
each step's logged loss and gradient norm must agree within the stated
tolerance. JAX runs on one device of its CPU mesh. The port's checkpoint
round trip, auto-resume, the SIGTERM checkpoint (in a subprocess) and the
NaN abort follow; validate and validate_jf are in
test_torch_trainer_validate.py, which shares these helpers. fp32, TF32 off.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from det_sam2_tpu.configs import tiny_test_config as jax_tiny_config
from det_sam2_tpu.parallel.mesh import make_mesh as jax_make_mesh
from det_sam2_tpu.track import SAM2Engine as JaxEngine
from det_sam2_tpu.training import dataset as jd
from det_sam2_tpu.training.train_step import OptimConf as JaxOptimConf
from det_sam2_tpu.training.trainer import Trainer as JaxTrainer
from det_sam2_tpu.training.trainer import TrainerConf as JaxTrainerConf

from det_sam2_tpu_torch import build, convert
from det_sam2_tpu_torch.configs import tiny_test_config
from det_sam2_tpu_torch.track import SAM2Engine
from det_sam2_tpu_torch.training import dataset as pd
from det_sam2_tpu_torch.training.train_step import OptimConf
from det_sam2_tpu_torch.training.trainer import (
    AverageMeter,
    DurationMeter,
    MemMeter,
    ProgressMeter,
    Trainer,
    TrainerConf,
    human_readable_time,
    kind_schedule,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3
# losses and gradient norms after up to three AdamW steps at lr 1e-4: the
# single forward agrees to 2e-3 + 1e-4 relative (test_torch_train_step.py);
# the updates differ by rounding only
LOSS_RTOL, NORM_RTOL = 1e-3, 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    params = jax.tree_util.tree_map(np.array, JaxEngine(jax_tiny_config(), seed=5).params)
    params["sam_mask_decoder"]["pred_obj_score_head"]["layers_2"]["bias"][:] = 1.0
    return params


def two_object_dataset(mod, **kw):
    """The package's SyntheticRawDataset with a second moving square."""

    class DS(mod.SyntheticRawDataset):
        def load_frames(self, video, names):
            clip = super().load_frames(video, names)
            h, w = self.hw
            for t, (f, per) in enumerate(zip(clip.frames, clip.masks)):
                y = 60 + 3 * t
                f[y:y + 30, 70:110] = (40, 200, 60)
                m = np.zeros((h, w), bool)
                m[y:y + 30, 70:110] = True
                per[2] = m
            return clip

    return DS(**kw)


def loader(mod, seed=0):
    return mod.VOSDataLoader(
        two_object_dataset(mod, num_videos=3, num_frames=5, hw=(128, 128), seed=seed),
        mod.RandomUniformSampler(num_frames=2, max_num_objects=2),
        image_size=128, batch_size=1, seed=seed)


def optim():
    return dict(base_lr=1e-4, total_steps=STEPS, warmup_steps=1)


def conf(ckdir, **kw):
    return dict(dict(num_epochs=1, steps_per_epoch=STEPS, log_every=1,
                     checkpoint_dir=None if ckdir is None else str(ckdir),
                     prompt_kind_probs={"mask": 1.0},
                     num_correction_steps=0), **kw)


def port_trainer(weights, ckdir, **kw):
    eng = SAM2Engine(tiny_test_config(), params=convert.from_jax_params(weights),
                     device="cpu")
    return Trainer(eng.cfg, eng, OptimConf(**optim()), TrainerConf(**conf(ckdir, **kw)))


def jax_trainer(weights, trainer_conf):
    """JAX's Trainer on one device of its CPU mesh, its parameters and
    optimizer state placed replicated on that mesh up front (as its steps
    return them, so the step compiles once)."""
    from jax.sharding import NamedSharding, PartitionSpec

    mesh = jax_make_mesh(devices=jax.devices()[:1])
    repl = NamedSharding(mesh, PartitionSpec())
    cfg = jax_tiny_config()
    jeng = JaxEngine(cfg, seed=5)
    jeng.params = jax.device_put(jax.tree_util.tree_map(jnp.asarray, weights), repl)
    jt = JaxTrainer(cfg, jeng, JaxOptimConf(**optim()), trainer_conf, mesh=mesh)
    jt.opt_state = jax.device_put(jt.opt_state, repl)
    return jt


def scalars(ckdir):
    with open(os.path.join(ckdir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def trained(weights, tmp_path_factory):
    """(port trainer after one epoch, its checkpoint dir, JAX's scalars)."""
    pdir = tmp_path_factory.mktemp("port")
    jt = jax_trainer(weights, JaxTrainerConf(**conf(None)))
    logged = []
    jt._log_scalars = logged.append  # JAX writes scalars.jsonl next to orbax files only
    jt.run(loader(jd))
    pt = port_trainer(weights, pdir)
    pt.run(loader(pd))
    return pt, str(pdir), logged


def test_epoch_losses_and_grad_norms_match_jax(trained):
    pt, pdir, want = trained
    got = scalars(pdir)
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert (g["epoch"], g["step"], g["prompt_kind"]) == (w["epoch"], w["step"],
                                                             w["prompt_kind"])
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=NORM_RTOL)
    assert got[0]["grad_norm"] > 0.1  # the clip was active
    assert pt.global_step == STEPS and pt.optimizer.count == STEPS


def _batch(seed=11):
    return next(iter(loader(pd, seed).batches(1)))


def test_checkpoint_round_trip_and_resumed_step(weights, trained, tmp_path):
    """A fresh trainer loaded from ckpt_0000.pt holds the saved parameters
    and optimizer state bit for bit; its next step equals the live
    trainer's on the same batch and step seed; build.py loads the file and
    the directory."""
    pt, pdir, _ = trained
    path = os.path.join(pdir, "ckpt_0000.pt")
    assert {"ckpt_0000.pt", "scalars.jsonl"} <= set(os.listdir(pdir))
    assert not [n for n in os.listdir(pdir) if n.endswith(".tmp")]
    live = port_trainer(weights, tmp_path / "live")
    live.load_checkpoint(path)  # the saved weights, for build.py below
    fresh = Trainer(live.cfg, SAM2Engine(tiny_test_config(), seed=123, device="cpu"),
                    OptimConf(**optim()), TrainerConf(**conf(tmp_path / "fresh")))
    fresh.load_checkpoint(path)
    assert (fresh.global_step, fresh.start_epoch, fresh.optimizer.count) == (STEPS, 1, STEPS)
    for (n, a), b in zip(pt.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), n
    sa, sb = pt.optimizer.adamw.state_dict(), fresh.optimizer.adamw.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    images, gt = _batch()
    sch = kind_schedule("box", 1)
    outs = []
    for t in (pt, fresh):
        m = t._step(images, gt, t._generator(), schedule=sch)
        outs.append(({k: v.clone() for k, v in m.items()},
                     {k: v.clone() for k, v in t.model.state_dict().items()}))
    for k in outs[0][0]:
        assert torch.equal(outs[0][0][k], outs[1][0][k]), k
    for k in outs[0][1]:
        assert torch.equal(outs[0][1][k], outs[1][1][k]), k
    for src in (path, pdir):
        eng = build.build_sam2_engine(tiny_test_config(), src, dtype=torch.float32,
                                      device="cpu")
        for n, v in eng.model.state_dict().items():
            assert torch.equal(v, live.model.state_dict()[n]), n


def test_auto_resume_skips_partial_files(weights, trained, tmp_path):
    """auto_resume picks the newest complete ckpt_NNNN.pt (never a
    temporary file of a killed save) and trains the remaining epoch."""
    _, pdir, _ = trained
    import shutil

    shutil.copy(os.path.join(pdir, "ckpt_0000.pt"), tmp_path / "ckpt_0000.pt")
    (tmp_path / "ckpt_0001.pt.tmp").write_bytes(b"partial")
    t = port_trainer(weights, tmp_path, num_epochs=2, auto_resume=True)
    assert t.latest_checkpoint() == str(tmp_path / "ckpt_0000.pt")
    t.run(loader(pd))
    assert (t.start_epoch, t.global_step) == (1, 2 * STEPS)
    assert t.latest_checkpoint() == str(tmp_path / "ckpt_0001.pt")
    assert [s["step"] for s in scalars(tmp_path)] == [4, 5, 6]


SIGTERM_SCRIPT = textwrap.dedent("""
    import os, signal, sys
    import torch
    torch.set_num_threads(1)
    from det_sam2_tpu_torch.configs import tiny_test_config
    from det_sam2_tpu_torch.track import SAM2Engine
    from det_sam2_tpu_torch.training import dataset as pd
    from det_sam2_tpu_torch.training.train_step import OptimConf
    from det_sam2_tpu_torch.training.trainer import Trainer, TrainerConf

    class Preempting:
        # one good epoch (it checkpoints), then SIGTERM at the next epoch
        def __init__(self):
            self.loader = pd.VOSDataLoader(
                pd.SyntheticRawDataset(num_videos=2, num_frames=3),
                pd.RandomUniformSampler(num_frames=2), image_size=128, batch_size=1)
            self.calls = 0

        def batches(self, n):
            self.calls += 1
            if self.calls == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield from self.loader.batches(n)

    eng = SAM2Engine(tiny_test_config(), device="cpu")
    t = Trainer(eng.cfg, eng, OptimConf(base_lr=1e-4, total_steps=3),
                TrainerConf(num_epochs=3, steps_per_epoch=1, log_every=1,
                            checkpoint_dir=sys.argv[1], prompt_kind_probs={"box": 1.0},
                            num_correction_steps=0, checkpoint_on_sigterm=True))
    t.run(Preempting())
""")


def test_sigterm_checkpoints_and_exits_143(tmp_path):
    res = subprocess.run([sys.executable, "-c", SIGTERM_SCRIPT, str(tmp_path)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 143, res.stderr[-2000:]
    names = sorted(n for n in os.listdir(tmp_path) if n.startswith("ckpt_"))
    assert names == ["ckpt_0000.pt"]
    state = torch.load(tmp_path / names[0], weights_only=True)
    assert (state["epoch"], state["global_step"], state["optimizer"]["count"]) == (0, 1, 1)


def test_nan_loss_aborts(weights, tmp_path):
    class NaNLoader:
        def batches(self, n):
            images, gt = _batch()
            images = images.copy()
            images[0, 0, :4, :4] = np.nan
            yield images, gt

    t = port_trainer(weights, tmp_path)
    with pytest.raises(FloatingPointError, match="at step 0"):
        t.run(NaNLoader())


def test_meters():
    assert human_readable_time(90061) == "01d 01h 01m"
    m = MemMeter("mem", device="cpu")
    m.update()
    assert m.peak == 0.0 and m.count == 1
    d = DurationMeter("t")
    d.add(30)
    d.add(60)
    assert "00d 00h 01m" in str(d)
    a = AverageMeter("loss")
    a.update(2.0)
    a.update(4.0)
    line = ProgressMeter(100, [a, m, d], prefix="ep1 ").format(7)
    assert line.startswith("ep1 [  7/100]") and "loss: 3.0000" in line


def test_a_step_that_reaches_no_parameter_decays_the_weights(weights, tmp_path):
    """A schedule whose every frame is an initial conditioning frame given
    its GT mask as the output depends on no parameter: JAX's gradient is
    zero and its step only decays the weights. The port's step must not
    fail in the backward: grad_norm 0, the weights that decay moved, every
    other parameter unchanged."""
    from det_sam2_tpu_torch.training.sam2_train import PromptSchedule
    from det_sam2_tpu_torch.training.train_step import decays

    t = port_trainer(weights, tmp_path)
    t.optimizer.count = 1  # past the warmup step, lr > 0
    images, gt = _batch()
    before = {k: v.detach().clone() for k, v in t.model.named_parameters()}
    sch = PromptSchedule(init_cond_frames=(0, 1), use_pt_input=False,
                         use_box_per_frame=(False, False))
    m = t._step(images, gt, t._generator(), schedule=sch)
    assert float(m["grad_norm"]) == 0.0 and np.isfinite(float(m["core_loss"]))
    for n, p in t.model.named_parameters():
        assert torch.equal(p, before[n]) != decays(n, p), n
