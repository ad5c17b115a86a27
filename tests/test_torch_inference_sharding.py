"""Object- and spatially-sharded inference of the port on the CPU (gloo).

Processes are started as torchrun would start them, one spawn per world
size, each running its modes in the same processes:
* objects (worlds 1, 2, 4): O = 8 objects, every rank prompting its own rows
  of the boxes on a bank cut by ``shard_bank``, the cond-memory write, then
  ``track_step``; the outputs joined by ``gather_objects`` must be within
  1e-4 of JAX's single-device run and of the port's single process (bit for
  bit at world 1), each rank's bank keeping its own object rows. A banked
  session that ``shard_bank`` moves to the gather path matches the banked
  single process within 2e-3, as the JAX package's multi-chip dry run holds
  it.
* spatial (worlds 1, 2, 3; 3 gives uneven bands and a rank with no window
  row in the last stage): ``make_spatial_encode`` at
  ``tiny_test_config(image_size=256)`` within 1e-4 of JAX's ``encode_image``
  and of JAX's ``make_spatial_encode`` on the 8-device CPU mesh, the same on
  every rank (bit for bit ``encode_image`` at world 1); the features drive a
  ``prompt_step``.
The workers import this module for their bodies, so it imports JAX only
inside the fixtures that compute the references.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from det_sam2_tpu_torch.configs import tiny_test_config
from det_sam2_tpu_torch.state import init_bank
from det_sam2_tpu_torch.track import SAM2Engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
O = 8
N_FRAMES = 10
BOXES = np.asarray([[[6.0 + 9 * i, 10.0 + 3 * i], [50.0 + 8 * i, 70.0 + 5 * i]]
                    for i in range(O)], np.float32)
LABELS = np.tile(np.asarray([[2, 3]], np.int32), (O, 1))
SPATIAL_BOXES = np.asarray([[[20.0, 20.0], [90.0, 100.0]], [[120.0, 40.0], [200.0, 180.0]]],
                           np.float32)
SPATIAL_LABELS = np.asarray([[2, 3], [2, 3]], np.int32)
ATOL = 1e-4  # tests/test_inference_sharding.py, tests/test_spatial_sharding.py
BANKED_ATOL = 2e-3  # __graft_entry__.py's banked -> gather fallback
WORLDS = {1: ("objects", "spatial"), 2: ("objects", "spatial"), 3: ("spatial",),
          4: ("objects",)}
OUT_KEYS = ("pred_masks", "obj_ptr", "object_score_logits", "ious")


def cfg_objects():
    return tiny_test_config()


def cfg_banked():
    # the obj-ptr tokens fit the tiny grid's one 64-token staging tile
    return tiny_test_config(max_obj_ptrs_in_encoder=8)


def cfg_spatial():
    return tiny_test_config(image_size=256)


def frame(size, seed):
    return np.random.default_rng(seed).integers(0, 255, (1, size, size, 3), np.uint8)


def engine(cfg, sd, banked=False):
    return SAM2Engine(cfg, params=sd, device="cpu", banked=banked)


def object_session(eng, bank, rows=slice(None)):
    """Prompt (this rank's rows of the boxes), cond write, one track_step:
    (prompt outputs, track outputs, bank)."""
    feats = eng.encode_image(frame(eng.cfg.image_size, 1))
    out = eng.prompt_step(feats, bank, 0, N_FRAMES, BOXES[rows], LABELS[rows], is_init=True)
    bank = eng.encode_cond_memory(feats, bank, 0, out["pred_masks"],
                                  out["object_score_logits"], out["obj_ptr"])
    bank, tracked = eng.track_step(feats, bank, 1, N_FRAMES)
    return out, tracked, bank


def banked_before_track(eng):
    """The banked session up to the cond write (unsharded), with its feats."""
    cfg = eng.cfg
    bank = init_bank(cfg, num_objects=O, banked_layers=eng.banked_layers, device="cpu")
    feats = eng.encode_image(frame(cfg.image_size, 2))
    out = eng.prompt_step(feats, bank, 0, 4, BOXES, LABELS, is_init=True)
    bank = eng.encode_cond_memory(feats, bank, 0, out["pred_masks"],
                                  out["object_score_logits"], out["obj_ptr"])
    return feats, bank


def spatial_prompt(eng, feats):
    bank = init_bank(eng.cfg, num_objects=2, device="cpu")
    out = eng.prompt_step(feats, bank, 0, 100, SPATIAL_BOXES, SPATIAL_LABELS, is_init=True)
    return out["pred_masks"]


def run_rank(weights, out_dir, world, rank, port):
    """One rank's body (in a spawned process)."""
    from det_sam2_tpu_torch.parallel import inference_sharding as ish
    from det_sam2_tpu_torch.parallel.mesh import make_mesh
    from det_sam2_tpu_torch.parallel.spatial import make_spatial_encode
    from det_sam2_tpu_torch.training import launch

    torch.set_num_threads(1)
    launch.init_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    sd = torch.load(weights, weights_only=True)
    res = {}
    if "objects" in WORLDS[world]:
        mesh = make_mesh("cpu", axis_names=("objects",))
        eng = engine(cfg_objects(), sd)
        bank = ish.shard_bank(mesh, init_bank(eng.cfg, num_objects=O, device="cpu"))
        rows = ish.object_rows(mesh, O)
        out, tracked, bank = object_session(eng, bank, rows)
        res["objects"] = {
            "placements": {k: str(v[0]) for k, v in ish.bank_shardings(mesh, bank).items()},
            "bank_shapes": {k: tuple(getattr(bank, k).shape)
                            for k in ("cond_mem", "noncond_mem", "noncond_frame_idx")},
            "rows": (rows.start, rows.stop),
            "prompt": ish.gather_objects(mesh, out),
            "track": ish.gather_objects(mesh, tracked),
        }
        eng_b = engine(cfg_banked(), sd, banked=True)
        feats, bank_b = banked_before_track(eng_b)
        sharded = ish.shard_bank(mesh, bank_b)
        assert bank_b.mem_k is not None and sharded.mem_k is None
        _, got = eng_b.track_step(feats, sharded, 1, 4)
        res["banked"] = ish.gather_objects(mesh, got)["pred_masks"]
    if "spatial" in WORLDS[world]:
        mesh = make_mesh("cpu", axis_names=("spatial",))
        eng = engine(cfg_spatial(), sd)
        feats = make_spatial_encode(eng, mesh)(frame(256, 3))
        res["spatial"] = {"feats": [f.clone() for f in feats],
                          "prompt": spatial_prompt(eng, feats)}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


WORKER = textwrap.dedent("""
    import sys
    sys.path.insert(0, {tests!r})
    from test_torch_inference_sharding import run_rank
    run_rank({weights!r}, {out!r}, {world}, {rank}, {port})
""")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX weights (object-score bias +1 so objects count as present), the
    port's state dict on disk, and JAX's references."""
    import jax
    import jax.numpy as jnp

    from det_sam2_tpu.configs import tiny_test_config as jax_tiny
    from det_sam2_tpu.parallel.mesh import make_mesh as jax_mesh
    from det_sam2_tpu.parallel.spatial import make_spatial_encode as jax_spatial
    from det_sam2_tpu.state import init_bank as jax_init_bank
    from det_sam2_tpu.track import SAM2Engine as JaxEngine

    from det_sam2_tpu_torch import convert

    jeng = JaxEngine(jax_tiny(), seed=5)
    params = jax.tree_util.tree_map(np.array, jeng.params)
    params["sam_mask_decoder"]["pred_obj_score_head"]["layers_2"]["bias"][:] = 1.0
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jeng = JaxEngine(jax_tiny(), params=jparams)
    feats = jeng.encode_image(jnp.asarray(frame(128, 1)))
    bank = jax_init_bank(jeng.cfg, num_objects=O)
    out = jeng.prompt_step(feats, bank, 0, N_FRAMES, jnp.asarray(BOXES), jnp.asarray(LABELS),
                           is_init=True)
    bank = jeng.encode_cond_memory(feats, bank, 0, out["pred_masks"],
                                   out["object_score_logits"], out["obj_ptr"])
    _, tracked = jeng.track_step(feats, bank, 1, N_FRAMES)
    jax_objects = {"prompt": np.asarray(out["pred_masks"], np.float32),
                   "track": np.asarray(tracked["pred_masks"], np.float32)}

    jeng256 = JaxEngine(jax_tiny(image_size=256), params=jparams)
    img = jnp.asarray(frame(256, 3))
    jax_single = [np.asarray(f) for f in jeng256.encode_image(img)]
    mesh = jax_mesh(axis_names=("spatial",))
    assert mesh.shape["spatial"] == 8
    jax_sharded = [np.asarray(f) for f in jax_spatial(jeng256, mesh)(img)]

    weights = str(tmp_path_factory.mktemp("weights") / "sd.pt")
    torch.save(convert.from_jax_params(params), weights)
    return weights, jax_objects, jax_single, jax_sharded


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """{world: [each rank's results]}, one spawn per world size."""
    weights = setup[0]
    res = {}
    for world in WORLDS:
        out = str(tmp_path_factory.mktemp(f"world{world}"))
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, "-c", WORKER.format(tests=os.path.join(REPO, "tests"),
                                                 weights=weights, out=out, world=world,
                                                 rank=rank, port=port)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(world)]
        try:
            for p in procs:
                log, _ = p.communicate(timeout=300)
                assert p.returncode == 0, log[-3000:]
        finally:
            for p in procs:
                p.kill()
        res[world] = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                      for r in range(world)]
    return res


@pytest.fixture(scope="module")
def single(setup):
    """The port's single-process runs."""
    sd = torch.load(setup[0], weights_only=True)
    eng = engine(cfg_objects(), sd)
    out, tracked, _ = object_session(eng, init_bank(eng.cfg, num_objects=O, device="cpu"))
    eng_b = engine(cfg_banked(), sd, banked=True)
    feats, bank_b = banked_before_track(eng_b)
    _, banked = eng_b.track_step(feats, bank_b, 1, 4)
    eng256 = engine(cfg_spatial(), sd)
    feats256 = eng256.encode_image(frame(256, 3))
    return {"prompt": out, "track": tracked, "banked": banked["pred_masks"],
            "feats": feats256, "spatial_prompt": spatial_prompt(eng256, feats256)}


def _close(got, want, atol=ATOL):
    got = got.numpy() if torch.is_tensor(got) else got
    want = want.numpy() if torch.is_tensor(want) else want
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=atol, atol=atol)


@pytest.mark.parametrize("world", [w for w, m in WORLDS.items() if "objects" in m])
def test_object_sharded_step_equals_single_device(ranks, single, setup, world):
    jax_objects = setup[1]
    for rank, res in enumerate(ranks[world]):
        r = res["objects"]
        k = O // world
        assert r["rows"] == (rank * k, (rank + 1) * k)
        # the bank stays cut to this rank's rows through the step
        assert r["bank_shapes"]["cond_mem"][1] == k
        assert r["bank_shapes"]["noncond_mem"][1] == k
        assert r["bank_shapes"]["noncond_frame_idx"] == (init_bank(
            cfg_objects(), 1, device="cpu").noncond_frame_idx.shape)
        assert r["placements"]["noncond_mem"] == "S(1)"
        assert r["placements"]["noncond_frame_idx"] == "R"
        for key in OUT_KEYS:
            for stage in ("prompt", "track"):
                got, want = r[stage][key], single[stage][key]
                if world == 1:
                    assert torch.equal(got, want), (stage, key)
                _close(got, want)
        _close(r["prompt"]["pred_masks"], jax_objects["prompt"])
        _close(r["track"]["pred_masks"], jax_objects["track"])
        # gathered in rank order: every rank holds the same [O, ...] outputs
        assert torch.equal(r["track"]["pred_masks"], ranks[world][0]["objects"]["track"]["pred_masks"])


@pytest.mark.parametrize("world", [w for w, m in WORLDS.items() if "objects" in m])
def test_sharded_banked_session_takes_the_gather_path(ranks, single, world):
    for res in ranks[world]:
        _close(res["banked"], single["banked"], BANKED_ATOL)


@pytest.mark.parametrize("world", [w for w, m in WORLDS.items() if "spatial" in m])
def test_spatial_encode_equals_single_device(ranks, single, setup, world):
    _, _, jax_single, jax_sharded = setup
    for res in ranks[world]:
        feats = res["spatial"]["feats"]
        for got, want, js, jsh in zip(feats, single["feats"], jax_single, jax_sharded):
            if world == 1:
                assert torch.equal(got, want)
            _close(got, want)
            _close(got, js)
            _close(got, jsh)
        for got, want in zip(feats, ranks[world][0]["spatial"]["feats"]):
            assert torch.equal(got, want)  # every rank holds the same result


@pytest.mark.parametrize("world", [w for w, m in WORLDS.items() if "spatial" in m])
def test_spatial_features_drive_a_prompt_step(ranks, single, world):
    for res in ranks[world]:
        masks = res["spatial"]["prompt"]
        assert bool(torch.isfinite(masks).all())
        _close(masks, single["spatial_prompt"])


def test_row_bands_cut_on_window_rows():
    from det_sam2_tpu_torch.parallel.spatial import row_bands, split_units

    assert split_units(5, 2) == [(0, 3), (3, 5)]
    assert split_units(2, 3) == [(0, 1), (1, 2), (2, 2)]
    # hiera-S at 1024^2, stage 3: a 64-row grid in 14-row windows (the last
    # band carries the padding to 70)
    assert row_bands(64, 14, 2) == [(0, 42), (42, 64)]
    assert row_bands(64, 14, 3) == [(0, 28), (28, 56), (56, 64)]
    assert row_bands(16, 14, 3) == [(0, 14), (14, 16), (16, 16)]
    assert row_bands(256, 8, 3) == [(0, 88), (88, 176), (176, 256)]
