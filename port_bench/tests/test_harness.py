"""The harness end to end on the CPU at a tiny size: the port against the
reference, the lower-precision control and planted faults of the timed
path, which must turn ``correct`` false. The chip's look is skipped:
``run.run_cell`` is the rest of a run."""

from __future__ import annotations

import time

import pytest
import torch

from port_bench import cells
from port_bench import run as bench_run
from port_bench.tests import tiny

SEED = 2 ** 31 + 977


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_tiny(tmp_path, **kw):
    cell = cells.load_cell(tiny.NAME, tiny.write_root(tmp_path, **kw))
    return bench_run.run_cell(cell, SEED, 0.5, False, "cpu", time.time())


def test_port_matches_the_reference_at_a_tiny_size(tmp_path):
    res = run_tiny(tmp_path)
    assert res["correct"], res["check"]
    assert res["check"]["resize_exact"]["value"] == 0
    assert res["check"]["holes_left"]["value"] == 0
    assert res["attempted"] > 0 and res["failed"] == 0


def test_the_program_with_its_int8_trunk_fails(tmp_path):
    cell = cells.load_cell(tiny.NAME, tiny.write_root(tmp_path))
    res = bench_run.run_cell(cell, SEED, 0.5, False, "cpu", time.time(), int8=True)
    assert not res["correct"], res["check"]
    assert res["check"]["feat_err"]["value"] > 3 * res["check"]["feat_err"]["limit"]


def test_the_fp8_reference_control_fails(tmp_path):
    cell = cells.load_cell(tiny.NAME, tiny.write_root(tmp_path, traffic={"warm_steps": 9}))
    res = bench_run.run_control(cell, SEED, "cpu")
    assert not res["correct"], res["check"]
    for k in ("ptr_err", "feat_err"):
        assert res["check"][k]["value"] > 3 * res["check"][k]["limit"], k


def _state_unchanged(monkeypatch):
    import det_sam2_tpu_torch.track as track

    monkeypatch.setattr(track, "write_noncond", lambda bank, *a, **k: bank)


def _half_the_batch(monkeypatch):
    from det_sam2_tpu_torch.batched import BatchedVideoStreamer

    orig = BatchedVideoStreamer.propagate_window

    def half(self, *a, **k):
        outs = orig(self, *a, **k)
        h = outs[0].shape[1] // 2
        left_out = []
        for x in outs[:3]:
            x = x.clone()
            x[:, h:] = x[:, :h].float().mean(1, keepdim=True).to(x.dtype)
            left_out.append(x)
        return (*left_out, outs[3])

    monkeypatch.setattr(BatchedVideoStreamer, "propagate_window", half)


def _answer_altered(monkeypatch):
    import det_sam2_tpu_torch.ops.mask_resize as mr

    orig = mr.resize_masks_cv2

    def altered(x, out_hw, *a, **k):
        out = orig(x, out_hw, *a, **k).clone()
        out[..., :6, :6] = -out[..., :6, :6]
        return out

    monkeypatch.setattr(mr, "resize_masks_cv2", altered)


def _fill_skipped(monkeypatch):
    import det_sam2_tpu_torch.track as track

    monkeypatch.setattr(track, "_fill_stacked", lambda cfg, low: low)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch, _answer_altered,
                                   _fill_skipped],
                         ids=["state_unchanged", "half_the_batch", "answer_altered",
                              "fill_skipped"])
def test_a_planted_fault_turns_correct_false(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    res = run_tiny(tmp_path)
    assert not res["correct"], res["check"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["live.hiera_l.streams", "live.hiera_s.objects",
                                  "live.hiera_l.objects"])
def test_the_fp8_control_fails_at_the_cells_size_on_the_card(name):
    """The control of every cell at its own size and with its own limits:
    the reference with fp8 operands in the program's place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = bench_run.run_control(cells.load_cell(name), SEED, torch.device("cuda", 0))
    assert not res["correct"], (name, res["check"])


# the four compared numbers of the tiny SAM 2.1 cell at SEED, traced (a
# fixed number of steps), as the harness before the family seam computed
# them with two threads
PARENT_NUMBERS = {"ptr_err": 7.011206036765872e-07, "feat_err": 0.0, "holes_left": 0.0,
                  "resize_exact": 0.0}


def test_the_sam2_1_numbers_through_the_family_are_the_same_bits(tmp_path):
    cell = cells.load_cell(tiny.NAME, tiny.write_root(tmp_path))
    res = bench_run.run_cell(cell, SEED, 0.5, True, "cpu", time.time())
    assert {k: v["value"] for k, v in res["check"].items()} == PARENT_NUMBERS
    assert res["correct"] and res["metrics"]["step.mfu"]["value"] > 0


@pytest.fixture
def family_cell(tmp_path):
    """The second family's cell, its files new under a temporary root."""
    root = tiny.write_root(tmp_path)
    with tiny.family_on_path(root):
        yield cells.load_cell(tiny.FAMILY_NAME, root)


def test_a_second_family_added_as_files_alone_holds_to_its_reference(family_cell):
    res = bench_run.run_cell(family_cell, SEED, 0.5, False, "cpu", time.time())
    assert res["correct"], res["check"]
    assert set(res["check"]) == {"feat_err"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"stream_fps", "frame_p95_ms", "peak_mem_gib", "setup_s"}


def _perturbed_weight(monkeypatch):
    from det_sam2_tpu_torch.modeling.image_encoder import ImageEncoder

    orig = ImageEncoder.load_state_dict

    def perturbed(self, *a, **k):
        out = orig(self, *a, **k)
        with torch.no_grad():
            self.trunk.patch_embed.proj.weight[0].add_(0.01)
        return out

    monkeypatch.setattr(ImageEncoder, "load_state_dict", perturbed)


@pytest.mark.parametrize("control", [False, True], ids=["perturbed_weight", "fp8_control"])
def test_the_second_family_turns_correct_false(family_cell, monkeypatch, control):
    if control:
        res = bench_run.run_control(family_cell, SEED, "cpu")
    else:
        _perturbed_weight(monkeypatch)
        res = bench_run.run_cell(family_cell, SEED, 0.5, False, "cpu", time.time())
    assert not res["correct"], res["check"]
    assert res["check"]["feat_err"]["value"] > 3 * res["check"]["feat_err"]["limit"]


def test_the_second_family_traced_reports_only_its_listed_readers(family_cell):
    res = bench_run.run_cell(family_cell, SEED, 0.5, True, "cpu", time.time())
    assert res["correct"], res["check"]
    assert set(res["metrics"]) <= set(tiny.FAMILY_READERS)
    assert res["metrics"]["step.mfu"]["value"] > 0
    assert res["metrics"]["device.idle_share"]["value"] > 0
    assert res["attempted"] == tiny.FAMILY_TRAFFIC["trace_steps"] * tiny.FAMILY_TRAFFIC["frames"]


def test_a_family_without_an_int8_path_refuses_it(family_cell):
    with pytest.raises(NotImplementedError):
        bench_run.run_cell(family_cell, SEED, 0.5, False, "cpu", time.time(), int8=True)
