"""Operations and bytes against hand-worked shapes, and the trace's reading
(ranges, busy time, idle gaps, launch counts) on a made-up timeline."""

from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest
import torch

from port_bench import flops
from port_bench.reference import configs as rc
from port_bench.trace import RANGES, Trace

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(f"m_{name}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_k1_launch_by_hand():
    # 2 heads, 4 queries, 8 keys, D = Dv = 16, bf16: QK^T and PV, 2 FLOPs a MAC
    assert flops.k1_launch(2, 4, 8, 16, 16) == (2 * 2 * 4 * 8 * 32,
                                                2 * 2 * (64 + 128 + 128 + 64) + 4 * 2 * 4)


@pytest.mark.parametrize("name,frames,heads,d", [("sam2_1_hiera_l", 16, 8, 72),
                                                  ("sam2_1_hiera_s", 4, 4, 96)])
def test_k1_launches_of_a_step(name, frames, heads, d):
    cfg = getattr(rc, name)()
    got = flops.k1_step_launches(cfg, frames, 64)
    # three global blocks in stage 3 (64x64 tokens, 576 / 384 wide), then
    # memory self-attention over 4096 tokens, one launch a layer
    assert got == [(frames * heads, 4096, 4096, d, d)] * 3 + [(64, 4096, 4096, 256, 256)] * 4


def test_memory_live_by_frame():
    cfg = rc.sam2_1_hiera_l()
    assert flops.memory_live(cfg, 1) == (1, 4)  # frame 0's memory and pointer
    assert flops.memory_live(cfg, 9) == (7, 4 * 9)  # 6 past frames; 8 past pointers
    assert flops.memory_live(cfg, 16) == flops.memory_live(cfg, 400) == (7, 64)


def test_k2_launches_by_hand():
    cfg = rc.sam2_1_hiera_s()
    (mf, mb), (kf, kb) = flops.k2_launches(cfg, 3, 100)
    live = 3 * (7 * 4096 + 64)
    assert mf == 2 * 4096 * live * (256 + 64)
    assert mb == 2 * 3 * 4096 * 256 + 4 * 3 * 8 * 4096 + 2 * 3 * 4096 * 64 + 2 * live * 320
    assert kf == 0
    assert kb == 2 * 8 * 3 * 4096 * 256 * 2 + 2 * 4 * 4096 * 128 + 4 * 8 * 256


def test_memory_attention_flops_by_hand():
    """The step's count of memory attention (FlopCounterMode over the
    reference's module) equals the hand-worked sum at a small shape."""
    from torch.utils.flop_counter import FlopCounterMode

    from port_bench.reference.memory_attention import MemoryAttention

    cfg = rc.tiny_test_config()
    ma = cfg.memory_attention
    n, d, cm, f = 64, ma.d_model, cfg.mem_dim, ma.dim_feedforward
    tiles, ptr = 3, 8
    m = tiles * n + ptr
    mod = MemoryAttention(ma).requires_grad_(False)
    with FlopCounterMode(display=False) as fc:
        mod(torch.zeros(1, n, d), torch.zeros(1, m, cm), curr_pos=torch.zeros(1, n, d),
            memory_pos=torch.zeros(1, m, cm), num_obj_ptr_tokens=ptr, num_mem_frames=tiles,
            memory_mask=torch.ones(1, m, dtype=torch.bool))
    per_layer = (4 * 2 * n * d * d + 2 * 2 * n * n * d  # self-attention
                 + 2 * n * d * d + 2 * m * cm * d  # cross: q and k projections
                 + 2 * n * m * d + 2 * n * m * cm  # QK^T, P V on the raw values
                 + 2 * n * cm * d + 2 * n * d * d  # late v_proj, out_proj
                 + 2 * 2 * n * d * f)  # MLP
    assert fc.get_total_flops() == ma.num_layers * per_layer


def test_step_flops_grow_by_frame_and_by_row():
    cfg = rc.tiny_test_config()
    base = flops.step_model_flops(cfg, 1, 1, 20)
    frame = flops.step_model_flops(cfg, 2, 1, 20) - base
    row = flops.step_model_flops(cfg, 1, 2, 20) - base
    assert frame > 0 and row > 0
    assert flops.step_model_flops(cfg, 3, 4, 20) == pytest.approx(base + 2 * frame + 3 * row)


def _timeline():
    """Two steps: per step an image_encoder range holding two K1 launches,
    then a memory_attention range holding one, a host op in the gap."""
    ev = []
    corr = 0
    k1 = "void (anonymous namespace)::flash_fwd_bf16<16, 4, 1>(x)"
    for step in range(2):
        t = step * 1000.0
        ev.append(dict(ph="X", cat="user_annotation", name="image_encoder", ts=t, dur=300))
        ev.append(dict(ph="X", cat="user_annotation", name="memory_attention", ts=t + 400,
                       dur=200))
        ev.append(dict(ph="X", cat="cpu_op", name="aten::copy_", ts=t + 500, dur=400))
        for ts, dev_ts, name in ((t + 10, t + 100, k1), (t + 20, t + 200, k1),
                                 (t + 410, t + 600, "void pytorch_flash::flash_fwd_kernel<x>")):
            corr += 1
            ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=ts, dur=5,
                           args={"correlation": corr}))
            ev.append(dict(ph="X", cat="kernel", name=name, ts=dev_ts, dur=100,
                           args={"correlation": corr}))
    return ev


def test_trace_ranges_busy_and_gaps():
    tr = Trace(_timeline(), steps=2, window_s=2e-3, dispatch_s=[1e-3, 2e-3], cell={},
               ranges=RANGES)
    assert tr.range_device_s("image_encoder") == pytest.approx(400e-6)
    assert tr.range_device_s("memory_attention") == pytest.approx(200e-6)
    assert tr.range_device_s("memory_encoder") is None
    assert tr.busy_s == pytest.approx(600e-6)
    assert len(tr.kernels("::flash_fwd_bf16<")) == 4
    bd = tr.breakdown()
    assert bd["device_ops"][0][1] == pytest.approx(400e-6)
    gaps = dict(bd["idle_gaps"])
    # gaps 300..600 and 1300..1600 with no host op at their middles, 700..1100
    # with copy_ (500..900) open at 900
    assert gaps["aten::copy_"] == pytest.approx(400e-6)
    assert gaps["_no_host_op_"] == pytest.approx(600e-6)
    assert reader("device.idle_share")(tr) == pytest.approx(70.0)
    assert reader("engine.dispatch_ms")(tr) == pytest.approx(1.5)
    assert reader("encoder.device_ms")(tr) == pytest.approx(0.2)


def test_a_roofline_reads_nothing_when_the_launches_differ_from_the_shapes():
    cfg = rc.tiny_test_config()
    tr = Trace(_timeline(), steps=2, window_s=2e-3, dispatch_s=[0.0], cell={
        "cfg": cfg, "frames": 1, "rows": 1, "frame_indices": [20, 21]}, ranges=RANGES)
    # the tiny config implies 1 global block + 4 memory layers a step, the
    # timeline has 2 K1 launches a step
    assert reader("k1_roofline")(tr) is None
    assert reader("k2_roofline")(tr) is None


def test_step_mfu_reads_the_familys_step_flops():
    tr = Trace(_timeline(), steps=2, window_s=2e-3, dispatch_s=[0.0], cell={
        "frame_indices": [20, 21], "step_flops": lambda k: 1e9 * k}, ranges=RANGES)
    assert reader("step.mfu")(tr) == pytest.approx(100 * 41e9 / (2e-3 * flops.PEAK_BF16))
