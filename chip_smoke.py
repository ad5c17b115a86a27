"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # three phases, one card

Phase 1 (kernels): builds every CUDA kernel of the main path from
det_sam2_tpu_torch/csrc (nvcc, in parallel) and holds each one against its
plain PyTorch version at the shapes the main path gives it (hiera-S,
1024^2, 2 objects), in bf16 and fp32 with TF32 off; times kernel, plain
version and, for K1, torch's scaled_dot_product_attention as a yardstick.
Planted faults (a skipped key tile, a wrong slot, no RoPE correction, ...)
must fail the same check.
Phase 2 (main path): hiera-S 1024^2 bf16, 2 objects, seeded random weights,
banked memory bank: box prompts on frame 0, the cond-memory write, then
stream_step over seeded uint8 frames; prints ms/frame, FPS, peak memory and
the kernel launch counts of that run.
Phase 3 (checks): the same session, a few frames deep, again with every
main-path K1/K2 call held against its plain version on the same inputs, in
gather mode, with every kernel replaced by its plain version, and in fp32
with the plain versions; their masks, object pointers and raw memory
cross-attention outputs must agree, and sessions with a fault planted in
K2's wrapper must fail.

Prints the card's name and power limit, one JSON line with the kernel table,
and last the device line. Exits non-zero, printing no result, when there is
no CUDA card or any check fails.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM dense
PEAK_BYTES = 3.35e12
# Kernel vs plain version, in units of the output type's own rounding step
# (`_ulp`): max-abs error <= MAX_ULPS ulps of max|ref|, and mean-abs error
# <= MEAN_EPS * eps * mean|ref|. Attention outputs of randn inputs are small
# (std ~ sqrt(e / live keys): 0.01-0.03 at the slice shapes), so an absolute
# tolerance would say nothing; these scale with the output.
# bf16: both sides round an fp32 result to bf16, and the kernel also rounds
# the unnormalised P per key tile; on an H100 the kernels differ by 1 ulp at
# the largest outputs and by 0.26-0.29 eps * mean|ref| on average, while a
# kernel that skips one key tile or reads one wrong bank row is off by
# >= 3 eps on average. fp32: the same arithmetic in another summation
# order over up to 28.7k keys with expf: <= ~120 ulps, <= 30 eps on average.
MAX_ULPS = {torch.bfloat16: 4, torch.float32: 1024}
MEAN_EPS = {torch.bfloat16: 0.4, torch.float32: 64}
K1_SRC = "det_sam2_tpu_torch/csrc/flash_fwd.cu"
K2_SRC = "det_sam2_tpu_torch/csrc/flash_banked_fwd.cu"
K1_TPU = "det_sam2_tpu/ops/attention.py:48"
K2_TPU = "det_sam2_tpu/ops/attention.py:448"


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ---------------------------------------------------------------------------
# phase 1: kernels against their plain versions
# ---------------------------------------------------------------------------


def _k1_inputs(seed, bh, nq, nk, d, dv, dtype, dead, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(bh, nq, d, generator=g, device=dev).to(dtype)
    k = torch.randn(bh, nk, d, generator=g, device=dev).to(dtype)
    v = torch.randn(bh, nk, dv, generator=g, device=dev).to(dtype)
    bias = None
    if dead is not None:
        live = torch.ones(bh, nk, dtype=torch.bool, device=dev)
        for row, lo, hi in dead:
            live[row, lo:hi] = False
        bias = torch.where(live, 0.0, -1e30).float()
    return q, k, v, bias


def _k1_cases():
    s, ptr = 4096, 64
    nk_g = 7 * s + ptr  # 1 cond + 6 non-cond memory tiles + obj-ptr tokens
    return [
        # (label, bh, nq, nk, d, dv, dead key ranges [(row, lo, hi)])
        ("hiera_global", 4, 4096, 4096, 96, 96, None),
        ("memory_self_attn", 2, 4096, 4096, 256, 256, None),
        # gather-mode cross-attention: object 0 misses memory tiles 2 and 5
        # and 48 of its 64 pointer tokens; object 1 has no live key at all
        ("gather_cross_attn", 2, 4096, nk_g, 256, 64,
         [(0, 2 * s, 3 * s), (0, 5 * s, 6 * s), (0, 7 * s + 16, nk_g),
          (1, 0, nk_g)]),
        # ragged edges: Nq, Nk off the tiles, D not a multiple of 16
        ("ragged_edges", 3, 100, 200, 40, 24, [(0, 64, 128), (2, 0, 200)]),
    ]


def _k2_inputs(b, nq, d, cm, s, ktot, nl, slots, layer, dead, dtype, dev,
               seed):
    from det_sam2_tpu_torch.modeling.position_encoding import axial_rope_cos_sin

    g = torch.Generator(device=dev).manual_seed(seed)
    t = len(slots)
    q = torch.randn(b, nq, d, generator=g, device=dev).to(dtype)
    mem_k = torch.randn(ktot, b, nl, s, d, generator=g, device=dev).to(dtype)
    mem_v = torch.randn(ktot, b, s, cm, generator=g, device=dev).to(dtype)
    slots_t = torch.tensor(slots, dtype=torch.int32, device=dev)
    w = torch.randn(t, d, generator=g, device=dev)
    w[-1] = 0.0  # the obj-ptr staging tile is not rotated
    side = int(round(s ** 0.5))
    if side * side == s:
        cos, sin = axial_rope_cos_sin(d, side, side)
        cos, sin = torch.as_tensor(cos, device=dev), torch.as_tensor(sin, device=dev)
    else:
        cos = torch.randn(s, d // 2, generator=g, device=dev)
        sin = torch.randn(s, d // 2, generator=g, device=dev)
    live = torch.ones(b, t * s, dtype=torch.bool, device=dev)
    for row, lo, hi in dead:
        live[row, lo:hi] = False
    bias = torch.where(live, 0.0, -1e30).float()
    return q, mem_k, mem_v, slots_t, w, bias, cos, sin, layer


def _k2_cases():
    s = 4096
    return [
        # (label, b, nq, d, cm, s, ktot, nl, slots, layer, dead)
        # 1 cond + 6 non-cond tiles + staging row 64; object 0 misses tile 3;
        # the staging tile holds 64 live pointer tokens
        ("banked_cross_attn", 2, 4096, 256, 64, s, 65, 4,
         [0, 32, 33, 34, 35, 36, 37, 64], 2,
         [(0, 3 * s, 4 * s), (0, 7 * s + 64, 8 * s), (1, 7 * s + 64, 8 * s)]),
        # ragged: S off the key tile, a dead object
        ("ragged_edges", 2, 70, 64, 16, 100, 5, 2, [3, 0, 4], 1,
         [(0, 100, 200), (1, 0, 300)]),
    ]


def _max_err(a, b, live_rows=None):
    diff = (a.float() - b.float()).abs()
    if live_rows is not None:
        diff = diff[live_rows]
    return float(diff.max()) if diff.numel() else 0.0


def _ulp(x: float, dtype) -> float:
    """Spacing of `dtype` at magnitude x > 0."""
    return 2.0 ** math.floor(math.log2(x)) * torch.finfo(dtype).eps


def _held(out, ref, dtype) -> dict:
    """out against ref under the MAX_ULPS / MEAN_EPS rule; `max_ulps` and
    `mean_eps` are the errors in those units (the gates are 1)."""
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    err, mean = float(diff.max()), float(diff.mean())
    if float(mag.max()) == 0:  # no live key anywhere: the output must be 0
        max_ulps = mean_eps = 0.0 if err == 0 else math.inf
    else:
        max_ulps = err / (MAX_ULPS[dtype] * _ulp(float(mag.max()), dtype))
        mean_eps = mean / (MEAN_EPS[dtype] * torch.finfo(dtype).eps
                           * float(mag.mean()))
    return dict(err=err, mean=mean, max_ulps=max_ulps, mean_eps=mean_eps,
                good=max_ulps <= 1 and mean_eps <= 1)


def _fmt(h) -> str:
    return (f"max_abs_err {h['err']:.3g} mean_abs_err {h['mean']:.3g} "
            f"(of tolerance: max {h['max_ulps']:.3f}, mean {h['mean_eps']:.3f})")


def _kill(bias, shape, dev, ranges):
    """bias (or zeros of `shape` when None) with keys [lo, hi) of row made
    dead, for each (row, lo, hi) in ranges (row None = every row)."""
    b = torch.zeros(shape, device=dev) if bias is None else bias.clone()
    for row, lo, hi in ranges:
        b[slice(None) if row is None else row, lo:hi] = -1e30
    return b


# Planted faults: each gives the kernel inputs that make it compute what a
# kernel with that fault would compute, and is held against the plain
# version on the true inputs by the same rule. Every one must be caught.
# K1: label -> [(fault, bias ranges the kernel wrongly skips)]
K1_FAULTS = {
    "hiera_global": [("one KV tile skipped", [(None, 5 * 64, 6 * 64)])],
    "memory_self_attn": [("one KV tile skipped", [(None, 17 * 64, 18 * 64)])],
    "gather_cross_attn": [
        ("one KV tile skipped", [(0, 4096 + 3 * 64, 4096 + 4 * 64)]),
        ("live pointer tokens dropped", [(0, 7 * 4096, 7 * 4096 + 16)]),
    ],
}


def _k2_faults(slots, w, bias, s):
    """K2's planted faults at the banked_cross_attn case: (name, slots, w,
    bias) that the kernel is given instead of the true ones."""
    wrong = slots.clone()
    wrong[2] = 38  # a bank row that is not attended
    staging = slots.clone()
    staging[-1] = 38  # the 64 pointer tokens read from another row
    return [
        ("RoPE correction left out", slots, torch.zeros_like(w), bias),
        ("wrong slot for one tile", wrong, w, bias),
        ("staging tile read from another row", staging, w, bias),
        ("one KV tile skipped", slots, w,
         _kill(bias, None, None, [(None, s + 5 * 64, s + 6 * 64)])),
    ]


def _caught(kernel, label, fault, h) -> bool:
    log(f"[faults] {kernel} {label}: planted '{fault}': {_fmt(h)} "
        f"{'caught' if not h['good'] else 'MISSED'}")
    return not h["good"]


def phase_kernels(dev, results):
    from det_sam2_tpu_torch.ops import attention as att

    ok = True
    for i, (label, bh, nq, nk, d, dv, dead) in enumerate(_k1_cases()):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, bias = _k1_inputs(i, bh, nq, nk, d, dv, dtype, dead, dev)
            out, lse = att.flash_attention_fwd(q, k, v, bias)
            ref, ref_lse = att.flash_attention_ref(q, k, v, bias)
            torch.cuda.synchronize()
            live_rows = (torch.ones(bh, dtype=torch.bool, device=dev) if bias is None
                         else (bias > -1e29).any(-1))
            h = _held(out, ref, dtype)
            err = h["err"]
            lse_err = _max_err(lse, ref_lse, live_rows)
            finite = bool(torch.isfinite(out).all())
            dead_zero = bool((out[~live_rows] == 0).all())
            good = finite and dead_zero and h["good"] and lse_err <= 1e-3
            ok &= good
            if dtype == torch.bfloat16:
                for fault, ranges in K1_FAULTS.get(label, []):
                    bad, _ = att.flash_attention_fwd(
                        q, k, v, _kill(bias, (bh, nk), dev, ranges))
                    ok &= _caught("flash_fwd", label, fault, _held(bad, ref, dtype))
                    del bad
            # the function needs the K/V rows of live keys only
            n_live = bh * nk if bias is None else int((bias > -1e29).sum())
            flops = 2.0 * nq * n_live * (d + dv)
            kv_bytes = n_live * (d + dv) * k.element_size()
            bnd, by = bound_ms(flops, nbytes(q, bias, out, lse) + kv_bytes, dtype)
            iters = 20 if dtype == torch.bfloat16 else 3
            ms = time_ms(lambda: att.flash_attention_fwd(q, k, v, bias), iters)
            plain = time_ms(lambda: att.flash_attention_ref(q, k, v, bias), 3, 1)
            mask = None if bias is None else bias[:, None, None, :]
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q[:, None], k[:, None], v[:, None], attn_mask=mask), iters)
            log(f"[kernels] flash_fwd {label} {str(dtype)[6:]} "
                f"q{list(q.shape)} k{list(k.shape)} v{list(v.shape)} "
                f"bias={'yes' if bias is not None else 'no'}: {_fmt(h)} "
                f"lse_err {lse_err:.3g} ms {ms:.4f} plain_ms "
                f"{plain:.4f} sdpa_ms {lib:.4f} bound_ms {bnd:.4f} ({by}) "
                f"{'OK' if good else 'FAIL'}")
            if dtype == torch.bfloat16 and label != "ragged_edges":
                results.append(dict(
                    name=f"flash_fwd:{label}", route="cuda", source=K1_SRC,
                    replaces=K1_TPU, kernel="flash_fwd",
                    shape=dict(q=list(q.shape), k=list(k.shape), v=list(v.shape),
                               bias=None if bias is None else list(bias.shape)),
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                    bound_by=by, library_ms=lib))
            del q, k, v, bias, out, lse, ref, ref_lse
            torch.cuda.empty_cache()

    for i, (label, b, nq, d, cm, s, ktot, nl, slots, layer, dead) in enumerate(
            _k2_cases()):
        for dtype in (torch.bfloat16, torch.float32):
            args = _k2_inputs(b, nq, d, cm, s, ktot, nl, slots, layer, dead,
                              dtype, dev, seed=100 + i)
            q, mem_k, mem_v, slots_t, w, bias, cos, sin, _ = args
            out = att.flash_attention_banked_fwd(*args)
            ref = att.flash_attention_banked_ref(*args)
            torch.cuda.synchronize()
            live_rows = (bias > -1e29).any(-1)
            h = _held(out, ref, dtype)
            err = h["err"]
            good = (bool(torch.isfinite(out).all())
                    and bool((out[~live_rows] == 0).all()) and h["good"])
            ok &= good
            if dtype == torch.bfloat16 and label == "banked_cross_attn":
                for fault, f_slots, f_w, f_bias in _k2_faults(slots_t, w, bias, s):
                    bad = att.flash_attention_banked_fwd(
                        q, mem_k, mem_v, f_slots, f_w, f_bias, cos, sin, layer)
                    ok &= _caught("flash_banked_fwd", label, fault,
                                  _held(bad, ref, dtype))
                    del bad
            # the function needs the bank's K/V rows of live keys only
            live_keys = int((bias > -1e29).sum())
            flops = 2.0 * nq * live_keys * (d + cm)
            rows = live_keys * (d + cm) * q.element_size()
            bnd, by = bound_ms(flops, nbytes(q, w, bias, cos, sin, out) + rows, dtype)
            iters = 20 if dtype == torch.bfloat16 else 3
            ms = time_ms(lambda: att.flash_attention_banked_fwd(*args), iters)
            plain = time_ms(lambda: att.flash_attention_banked_ref(*args), 3, 1)
            log(f"[kernels] flash_banked_fwd {label} {str(dtype)[6:]} q{list(q.shape)} "
                f"mem_k{list(mem_k.shape)} mem_v{list(mem_v.shape)} slots{slots} "
                f"layer {layer}: {_fmt(h)} ms {ms:.4f} "
                f"plain_ms {plain:.4f} bound_ms {bnd:.4f} ({by}) "
                f"{'OK' if good else 'FAIL'}")
            if dtype == torch.bfloat16 and label != "ragged_edges":
                results.append(dict(
                    name=f"flash_banked_fwd:{label}", route="cuda", source=K2_SRC,
                    replaces=K2_TPU, kernel="flash_banked_fwd",
                    shape=dict(q=list(q.shape), mem_k=list(mem_k.shape),
                               mem_v=list(mem_v.shape), slots=len(slots)),
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                    bound_by=by, library_ms=None))
            del args, q, mem_k, mem_v, out, ref
            torch.cuda.empty_cache()
    return ok


# ---------------------------------------------------------------------------
# phases 2 and 3: the main path and its checks
# ---------------------------------------------------------------------------

N_STREAM = 30  # stream_steps in phase 2
N_WARM = 3  # of which the first are warm-up, not timed
N_CHECK = 4  # stream_steps in each phase-3 session
N_PROFILE = 3  # further stream_steps of phase 2 under torch.profiler
NUM_FRAMES = 1000  # the video length the session declares
BOXES = [[[200.0, 240.0], [520.0, 610.0]], [[600.0, 150.0], [900.0, 480.0]]]


def make_engine(cfg, plain: bool, device=None, dtype=torch.bfloat16):
    """hiera-S engine with the seeded random init, changed in two places.
    The object-score head's output bias is set to +1 so that both objects
    count as present: with random weights the scores sit near 0, every mask
    would be the NO_OBJ_SCORE constant and memory, masks and hole filling
    would carry nothing worth checking. The temporal encodings
    (maskmem_tpos_enc) are drawn from N(0, 1) instead of N(0, 0.02): at the
    small init K2's per-tile RoPE correction w = Wk @ tpos is a few
    hundredths of the keys, and a kernel that left it out would stay within
    the kernel tolerance on the main path's own inputs."""
    from det_sam2_tpu_torch.track import SAM2Engine

    eng = SAM2Engine(cfg, dtype=dtype, device=device, seed=0,
                     plain_kernels=plain)
    m = eng.model
    with torch.no_grad():
        m.sam_mask_decoder.pred_obj_score_head.layers[-1].bias.fill_(1.0)
        g = torch.Generator().manual_seed(1)
        m.maskmem_tpos_enc.copy_(torch.randn(m.maskmem_tpos_enc.shape, generator=g))
    return eng


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_session(eng, frames, banked: bool, n_steps: int, timings=None,
                after_init=None):
    """Box prompts on frame 0, cond-memory write, then n_steps stream_steps.
    Returns the stream outputs (and fills timings with per-step ms)."""
    from det_sam2_tpu_torch.state import init_bank

    cfg = eng.cfg
    dev = frames.device
    bank = init_bank(cfg, num_objects=2, dtype=eng.dtype, attend_cond_tiles=1,
                     banked_layers=eng.banked_layers if banked else 0, device=dev)
    boxes = torch.tensor(BOXES, device=dev)
    labels = torch.tensor([[2, 3], [2, 3]], device=dev)
    feats = eng.encode_image(frames[0:1])
    out = eng.prompt_step(feats, bank, 0, NUM_FRAMES, boxes, labels, is_init=True)
    bank = eng.encode_cond_memory(feats, bank, 0, out["pred_masks"],
                                  out["object_score_logits"], out["obj_ptr"])
    if after_init is not None:
        _sync(dev)
        after_init()
    outs = []
    for t in range(1, n_steps + 1):
        t0 = time.perf_counter()
        bank, o = eng.stream_step(frames[t:t + 1], bank, t, NUM_FRAMES)
        _sync(dev)
        if timings is not None:
            timings.append((time.perf_counter() - t0) * 1e3)
        outs.append({k: v.float() for k, v in o.items()})
    return outs, bank


def check_outputs(outs, cfg) -> bool:
    from det_sam2_tpu_torch.track import use_multimask

    s4 = cfg.image_size // 4
    m = 3 if use_multimask(cfg, is_init=False, num_pts=0) else 1
    shapes = {"pred_masks": (2, 1, s4, s4), "obj_ptr": (2, cfg.hidden_dim),
              "object_score_logits": (2, 1), "ious": (2, m)}
    ok = True
    for i, o in enumerate(outs):
        for k, shape in shapes.items():
            if tuple(o[k].shape) != shape or not bool(torch.isfinite(o[k]).all()):
                log(f"[main] step {i + 1} {k}: shape {tuple(o[k].shape)} "
                    f"(want {shape}) or non-finite values")
                ok = False
    return ok


def profile_steps(eng, frames, bank):
    """N_PROFILE more stream_steps of the phase-2 session under
    torch.profiler (after its counts were read): device time by kernel and
    the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    first = N_STREAM + 1
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(first, first + N_PROFILE):
            bank, _ = eng.stream_step(frames[t:t + 1], bank, t, NUM_FRAMES)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0 and getattr(e, "device_type", None) is not None and \
                str(e.device_type).endswith("CUDA"):
            rows.append((dev_us / 1e3 / N_PROFILE, e.count / N_PROFILE, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    per_frame_wall = wall_ms / N_PROFILE
    log(f"[profile] {N_PROFILE} stream_steps under torch.profiler: wall "
        f"{per_frame_wall:.3f} ms/frame, device busy {busy:.3f} ms/frame, idle "
        f"share {max(0.0, 1 - busy / per_frame_wall):.3f}, "
        f"{sum(r[1] for r in rows):g} device operations (kernels, copies, "
        f"fills) per frame under {len(rows)} names")
    for ms, n, key in rows[:15]:
        log(f"[profile]   {ms:8.3f} ms/frame {100 * ms / busy:5.1f}%  x{n:g}  {key[:90]}")


def phase_main(dev):
    from det_sam2_tpu_torch.configs import sam2_1_hiera_s
    from det_sam2_tpu_torch.ops import attention as att

    cfg = sam2_1_hiera_s()
    eng = make_engine(cfg, plain=False)
    g = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randint(0, 256, (N_STREAM + 1 + N_PROFILE, cfg.image_size,
                                    cfg.image_size, 3),
                           generator=g, device=dev, dtype=torch.uint8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    init_counts = {}
    timings = []
    att.reset_launch_counts()
    outs, bank = run_session(eng, frames, True, N_STREAM, timings,
                             after_init=lambda: init_counts.update(att.LAUNCHES))
    torch.cuda.synchronize()
    launches = dict(att.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    profile_steps(eng, frames, bank)
    steady = timings[N_WARM:]
    ms = float(np.mean(steady))
    per_frame = {k: (launches[k] - init_counts[k]) / N_STREAM for k in launches}
    ok = check_outputs(outs, cfg)
    fg = [float((o["pred_masks"] > 0).float().mean()) for o in outs]
    log(f"[main] hiera-S {cfg.image_size}^2 bf16, 2 objects, banked bank "
        f"(banked_layers={eng.banked_layers}): {N_STREAM} stream_steps, "
        f"ms/frame {ms:.3f} (mean of steps {N_WARM + 1}..{N_STREAM}; median "
        f"{float(np.median(steady)):.3f}, min {min(steady):.3f}, max "
        f"{max(steady):.3f}; first step {timings[0]:.1f}) FPS {1e3 / ms:.2f} "
        f"peak_mem {peak / 2 ** 30:.3f} GiB")
    log(f"[main] launches in the session: {launches}; per stream_step: {per_frame} "
        f"(expected flash_fwd 7 = 3 Hiera global + 4 memory self-attn, "
        f"flash_banked_fwd 4 = memory cross-attn)")
    log(f"[main] object scores at the last step "
        f"{outs[-1]['object_score_logits'].flatten().tolist()}, foreground share "
        f"per step min {min(fg):.4f} max {max(fg):.4f}")
    if per_frame["flash_fwd"] != 7 or per_frame["flash_banked_fwd"] != 4:
        log("[main] unexpected launch counts per frame")
        ok = False
    return ok, launches, (eng, frames, outs[:N_CHECK])


def _compare(label, ref, got) -> bool:
    """Over the steps, per object: sign agreement of the mask logits and
    the max-abs difference of obj_ptr (gated); the correlation of the
    centred logits is reported only (the fp32 session shows what two
    sessions that differ only in rounding read)."""
    agree, corr, ptr = [], [], []
    for a, b in zip(ref, got):
        ma, mb = a["pred_masks"].flatten(1), b["pred_masks"].flatten(1)
        agree.append(((ma > 0) == (mb > 0)).float().mean(1))
        ca, cb = ma - ma.mean(1, keepdim=True), mb - mb.mean(1, keepdim=True)
        corr.append((ca * cb).sum(1) / (ca.norm(dim=1) * cb.norm(dim=1)).clamp_min(1e-30))
        ptr.append(float((a["obj_ptr"] - b["obj_ptr"]).abs().max())
                   / (PTR_REL * float(a["obj_ptr"].abs().max())))
    agree, corr = torch.stack(agree), torch.stack(corr)  # [steps, objects]
    good = float(agree.min()) >= SIGN_AGREE and max(ptr) <= 1
    log(f"[checks] {label}, {len(ptr)} steps: mask sign agreement min per object "
        f"{[round(x, 5) for x in agree.min(0).values.tolist()]} (>= {SIGN_AGREE}), "
        f"logit correlation {float(corr.min()):.5f}-{float(corr.max()):.5f}, "
        f"obj_ptr max_abs of tolerance {max(ptr):.3f} {'OK' if good else 'FAIL'}")
    return good


# bf16 sessions that differ only in where bf16 rounding happens (kernel vs
# plain softmax order; banked keys = cached bf16 K + fp32 correction vs
# gather keys = rope(k_proj(bf16 memory + pos))): a few logits near 0 may
# flip sign, and object pointers drift by a few bf16 ulps (2^-8 relative)
# per layer; 5% of the largest pointer entry bounds that drift. With random
# weights the masks and pointers hardly depend on the memory: on an H100 a
# session with K2's output zeroed still agrees in sign on 99% of pixels, so
# the taps and the in-context check below are what catch a wrong kernel.
SIGN_AGREE = 0.99
PTR_REL = 0.05
# The raw memory cross-attention outputs (P @ memory values, [B, 4096, 64]
# per layer and step) of two correct sessions: relative L2 distance. On an
# H100 correct sessions (fp32 vs bf16 included) read <= 0.007, a zeroed or
# mis-slotted K2 0.4-1.
TAP_REL = 0.05


def _planted_k2(fault: str):
    """K2's wrapper with a planted fault, for a session that must fail."""
    from det_sam2_tpu_torch.ops import attention as att

    def fn(q, mem_k, mem_v, slots, w, bias, cos, sin, layer):
        if fault == "K2 output zeroed":
            return q.new_zeros(q.shape[:3] + (mem_v.shape[-1],))
        if fault == "K2 reads the slots rolled by one":
            slots = torch.roll(slots, 1)
        if fault == "K2 leaves out the RoPE correction":
            w = torch.zeros_like(w)
        return att.flash_attention_banked(q, mem_k, mem_v, slots, w, bias, cos,
                                          sin, layer)
    return fn


PLANTED = ("K2 output zeroed", "K2 reads the slots rolled by one",
           "K2 leaves out the RoPE correction")


def _session(eng, frames, banked: bool, check: bool = False, fault=None):
    """A phase-3 session of N_CHECK stream_steps whose memory cross-attention
    calls (K2 in banked mode, K1 in gather mode, or their plain versions)
    go through a tap: it keeps each call's raw output P @ memory values
    [B, Nq, Cm] in fp32 and, with check=True, holds it against the plain
    version on the same inputs by phase 1's rule. fault plants a fault in
    K2's wrapper. Returns (outputs, taps, held)."""
    from det_sam2_tpu_torch.modeling.layers import sdpa
    from det_sam2_tpu_torch.ops import attention as att

    taps, held = [], []
    mods = [layer.cross_attn_image for layer in eng.model.memory_attention.layers]
    saved = [(m.attention_fn, m.banked_attention_fn) for m in mods]
    dense_fn, banked_fn = saved[0]
    if fault is not None:
        banked_fn = _planted_k2(fault)

    def banked_tap(q, mem_k, mem_v, slots, w, bias, cos, sin, layer):
        o = banked_fn(q, mem_k, mem_v, slots, w, bias, cos, sin, layer)
        if check:
            held.append(_held(o[:, 0], att.flash_attention_banked_ref(
                q[:, 0], mem_k, mem_v, slots, w, bias, cos, sin, layer), q.dtype))
        taps.append(o[:, 0].float())
        return o

    def dense_tap(q, k, v, bias=None):
        o = dense_fn(q, k, v, bias=bias)
        if check:
            held.append(_held(o, sdpa(q, k, v, bias), q.dtype))
        taps.append(o[:, 0].float())
        return o

    for m in mods:
        m.attention_fn, m.banked_attention_fn = dense_tap, banked_tap
    try:
        outs, _ = run_session(eng, frames, banked, N_CHECK)
    finally:
        for m, (a, b) in zip(mods, saved):
            m.attention_fn, m.banked_attention_fn = a, b
    return outs, taps, held


def _taps_agree(label, ref, got) -> bool:
    rel = [float((a - b).norm() / a.norm().clamp_min(1e-30)) for a, b in zip(ref, got)]
    good = len(ref) == len(got) and max(rel) <= TAP_REL
    log(f"[checks] {label}: memory cross-attention outputs, {len(rel)} calls, "
        f"relative L2 distance max {max(rel):.4g} median {float(np.median(rel)):.4g} "
        f"(<= {TAP_REL}) {'OK' if good else 'FAIL'}")
    return good


def _held_in_context(label, held) -> bool:
    good = all(h["good"] for h in held)
    worst = max(held, key=lambda h: max(h["max_ulps"], h["mean_eps"]))
    log(f"[checks] {label}: {len(held)} memory cross-attention calls held against "
        f"the plain version on the same inputs, worst {_fmt(worst)} "
        f"{'OK' if good else 'FAIL'}")
    return good


def phase_checks(state):
    eng, frames, main_outs = state
    cfg = eng.cfg
    # the phase-2 kernel session again, every K2 call held in context
    outs, ref_taps, held = _session(eng, frames, True, check=True)
    ok = _held_in_context("kernels, banked", held)
    ok &= _compare("kernels rerun vs phase 2", main_outs, outs)
    # gather mode: K1 with a bias in place of K2, every call held in context
    outs, taps, held = _session(eng, frames, False, check=True)
    ok &= _held_in_context("kernels, gather mode", held)
    ok &= check_outputs(outs, cfg) & _compare("gather mode vs banked", main_outs, outs)
    ok &= _taps_agree("gather mode vs banked", ref_taps, taps)
    plain_eng = make_engine(cfg, plain=True)
    plain, plain_taps, _ = _session(plain_eng, frames, True)
    del plain_eng
    ok &= check_outputs(plain, cfg) & _compare("plain kernels vs kernels", plain, main_outs)
    ok &= _taps_agree("plain kernels vs kernels", plain_taps, ref_taps)
    # the same model in fp32 with the plain versions (tanh GELU as in bf16,
    # TF32 off): what two correct sessions that differ only in rounding read
    f32_eng = make_engine(dataclasses.replace(cfg, use_approx_gelu=True), plain=True,
                          dtype=torch.float32)
    f32, f32_taps, _ = _session(f32_eng, frames, True)
    del f32_eng
    ok &= check_outputs(f32, cfg)
    ok &= _compare("plain fp32 vs kernels", f32, main_outs)
    ok &= _compare("plain fp32 vs plain bf16", f32, plain)
    ok &= _taps_agree("plain fp32 vs kernels", f32_taps, ref_taps)
    ok &= _taps_agree("plain fp32 vs plain bf16", f32_taps, plain_taps)
    # planted faults in K2's wrapper on the main path: each session must fail
    for fault in PLANTED:
        bad, taps, held = _session(eng, frames, True, check=True, fault=fault)
        caught = [name for name, good in (
            ("masks / obj_ptr", _compare(f"planted '{fault}'", main_outs, bad)),
            ("cross-attention outputs", _taps_agree(f"planted '{fault}'", ref_taps, taps)),
            ("in-context check", _held_in_context(f"planted '{fault}'", held)),
        ) if not good]
        log(f"[checks] planted fault '{fault}': "
            f"{'caught by ' + ', '.join(caught) if caught else 'MISSED'}")
        ok &= bool(caught)
    return ok


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; nothing was run")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(gpu_line())
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    from det_sam2_tpu_torch.ops import attention as att

    t0 = time.time()
    paths = att.build_kernels()
    log(f"[build] {len(paths)} kernels in {time.time() - t0:.1f} s")
    for name, path in paths.items():
        rep = path.with_suffix(".log")
        if rep.exists():
            for line in rep.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")

    results = []
    ok = phase_kernels(dev, results)
    ok_main, launches, state = phase_main(dev)
    ok &= ok_main
    ok &= phase_checks(state)
    for r in results:
        r["launches"] = launches[r.pop("kernel")]
    for name in att.LAUNCHES:
        if launches[name] <= 0:
            log(f"[main] kernel {name} was not launched by the main path")
            ok = False
    if not ok:
        log("chip_smoke: FAILED")
        return 1
    log(gpu_line())
    log(json.dumps({"kernels": results}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
