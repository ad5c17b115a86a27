"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py            # four phases, one card

Phase 1 (kernels): builds every CUDA kernel of the two paths from
det_sam2_tpu_torch/csrc (nvcc, in parallel) and holds each one against its
plain PyTorch version at the shapes the paths give it (serving: hiera-S,
1024^2, 2 objects; training: hiera-b+, 1024^2, T = 8, 3 objects), in bf16
and fp32 with TF32 off; K2's key pre-pass must equal its plain version bit
for bit; times kernel, plain version and torch's
scaled_dot_product_attention (forward for K1, backward for K3a / K3b) as a
yardstick, and prints the library backward's own error against K3's plain
version; K3 launched twice must give the same bits. Planted faults (a
skipped key tile, the consumer reading the wrong ring stage, a wrong slot,
no RoPE correction, the pre-pass leaving out one tile's correction, dq
without the delta term, dv from the wrong tile, K3's products in one TF32
pass, ...) must fail the same check, K3's by at least 7x.
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
Phase 4 (training path): the MOSE finetune recipe's train step at full
width (hiera-b+ 1024^2, fp32, T = 8, 3 objects, batch 1, drop-path 0.1,
rematerialised image encoder) on seeded random weights and seeded synthetic
clips, for box, click-with-corrections and GT-mask prompt schedules; prints
each step's loss terms, grad_norm, ms, peak memory and the K1 / K3a / K3b
launches against the count the schedule implies. Then one step's gradients
with the kernels against the plain forward and backward on the card, gated
by the spread of two plain runs that differ only in rounding (TF32 on), and
two sessions with a fault planted in K3's wrappers that must fail the gate.

Prints the card's name and power limit, one JSON line with the kernel table,
and last the device line. Exits non-zero, printing no result, when there is
no CUDA card or any check fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # H100 SXM dense
# K3a / K3b take their fp32-grade products on the tensor cores as 3xTF32:
# three TF32 passes a product at 495 TFLOP/s (K1 fp32 stays on the CUDA
# cores, 67 TFLOP/s)
PEAK_TF32 = 495e12
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
# K3a / K3b take their fp32 products as 3xTF32 on the tensor cores (each
# operand split into two TF32 parts, three passes): on an H100 they read <=
# 0.21 of the mean part of this gate, the library's own fp32 backward (also
# 3xTF32) 0.16-0.23 against the same plain version (phase 1 prints both),
# and a planted single TF32 pass ~66-73x; so the fp32 gate holds K3 too.
MAX_ULPS = {torch.bfloat16: 4, torch.float32: 1024}
MEAN_EPS = {torch.bfloat16: 0.4, torch.float32: 64}
K1_SRC = "det_sam2_tpu_torch/csrc/flash_fwd.cu"
K2_SRC = "det_sam2_tpu_torch/csrc/flash_banked_fwd.cu"
K2_KEYS_SRC = "det_sam2_tpu_torch/csrc/flash_banked_keys.cu"
K3A_SRC = "det_sam2_tpu_torch/csrc/flash_bwd_dq.cu"
K3B_SRC = "det_sam2_tpu_torch/csrc/flash_bwd_dkv.cu"
K1_TPU = "det_sam2_tpu/ops/attention.py:48"
K2_TPU = "det_sam2_tpu/ops/attention.py:448"
K3A_TPU = "det_sam2_tpu/ops/attention.py:196"
K3B_TPU = "det_sam2_tpu/ops/attention.py:248"


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


def bound_ms(flops: float, nbytes: float, dtype, peak=None):
    """(least ms, "operations" or "bytes"): the larger of FLOPs over the
    peak rate (PEAK_FLOPS[dtype] unless `peak` is given) and bytes over the
    memory rate."""
    t_ops = flops / (PEAK_FLOPS[dtype] if peak is None else peak)
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
        # training path: hiera-b+ global blocks, 8 frames x 8 heads, D = 56
        ("hiera_bplus_global", 64, 4096, 4096, 56, 56, None),
        # training path: memory self- and cross-attention of 3 objects (the
        # cross-attention's memory is all valid: a zero bias on every key)
        ("memory_self_attn_train", 3, 4096, 4096, 256, 256, None),
        ("memory_cross_attn_train", 3, 4096, 7 * s + 28, 256, 64, []),
    ]


# the kernels' rows of the JSON line: (label, dtype) -> the path whose run
# counts its launches
K1_ROWS = {("hiera_global", torch.bfloat16): "serving",
           ("memory_self_attn", torch.bfloat16): "serving",
           ("gather_cross_attn", torch.bfloat16): "serving",
           ("hiera_bplus_global", torch.float32): "training",
           ("memory_self_attn_train", torch.float32): "training",
           ("memory_cross_attn_train", torch.float32): "training"}


def _k3_cases():
    nk = 7 * 4096 + 28  # 1 cond + 6 non-cond tiles + 7 pointers x 4 tokens
    return [
        # (label, bh, nq, nk, d, dv, dead key ranges or None for no bias)
        ("hiera_bplus_global", 64, 4096, 4096, 56, 56, None),
        ("memory_self_attn", 3, 4096, 4096, 256, 256, None),
        # training memory is all valid: a zero bias on every key
        ("memory_cross_attn", 3, 4096, nk, 256, 64, []),
        ("ragged_edges", 3, 100, 200, 40, 24, [(0, 64, 128), (2, 0, 200)]),
    ]


# planted faults of K3 (att.BWD_FAULTS), per case, in both element types;
# every fp32 case also plants "one TF32 pass" (hi * hi alone), which must
# fail the fp32 gate: the gate tells fp32-grade products from TF32
K3_FAULTS = {
    "hiera_bplus_global": ("dq without the delta term", "a live key tile skipped",
                           "dv from the wrong tile"),
    "ragged_edges": ("dq without the delta term", "a live key tile skipped",
                     "P not zeroed where lse <= -1e29", "dv from the wrong tile"),
}
K3_F32_FAULT = "one TF32 pass"
# K3's planted faults, "one TF32 pass" included, must fail the gate by at
# least this factor: a fault that reads just above the gate would say the
# gate barely tells a wrong backward (or a TF32 one) from a right one
K3_FAULT_MARGIN = 7.0


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
    `mean_eps` are the errors in those units (the gates are 1). A
    non-finite output fails."""
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    err, mean = float(diff.max()), float(diff.mean())
    if not bool(torch.isfinite(out).all()):
        max_ulps = mean_eps = math.inf
    elif float(mag.max()) == 0:  # no live key anywhere: the output must be 0
        max_ulps = mean_eps = 0.0 if err == 0 else math.inf
    else:
        max_ulps = err / (MAX_ULPS[dtype] * _ulp(float(mag.max()), dtype))
        mean_eps = mean / (MEAN_EPS[dtype] * torch.finfo(dtype).eps
                           * float(mag.mean()))
    return dict(err=err, mean=mean, max_ulps=max_ulps, mean_eps=mean_eps,
                good=bool(max_ulps <= 1 and mean_eps <= 1))


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
    "hiera_bplus_global": [("one KV tile skipped", [(None, 9 * 64, 10 * 64)])],
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
    one_tile = w.clone()
    one_tile[1] = 0.0  # the pre-pass builds tile 1's keys without its correction
    return [
        ("RoPE correction left out", slots, torch.zeros_like(w), bias),
        ("pre-pass leaves out tile 1's correction", slots, one_tile, bias),
        ("wrong slot for one tile", wrong, w, bias),
        ("staging tile read from another row", staging, w, bias),
        ("one KV tile skipped", slots, w,
         _kill(bias, None, None, [(None, s + 5 * 64, s + 6 * 64)])),
    ]


def _caught(kernel, label, fault, h, margin=1.0) -> bool:
    """The fault fails the tolerance, by at least `margin` times its max or
    its mean part."""
    caught = not h["good"] and max(h["max_ulps"], h["mean_eps"]) >= margin
    log(f"[faults] {kernel} {label}: planted '{fault}': {_fmt(h)} "
        f"{'caught' if caught else 'MISSED'}"
        + (f" (needs >= {margin:g}x)" if margin > 1 else ""))
    return caught


def host_us(fn, n: int = 200) -> float:
    """Host time of one call of fn, enqueued back to back (no synchronise
    inside the window): what a call costs the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def host_cost(dev):
    """The host time of K1's wrapper at a tiny shape: bf16 encodes three TMA
    tensor maps a call, fp32 none; the difference is what the tensor maps
    cost the host."""
    from det_sam2_tpu_torch.ops import attention as att

    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, bias = _k1_inputs(0, 3, 100, 200, 40, 24, dtype, [(0, 64, 128)], dev)
        times[dtype] = host_us(lambda: att.flash_attention_fwd(q, k, v, bias))
    log(f"[host] flash_fwd wrapper, host us a call at q[3, 100, 40]: bf16 (3 tensor maps "
        f"encoded) {times[torch.bfloat16]:.2f}, fp32 (none) {times[torch.float32]:.2f}")


def phase_kernels(dev, results):
    from det_sam2_tpu_torch.ops import attention as att

    host_cost(dev)
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
                for fault, code in att.FWD_FAULTS.items():
                    bad, _ = att.flash_attention_fwd(q, k, v, bias, fault=code)
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
            if (label, dtype) in K1_ROWS:
                results.append(dict(
                    name=f"flash_fwd:{label}", route="cuda", source=K1_SRC,
                    replaces=K1_TPU, kernel="flash_fwd", path=K1_ROWS[label, dtype],
                    dtype=str(dtype)[6:],
                    shape=dict(q=list(q.shape), k=list(k.shape), v=list(v.shape),
                               bias=None if bias is None else list(bias.shape)),
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                    bound_by=by, bound_scheme=(
                        "bf16 tensor cores: FLOPs / 989 TFLOP/s" if dtype == torch.bfloat16
                        else "fp32 CUDA cores: FLOPs / 67 TFLOP/s"), library_ms=lib))
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
            # the pre-pass alone: its keys equal the plain version's bit for bit
            s_pad = -(-s // att.K2_TILE) * att.K2_TILE
            kargs = (mem_k, slots_t, w, cos, sin, layer, s_pad)
            keys = att.flash_banked_keys(*kargs)
            keys_ref = att.banked_keys(mem_k, slots_t, w, cos, sin, layer, dtype, s_pad)
            torch.cuda.synchronize()
            keys_err = float((keys.float() - keys_ref.float()).abs().max())
            live_rows = (bias > -1e29).any(-1)
            h = _held(out, ref, dtype)
            err = h["err"]
            good = (bool(torch.isfinite(out).all())
                    and bool((out[~live_rows] == 0).all()) and h["good"]
                    and bool(torch.equal(keys, keys_ref)))
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
            # main kernel alone on the pre-pass's keys (its bound needs the same
            # rows, with the keys read once in place of the bank rows)
            margs = (q, keys, mem_v, slots_t, bias)
            b_main, by_main = bound_ms(flops, nbytes(q, bias, out) + rows, dtype)
            # pre-pass: reads the attended bank rows, the tables and w once,
            # writes the keys
            attended = sum(1 for x in slots if 0 <= x < ktot)
            kbytes = (attended * b * s * d * q.element_size() + nbytes(cos, sin, w, keys))
            b_keys, by_keys = bound_ms(0.0, kbytes, dtype)
            iters = 20 if dtype == torch.bfloat16 else 3
            ms = time_ms(lambda: att.flash_attention_banked_fwd(*args), iters)
            ms_main = time_ms(lambda: att.flash_banked_attend(*margs), iters)
            ms_keys = time_ms(lambda: att.flash_banked_keys(*kargs), iters)
            plain = time_ms(lambda: att.flash_attention_banked_ref(*args), 3, 1)
            plain_main = time_ms(lambda: att.flash_banked_attend_ref(*margs), 3, 1)
            plain_keys = time_ms(lambda: att.banked_keys(
                mem_k, slots_t, w, cos, sin, layer, dtype, s_pad), 3, 1)
            log(f"[kernels] flash_banked_fwd {label} {str(dtype)[6:]} q{list(q.shape)} "
                f"mem_k{list(mem_k.shape)} mem_v{list(mem_v.shape)} slots{slots} "
                f"layer {layer}: {_fmt(h)} pre-pass keys max_abs_err {keys_err:.3g} | "
                f"K2 (pre-pass + main) ms {ms:.4f} plain_ms {plain:.4f} bound_ms "
                f"{bnd:.4f} ({by}); main ms {ms_main:.4f} plain_ms {plain_main:.4f} "
                f"bound_ms {b_main:.4f} ({by_main}); pre-pass ms {ms_keys:.4f} plain_ms "
                f"{plain_keys:.4f} bound_ms {b_keys:.4f} ({by_keys}) "
                f"{'OK' if good else 'FAIL'}")
            if dtype == torch.bfloat16 and label != "ragged_edges":
                shape = dict(q=list(q.shape), mem_k=list(mem_k.shape),
                             mem_v=list(mem_v.shape), slots=len(slots),
                             keys=list(keys.shape))
                results.append(dict(
                    name=f"flash_banked_fwd:{label}", route="cuda", source=K2_SRC,
                    replaces=K2_TPU, kernel="flash_banked_fwd", path="serving",
                    dtype="bfloat16", shape=shape, max_abs_err=err, ms=ms_main,
                    plain_ms=plain_main, bound_ms=b_main, bound_by=by_main,
                    bound_scheme="bf16 tensor cores: FLOPs / 989 TFLOP/s",
                    library_ms=None))
                results.append(dict(
                    name=f"flash_banked_keys:{label}", route="cuda", source=K2_KEYS_SRC,
                    replaces=K2_TPU, kernel="flash_banked_keys", path="serving",
                    dtype="bfloat16", shape=shape, max_abs_err=keys_err, ms=ms_keys,
                    plain_ms=plain_keys, bound_ms=b_keys, bound_by=by_keys,
                    bound_scheme="memory: bytes / 3.35 TB/s", library_ms=None))
            del args, margs, kargs, q, mem_k, mem_v, out, ref, keys, keys_ref
            torch.cuda.empty_cache()
    return ok & phase_backward_kernels(dev, results)


def _sdpa_backward(q, k, v, bias, dout, iters):
    """One F.scaled_dot_product_attention call's backward (yardstick): (ms,
    its (dq, dk, dv))."""
    qq, kk, vv = (x[:, None].detach().requires_grad_() for x in (q, k, v))
    mask = None
    if bias is not None and bool((bias <= -1e29).any()):
        mask = (bias > -1e29)[:, None, None, :]
    o = F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)
    g = dout[:, None]
    grads = [x[:, 0] for x in torch.autograd.grad(o, (qq, kk, vv), g, retain_graph=True)]
    ms = time_ms(lambda: torch.autograd.grad(o, (qq, kk, vv), g, retain_graph=True),
                 iters)
    del o
    return ms, grads


def phase_backward_kernels(dev, results):
    """K3a / K3b against flash_attention_bwd_ref on the same inputs (q, k,
    v, bias, out and lse of the plain forward, a random dO) at the training
    path's shapes, bf16 and fp32; a second launch must give the same bits;
    planted faults; the library backward's own error against the same plain
    version; times. Bounds: fp32 at the 3xTF32 rate (3 x FLOPs at 495
    TFLOP/s, the scheme the kernels run), the CUDA-core rate printed beside
    it."""
    from det_sam2_tpu_torch.ops import attention as att

    ok = True
    for i, (label, bh, nq, nk, d, dv, dead) in enumerate(_k3_cases()):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, bias = _k1_inputs(200 + i, bh, nq, nk, d, dv, dtype, dead, dev)
            g = torch.Generator(device=dev).manual_seed(300 + i)
            dout = torch.randn(bh, nq, dv, generator=g, device=dev).to(dtype)
            out, lse = att.flash_attention_ref(q, k, v, bias)
            delta = (dout.float() * out.float()).sum(-1)
            args = (q, k, v, bias, dout, lse, delta)
            got = (att.flash_bwd_dq(*args),) + att.flash_bwd_dkv(*args)
            again = (att.flash_bwd_dq(*args),) + att.flash_bwd_dkv(*args)
            refs = att.flash_attention_bwd_ref(q, k, v, bias, out, lse, dout)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            del again
            held = [_held(a, b, dtype) for a, b in zip(got, refs)]
            good = same and all(h["good"] for h in held)
            if bias is not None:
                dead_rows = ~(bias > -1e29).any(-1)
                good &= all(bool((x[dead_rows] == 0).all()) for x in got)
            ok &= good
            faults = K3_FAULTS.get(label, ())
            if dtype == torch.float32:
                faults = faults + (K3_F32_FAULT,)
            for fault in faults:
                code = att.BWD_FAULTS[fault]
                bad = (att.flash_bwd_dq(*args, fault=code),) + att.flash_bwd_dkv(
                    *args, fault=code)
                hs = [_held(a, b, dtype) for a, b in zip(bad, refs)]
                worst = max(hs, key=lambda h: max(h["max_ulps"], h["mean_eps"]))
                ok &= _caught("flash_bwd", f"{label} {str(dtype)[6:]}", fault, dict(
                    worst, good=all(h["good"] for h in hs)), K3_FAULT_MARGIN)
                del bad
            live = bh * nk if bias is None else int((bias > -1e29).sum())
            kv = live * (d + dv) * q.element_size()
            common = nbytes(q, dout.float(), lse, delta, bias) + kv
            f_dq, f_dkv = 2.0 * nq * live * (2 * d + dv), 2.0 * nq * live * (2 * d + 2 * dv)
            by_dq, by_dkv = common + nbytes(got[0]), common + nbytes(got[1], got[2])
            if dtype == torch.float32:  # three TF32 passes a product
                b_dq = bound_ms(3 * f_dq, by_dq, dtype, PEAK_TF32)
                b_dkv = bound_ms(3 * f_dkv, by_dkv, dtype, PEAK_TF32)
                scheme = "3xTF32 tensor cores: 3 x FLOPs / 495 TFLOP/s"
            else:
                b_dq, b_dkv = bound_ms(f_dq, by_dq, dtype), bound_ms(f_dkv, by_dkv, dtype)
                scheme = "bf16 tensor cores: FLOPs / 989 TFLOP/s"
            core_dq = bound_ms(f_dq, by_dq, torch.float32)[0]
            core_dkv = bound_ms(f_dkv, by_dkv, torch.float32)[0]
            iters = 10 if dtype == torch.bfloat16 else 3
            ms_dq = time_ms(lambda: att.flash_bwd_dq(*args), iters)
            ms_dkv = time_ms(lambda: att.flash_bwd_dkv(*args), iters)
            plain = time_ms(lambda: att.flash_attention_bwd_ref(q, k, v, bias, out, lse,
                                                                dout), 2, 1)
            lib, lib_held = None, None
            if label != "ragged_edges":
                lib, lib_grads = _sdpa_backward(q, k, v, bias, dout, iters)
                lib_held = [_held(a, b, dtype) for a, b in zip(lib_grads, refs)]
                del lib_grads
            log(f"[kernels] flash_bwd {label} {str(dtype)[6:]} q{list(q.shape)} "
                f"k{list(k.shape)} v{list(v.shape)} bias="
                f"{'no' if bias is None else 'yes'}: "
                + "; ".join(f"{n} {_fmt(h)}" for n, h in zip(("dq", "dk", "dv"), held))
                + f"; two launches bit-identical {same}"
                + ("" if lib_held is None else " | library backward vs the same plain: "
                   + "; ".join(f"{n} {_fmt(h)}" for n, h in zip(("dq", "dk", "dv"), lib_held)))
                + f" | dq ms {ms_dq:.4f} bound {b_dq[0]:.4f} ({b_dq[1]}; {scheme}; fp32 "
                f"CUDA cores {core_dq:.4f}), dkv ms {ms_dkv:.4f} bound {b_dkv[0]:.4f} "
                f"({b_dkv[1]}; CUDA cores {core_dkv:.4f}), plain_ms (both) {plain:.4f}, "
                f"sdpa_backward_ms {'n/a' if lib is None else f'{lib:.4f}'} "
                f"{'OK' if good else 'FAIL'}")
            if dtype == torch.float32 and label != "ragged_edges":
                shape = dict(q=list(q.shape), k=list(k.shape), v=list(v.shape),
                             bias=None if bias is None else list(bias.shape))
                for name, src, tpu, h, m, (bnd, by) in (
                        ("flash_bwd_dq", K3A_SRC, K3A_TPU, held[0], ms_dq, b_dq),
                        ("flash_bwd_dkv", K3B_SRC, K3B_TPU,
                         max(held[1:], key=lambda h: h["err"]), ms_dkv, b_dkv)):
                    results.append(dict(
                        name=f"{name}:{label}", route="cuda", source=src, replaces=tpu,
                        kernel=name, path="training", dtype="float32", shape=shape,
                        max_abs_err=h["err"], ms=m, plain_ms=plain, bound_ms=bnd,
                        bound_by=by, bound_scheme=scheme,
                        library_ms=lib, library_max_abs_err=max(
                            x["err"] for x in lib_held)))
            del q, k, v, bias, dout, out, lse, delta, args, got, refs
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
        f"flash_banked_keys 4 + flash_banked_fwd 4 = memory cross-attn)")
    log(f"[main] object scores at the last step "
        f"{outs[-1]['object_score_logits'].flatten().tolist()}, foreground share "
        f"per step min {min(fg):.4f} max {max(fg):.4f}")
    if (per_frame["flash_fwd"] != 7 or per_frame["flash_banked_fwd"] != 4
            or per_frame["flash_banked_keys"] != 4):
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
# phase 4: the training path (MOSE finetune recipe) and its checks
# ---------------------------------------------------------------------------

TRAIN_T = 8  # frames per clip (the recipe's scratch.num_frames)
TRAIN_OBJECTS = 3
N_TRAIN = 5  # train steps: box, click-with-corrections, GT-mask, then two more
# Gradient gate of the in-context check: relative L2 of each watched
# parameter's gradient, kernels vs plain, at most GRAD_SPREAD_X times the
# largest one between two plain runs that differ only in rounding (TF32 on
# in one), and never above GRAD_GATE_CAP: a zeroed dq or dk takes a
# projection's gradient (nearly) all the way to relative error 1.
GRAD_SPREAD_X = 3.0
GRAD_GATE_FLOOR = 1e-3
GRAD_GATE_CAP = 0.3


def make_trainer(cfg, attention_fn, dev, seed: int = 0):
    """hiera-b+ SAM2Model with the seeded random init, the object-score
    head's output bias +1 (so objects count as present and the masks, and
    their gradients, depend on the features), fp32, on `dev`."""
    from det_sam2_tpu_torch import convert
    from det_sam2_tpu_torch.modeling.sam2_base import SAM2Model

    model = SAM2Model(cfg, attention_fn=attention_fn)
    sd = convert.init_params(model, seed)
    sd["sam_mask_decoder.pred_obj_score_head.layers.2.bias"].fill_(1.0)
    model.load_state_dict(sd)
    return model.to(dev)


def synthetic_clip(cfg, t, k, seed, dev):
    """Seeded noise frames [T, 1, S, S, 3] (normalised) with k rectangles
    moving over the clip, brighter than the noise; their masks are the GT
    [T, 1, k, S, S]."""
    s = cfg.image_size
    g = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randn(t, 1, s, s, 3, generator=g, device=dev) * 0.5
    gt = torch.zeros(t, 1, k, s, s, device=dev)
    for j in range(k):
        y0, x0 = 100 + 250 * j, 120 + 230 * j
        for i in range(t):
            gt[i, 0, j, y0 + 12 * i:y0 + 200 + 12 * i, x0 + 8 * i:x0 + 220 + 8 * i] = 1.0
    return images + gt.amax(2)[..., None], gt


def _kind(sch) -> str:
    if not sch.use_pt_input:
        return "GT-mask"
    return "box" if sch.use_box_per_frame[0] else "click"


def pick_schedules(conf, t: int, n: int):
    """n (seed, schedule) pairs of sample_prompt_schedule: the first seeds
    that give a box, a click and a GT-mask schedule, then the next seeds."""
    from det_sam2_tpu_torch.training.sam2_train import sample_prompt_schedule

    first, rest = {}, []
    for seed in range(10_000):
        sch = sample_prompt_schedule(np.random.default_rng(seed), t, conf)
        if _kind(sch) not in first:
            first[_kind(sch)] = (seed, sch)
        elif len(rest) < n:
            rest.append((seed, sch))
        if len(first) == 3 and len(rest) >= n:
            break
    out = [first["box"], first["click"], first["GT-mask"]] + rest
    return out[:n]


def expected_launches(cfg, sch, t: int) -> dict:
    """K1 runs in the Hiera global blocks twice (forward and the remat
    recompute) and in memory self- and cross-attention of every layer of
    every non-cond frame; K3a and K3b once for each K1 forward that is
    differentiated."""
    glob = len(cfg.hiera.global_att_blocks)
    mem = 2 * cfg.memory_attention.num_layers * (t - len(sch.init_cond_frames))
    return {"flash_fwd": 2 * glob + mem, "flash_bwd_dq": glob + mem,
            "flash_bwd_dkv": glob + mem}


def phase_train(dev):
    """MOSE recipe train steps at full width. Returns (ok, launches, state)."""
    from det_sam2_tpu_torch.ops import attention as att
    from det_sam2_tpu_torch.training.recipes import mose_finetune_recipe
    from det_sam2_tpu_torch.training.train_step import make_optimizer, make_train_step

    recipe = mose_finetune_recipe(total_steps=1000)
    cfg = recipe.model
    model = make_trainer(cfg, att.flash_attention, dev)
    opt = make_optimizer(recipe.optim, model, cfg)
    step = make_train_step(cfg, model, opt, loss_fn=recipe.loss)
    images, gt = synthetic_clip(cfg, TRAIN_T, TRAIN_OBJECTS, 0, dev)
    schedules = pick_schedules(recipe.sample, TRAIN_T, N_TRAIN)
    gen = torch.Generator(device=dev).manual_seed(0)
    log(f"[train] hiera-b+ {cfg.image_size}^2 fp32, T={TRAIN_T}, {TRAIN_OBJECTS} objects, "
        f"batch 1, drop_path_rate {cfg.hiera.drop_path_rate}, remat on, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    ok = True
    torch.cuda.synchronize()
    att.reset_launch_counts()
    for i, (seed, sch) in enumerate(schedules):
        before = dict(att.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = step(images, gt, gen, schedule=sch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        vals = {k: float(v) for k, v in metrics.items()}
        got = {k: att.LAUNCHES[k] - before[k] for k in
               ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        want = expected_launches(cfg, sch, TRAIN_T)
        finite = all(math.isfinite(v) for v in vals.values())
        good = finite and got == want
        ok &= good
        log(f"[train] step {i + 1} schedule seed {seed}: {_kind(sch)}, init cond frames "
            f"{list(sch.init_cond_frames)}, corrected frames {list(sch.frames_to_correct)} "
            f"x {sch.num_correction_pt} clicks | "
            + " ".join(f"{k} {v:.6g}" for k, v in vals.items())
            + f" | ms/step {ms:.1f} peak_mem "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB | launches {got} "
            f"(expected {want}) {'OK' if good else 'FAIL'}")
    torch.cuda.synchronize()
    launches = dict(att.LAUNCHES)
    profile_train_step(step, images, gt, gen, schedules[0][1])
    del opt, step, model
    torch.cuda.empty_cache()
    return ok, launches, (cfg, recipe, images, gt)


def profile_train_step(step, images, gt, gen, sch):
    """One more train step (after the counts were read) under
    torch.profiler: device time by kernel and the device's idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(images, gt, gen, schedule=sch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"[train-profile] one {_kind(sch)} step under torch.profiler: wall {wall_ms:.1f} ms, "
        f"device busy {busy:.1f} ms, idle share {max(0.0, 1 - busy / wall_ms):.3f}, "
        f"{sum(r[1] for r in rows)} device operations under {len(rows)} names")
    for ms, n, key in rows[:15]:
        log(f"[train-profile]   {ms:9.2f} ms {100 * ms / busy:5.1f}%  x{n}  {key[:90]}")


@contextlib.contextmanager
def _tf32():
    """TF32 for every fp32 matmul and convolution inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _grads_of(model, cfg, loss_fn, images, gt, sch, seed):
    """One step's loss terms and gradients (no update) with the generator
    seeded `seed`."""
    from det_sam2_tpu_torch.training.sam2_train import forward_training

    model.zero_grad(set_to_none=True)
    g = torch.Generator(device=images.device).manual_seed(seed)
    outs = forward_training(model, dataclasses.replace(cfg, remat_image_encoder=True),
                            images, gt, generator=g, schedule=sch)
    t, s = gt.shape[0], gt.shape[-1]
    losses = loss_fn(outs, gt.reshape(t, -1, s, s))
    losses["core_loss"].backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return {k: float(v.detach()) for k, v in losses.items()}, grads


def _watched(name: str, cfg) -> bool:
    """Hiera global blocks' attention, memory-attention projections."""
    glob = [f"image_encoder.trunk.blocks.{i}.attn." for i in cfg.hiera.global_att_blocks]
    return any(name.startswith(p) for p in glob) or (
        name.startswith("memory_attention.layers.") and "_proj." in name)


def _grad_distance(ref, got, cfg):
    rel = {n: float((got[n] - g).norm() / g.norm().clamp_min(1e-30))
           for n, g in ref.items() if n in got}
    missing = sorted(set(ref) ^ set(got))
    watched = {n: r for n, r in rel.items() if _watched(n, cfg)}
    return rel, watched, missing


def phase_train_checks(dev, state):
    """One step's gradients with the kernels vs the plain forward and
    backward on the card (same parameters, data, drop-path masks and box
    noise), gated by the spread of two plain runs that differ only in
    rounding; two sessions with a fault planted in K3's wrappers must fail
    the gate."""
    from det_sam2_tpu_torch.ops import attention as att
    from det_sam2_tpu_torch.training.sam2_train import PromptSchedule

    cfg, recipe, images, gt = state
    sch = PromptSchedule(init_cond_frames=(0,), frames_to_correct=(), use_pt_input=True,
                         use_box_per_frame=(True,), num_correction_pt=0)
    loss_fn = recipe.loss
    plain_model = make_trainer(cfg, functools.partial(att.flash_attention, plain=True), dev)
    plain_l, plain_g = _grads_of(plain_model, cfg, loss_fn, images, gt, sch, 1)
    with _tf32():
        tf32_l, tf32_g = _grads_of(plain_model, cfg, loss_fn, images, gt, sch, 1)
    del plain_model
    torch.cuda.empty_cache()
    _, spread_w, _ = _grad_distance(plain_g, tf32_g, cfg)
    del tf32_g
    spread = max(spread_w.values())
    gate = min(max(GRAD_SPREAD_X * spread, GRAD_GATE_FLOOR), GRAD_GATE_CAP)
    log(f"[train-checks] box schedule, no clicks: plain fp32 vs plain TF32 (rounding "
        f"only): watched gradients relative L2 max {spread:.4g}, loss "
        f"{plain_l['core_loss']:.6g} vs {tf32_l['core_loss']:.6g}; gate "
        f"{gate:.4g} = min(max({GRAD_SPREAD_X} x spread, {GRAD_GATE_FLOOR}), "
        f"{GRAD_GATE_CAP})")

    model = make_trainer(cfg, att.flash_attention, dev)

    def run(label, must_pass: bool) -> bool:
        losses, grads = _grads_of(model, cfg, loss_fn, images, gt, sch, 1)
        rel, watched, missing = _grad_distance(plain_g, grads, cfg)
        loss_rel = max(abs(losses[k] - plain_l[k]) / max(abs(plain_l[k]), 1e-30)
                       for k in plain_l)
        worst_w = max(watched, key=watched.get)
        worst = max(rel, key=rel.get)
        good = not missing and watched[worst_w] <= gate and loss_rel <= gate
        log(f"[train-checks] {label}: loss terms max relative difference "
            f"{loss_rel:.4g}; watched gradients ({len(watched)} tensors) relative L2 max "
            f"{watched[worst_w]:.4g} ({worst_w}); qkv of the global blocks "
            + ", ".join(f"{watched[n]:.3g}" for n in sorted(watched) if "qkv.weight" in n)
            + "; memory q/k/v_proj weights max "
            + f"{max(r for n, r in watched.items() if 'memory' in n and 'out_proj' not in n and n.endswith('weight')):.3g}"
            + f"; all {len(rel)} gradients max {rel[worst]:.4g} ({worst})"
            + (f"; missing {missing}" if missing else "")
            + f" -> {'within' if good else 'outside'} the gate "
            f"{'OK' if good == must_pass else 'FAIL'}")
        return good == must_pass

    ok = run("kernels vs plain", True)
    for fault, name, idx in (("K3b's dk zeroed", "flash_bwd_dkv", 0),
                             ("K3a's dq zeroed", "flash_bwd_dq", None)):
        orig = getattr(att, name)

        def planted(*a, _orig=orig, _idx=idx, **kw):
            out = _orig(*a, **kw)
            if _idx is None:
                return torch.zeros_like(out)
            return tuple(torch.zeros_like(x) if j == _idx else x for j, x in enumerate(out))

        setattr(att, name, planted)
        try:
            caught = run(f"planted '{fault}' (must fail)", False)
        finally:
            setattr(att, name, orig)
        log(f"[train-checks] planted fault '{fault}': {'caught' if caught else 'MISSED'}")
        ok &= caught
    del model
    torch.cuda.empty_cache()
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


def _demangle(names):
    """C++ names of mangled symbols, through the CUDA toolkit's cu++filt (or
    c++filt); the mangled names where neither is there."""
    from det_sam2_tpu_torch.ops.attention import _nvcc

    for tool in (str(Path(_nvcc()).with_name("cu++filt")), "c++filt"):
        if shutil.which(tool):
            out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                                 text=True, timeout=60).stdout.splitlines()
            if len(out) == len(names):
                return out
    return list(names)


def ptxas_report(text: str):
    """ptxas -v's lines of one library, one a kernel instance: the instance
    by name and template arguments (`flash_bwd_dkv_kernel<float, 256, 64,
    32>`), its registers and its stack / spill bytes."""
    rows, name, spill = [], "?", ""
    for line in text.splitlines():
        if "Function properties for" in line:
            name, spill = line.split("Function properties for", 1)[1].strip(), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            rows.append((name, line.split("Used", 1)[1].strip(), spill))
    names = _demangle([r[0] for r in rows])
    out = []
    for full, (_, regs, spill) in zip(names, rows):
        short = re.search(r"(\w+<[^()]*>)\(", full.replace("(int)", ""))
        out.append(f"{short.group(1) if short else full}: {regs}; {spill}")
    return out


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
            for line in ptxas_report(rep.read_text()):
                log(f"[build] {name}: {line}")

    results = []
    t_phase = time.time()
    ok = phase_kernels(dev, results)
    log(f"[time] phase 1 (kernels) {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    ok_main, serving, state = phase_main(dev)
    ok &= ok_main
    log(f"[time] phase 2 (serving path) {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    ok &= phase_checks(state)
    del state
    torch.cuda.empty_cache()
    log(f"[time] phase 3 (serving checks) {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    ok_train, training, train_state = phase_train(dev)
    ok &= ok_train
    log(f"[time] phase 4 (training path) {time.time() - t_phase:.1f} s")
    t_phase = time.time()
    ok &= phase_train_checks(dev, train_state)
    log(f"[time] phase 4 checks {time.time() - t_phase:.1f} s")
    counts = {"serving": serving, "training": training}
    for r in results:
        r["launches"] = counts[r.pop("path")][r.pop("kernel")]
    serving_kernels = ("flash_fwd", "flash_banked_keys", "flash_banked_fwd")
    for path, names in (("serving", serving_kernels),
                        ("training", ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))):
        for name in names:
            if counts[path][name] <= 0:
                log(f"[main] kernel {name} was not launched by the {path} path")
                ok = False
    if set(att.LAUNCHES) != {n for r in results for n in att.LAUNCHES
                             if r["name"].startswith(n + ":")}:
        log("[main] the kernel table does not cover every kernel")
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
