"""Flash attention for the H100: forward, backward and banked kernels.

Counterpart of the JAX package's ``ops/attention.py``, whose Pallas TPU
kernels become hand-written CUDA C++ for Hopper (sm_90a):

  K1  ``flash_attention_fwd``        csrc/flash_fwd.cu
      replaces ``_flash_kernel`` / ``_flash_kernel_nobias`` (``_flash_call``)
  K2  ``flash_attention_banked_fwd`` csrc/flash_banked_keys.cu (pre-pass)
                                     + csrc/flash_banked_fwd.cu
      replaces ``_flash_banked_kernel`` (``_flash_banked_call``)
  K3a ``flash_bwd_dq``               csrc/flash_bwd_dq.cu
      replaces ``_flash_bwd_dq_kernel`` / ``_nobias`` (``_flash_bwd_call``)
  K3b ``flash_bwd_dkv``              csrc/flash_bwd_dkv.cu
      replaces ``_flash_bwd_dkv_kernel`` / ``_nobias`` (``_flash_bwd_call``)

K1 with K3a/K3b as its backward is the autograd Function ``FlashAttention``
(the counterpart of ``_flash_core`` and its custom VJP); K2 is inference
only and refuses a gradient, as in JAX.

Beside each kernel is its plain PyTorch version (``*_ref``) with the same
signature. A wrapper given CPU tensors computes the plain version; given
CUDA tensors it launches the kernel or raises. Each launch adds one to
``LAUNCHES[name]``.

The kernels are compiled at first use by ``nvcc`` into ``build/kernels/`` at
the repository root (git-ignored), one shared library per source with a
plain C interface, named by a hash of the sources and flags, and loaded with
ctypes. ``build_kernels()`` compiles every source at once, in parallel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from det_sam2_tpu_torch.modeling.layers import sdpa, sdpa_lse

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_banked_keys": 0,
                             "flash_banked_fwd": 0, "flash_bwd_dq": 0,
                             "flash_bwd_dkv": 0}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_HEADERS = ("flash_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # q, k, v, bias, out, lse, bh, nq, nk, d, dv, dtype, scale, fault, stream
    "flash_fwd": [_P] * 6 + [_I] * 6 + [_F, _I, _P],
    # mem_k, slots, w, cos, sin, keys,
    # nb, d, ktot, nl, s, s_pad, ntile, layer, dtype, stream
    "flash_banked_keys": [_P] * 6 + [_I] * 9 + [_P],
    # q, keys, mem_v, slots, bias, out,
    # nb, nq, d, cm, ktot, s, s_pad, ntile, dtype, scale, stream
    "flash_banked_fwd": [_P] * 6 + [_I] * 9 + [_F, _P],
    # q, k, v, bias, dout, lse, delta, dq, bh, nq, nk, d, dv, dtype, scale,
    # fault, stream
    "flash_bwd_dq": [_P] * 8 + [_I] * 6 + [_F, _I, _P],
    # ... dk, dv in place of dq
    "flash_bwd_dkv": [_P] * 9 + [_I] * 6 + [_F, _I, _P],
}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# build + load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    home = CUDA_HOME or os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Where the shared library of kernel `name` is built: keyed by a hash
    of its source, the shared header and the nvcc flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (f"{name}.cu",) + _HEADERS:
        h.update((_CSRC / f).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_kernels(names=tuple(LAUNCHES)) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, one nvcc process per
    source, all started together. The compiler's report (registers, shared
    memory, spills from -Xptxas=-v) is kept beside each library as .log.
    Raises with the compiler's output if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def _lib(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = build_kernels((name,))[name]
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def _dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.bfloat16:
        return 1
    if t.dtype == torch.float32:
        return 0
    raise TypeError(f"flash kernels take bf16 or fp32, got {t.dtype}")


def _ready(t: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    """Contiguous, 16-byte aligned, on `device` with `dtype`, or raise."""
    if t.device != device:
        raise ValueError(f"tensor on {t.device}, kernel runs on {device}")
    if t.dtype != dtype:
        raise TypeError(f"expected {dtype}, got {t.dtype}")
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t


# the C entries' own error codes beside CUDA's (csrc/flash_common.cuh kErr*)
_ERRORS = {20000: "no driver entry point for cuTensorMapEncodeTiled",
           20001: "the tiles of this shape do not fit in shared memory"}


def _launch(name: str, *args) -> None:
    err = getattr(_lib(name), name)(*args)
    if err != 0:
        what = _ERRORS.get(err, f"CUDA error {err}")
        if 10000 <= err < 20000:
            what = f"tensor map not encoded: CUresult {err - 10000}"
        raise RuntimeError(f"{name} launch failed: {what}")
    LAUNCHES[name] += 1


def _check_dims(d: int, dv: int) -> None:
    if d % 8 or dv % 8 or not (0 < d <= 256) or not (0 < dv <= 256):
        raise ValueError(
            f"flash kernels take D, Dv <= 256, multiples of 8; got {d}, {dv}"
        )


# ---------------------------------------------------------------------------
# K1: flash forward. Replaces det_sam2_tpu/ops/attention.py:_flash_kernel and
# _flash_kernel_nobias. Bound on the H100 by operations at the main path's
# shapes (2 * Nq * Nk * (D + Dv) FLOPs on a few MB); the kernel keeps scores,
# P and the output accumulator on chip, one pass over the live K/V tiles per
# 64 query rows: in bf16 a TMA ring feeding wgmma, in fp32 exact FMAs over a
# cp.async double buffer (csrc/flash_fwd.cu, flash_common.cuh say more).
# ---------------------------------------------------------------------------

# planted faults of the forward kernels (csrc/flash_common.cuh FwdFault), for
# the checks that must catch them; production calls pass 0
FWD_FAULTS = {"consumer reads the wrong ring stage": 1}


def flash_attention_ref(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1. q [BH, Nq, D], k [BH, Nk, D], v [BH, Nk, Dv],
    bias [BH, Nk] fp32 additive or None -> (out [BH, Nq, Dv], lse [BH, Nq]
    fp32). Rows with no live key are zeros (``sdpa``)."""
    return sdpa_lse(q, k, v, None if bias is None else bias.float()[:, None, :])


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor] = None, fault: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on [BH, N, D] operands (the shapes of the TPU ``_flash_call``):
    (out [BH, Nq, Dv] in q's type, lse [BH, Nq] fp32). CPU tensors take
    ``flash_attention_ref``; CUDA tensors launch csrc/flash_fwd.cu (fault: a
    planted fault of ``FWD_FAULTS``, for the checks only)."""
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, bias)
    bh, nq, d = q.shape
    nk, dv = k.shape[1], v.shape[-1]
    if k.shape != (bh, nk, d) or v.shape != (bh, nk, dv):
        raise ValueError(f"shapes q {q.shape} k {k.shape} v {v.shape}")
    _check_dims(d, dv)
    code = _dtype_code(q)
    q, k, v = (_ready(t, q.dtype, q.device) for t in (q, k, v))
    if bias is not None:
        if bias.shape != (bh, nk):
            raise ValueError(f"bias {tuple(bias.shape)} != {(bh, nk)}")
        bias = _ready(bias, torch.float32, q.device)
    out = torch.empty((bh, nq, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((bh, nq), dtype=torch.float32, device=q.device)
    _launch(
        "flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        lse.data_ptr(), bh, nq, nk, d, dv, code, 1.0 / d ** 0.5, fault,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out, lse


# ---------------------------------------------------------------------------
# K3a / K3b: flash backward. Replace det_sam2_tpu/ops/attention.py:
# _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel (with their _nobias forms).
# Bound by operations (2 * Nq * Nk * (2D + Dv) and 2 * Nq * Nk * (2D + 2Dv)
# FLOPs over the live keys), taken on the tensor cores as 3xTF32 (three TF32
# passes a product: 3 x FLOPs / 495 TFLOP/s); the kernels recompute P from
# the saved lse one key tile (K3a) or query tile (K3b) at a time, so neither
# the scores nor P ever reach device memory, and keep dq (dk, dv) in
# registers (csrc/flash_bwd_dq.cu, flash_bwd_dkv.cu, flash_common.cuh).
# ---------------------------------------------------------------------------

# planted faults of the backward kernels (csrc/flash_common.cuh BwdFault),
# for the checks that must catch them; production calls pass 0
BWD_FAULTS = {"dq without the delta term": 1, "a live key tile skipped": 2,
              "P not zeroed where lse <= -1e29": 3, "dv from the wrong tile": 4,
              "one TF32 pass": 5}


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 3xTF32 split of the backward kernels' fp32 operands, in plain
    PyTorch: hi = x rounded to TF32 (10 mantissa bits; to nearest, ties away
    from zero, by integer operations on the fp32 bits, as
    csrc/flash_common.cuh:tf32_rna does), lo = (x - hi) rounded the same
    way. x - hi is exact in fp32, so hi + lo = x to about 2^-22 relative
    while x - hi stays a normal number. Returns (hi, lo), fp32; non-finite
    x gives (x, 0)."""
    def rna(v):
        bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        r = (bits + 0x1000) & 0xFFFFE000
        r = torch.where(r >= 1 << 31, r - (1 << 32), r)  # back to int32's range
        return r.to(torch.int32).view(torch.float32)

    x = x.float()
    finite = torch.isfinite(x)
    hi = torch.where(finite, rna(torch.where(finite, x, 0.0)), x)
    lo = torch.where(finite, rna(x - torch.where(finite, hi, 0.0)), 0.0)
    return hi, lo


def flash_attention_bwd_ref(q, k, v, bias, out, lse, dout):
    """Plain version of K3a + K3b with the TPU kernels' arithmetic: P is
    recomputed from the saved lse, and is 0 where lse <= -1e29 (``_safe_p``);
    dS = P * (dO v^T - delta) with delta = rowsum(dO * O) and dO in fp32;
    dS is rounded to k's type before dq = dS k / sqrt(D) and to q's type
    before dk = dS^T q / sqrt(D); dv = P^T dO on fp32 P and dO. Shapes of
    ``flash_attention_ref``; dout [BH, Nq, Dv] -> (dq, dk, dv) in the types
    of q, k, v. Computed in slices of the BH axis so that the [Nq, Nk]
    intermediates stay near 512 MB."""
    return _bwd_ref(q, k, v, bias, lse, dout, (dout.float() * out.float()).sum(-1))


def _bwd_ref(q, k, v, bias, lse, dout, delta, mm=torch.matmul):
    """``flash_attention_bwd_ref`` given delta [BH, Nq] in place of out. mm
    takes every matrix product (the tests pass emulations of the kernels'
    TF32 products)."""
    bh, nq, d = q.shape
    nk = k.shape[1]
    scale = 1.0 / d ** 0.5
    step = max(1, (1 << 27) // max(1, nq * nk))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for i in range(0, bh, step):
        sl = slice(i, i + step)
        g = dout[sl].float()
        s = mm(q[sl].float(), k[sl].float().transpose(-1, -2)) * scale
        if bias is not None:
            s = s + bias[sl].float()[:, None, :]
        l = lse[sl].float()[..., None]
        p = torch.where(l > -1e29, torch.exp(s - l), torch.zeros_like(s))
        ds = p * (mm(g, v[sl].float().transpose(-1, -2))
                  - delta[sl].float()[..., None])
        dq[sl] = (mm(ds.to(k.dtype).float(), k[sl].float()) * scale).to(q.dtype)
        dk[sl] = (mm(ds.to(q.dtype).float().transpose(-1, -2), q[sl].float())
                  * scale).to(k.dtype)
        dv[sl] = mm(p.transpose(-1, -2), g).to(v.dtype)
    return dq, dk, dv


def _bwd_args(q, k, v, bias, dout, lse, delta):
    """Checked kernel operands of K3a / K3b on CUDA tensors."""
    bh, nq, d = q.shape
    nk, dv = k.shape[1], v.shape[-1]
    if k.shape != (bh, nk, d) or v.shape != (bh, nk, dv) or dout.shape != (bh, nq, dv):
        raise ValueError(f"shapes q {q.shape} k {k.shape} v {v.shape} dout {dout.shape}")
    if lse.shape != (bh, nq) or delta.shape != (bh, nq):
        raise ValueError(f"lse {tuple(lse.shape)} delta {tuple(delta.shape)} != {(bh, nq)}")
    _check_dims(d, dv)
    dev = q.device
    q, k, v = (_ready(t, q.dtype, dev) for t in (q, k, v))
    dout, lse, delta = (_ready(t.float(), torch.float32, dev) for t in (dout, lse, delta))
    if bias is not None:
        if bias.shape != (bh, nk):
            raise ValueError(f"bias {tuple(bias.shape)} != {(bh, nk)}")
        bias = _ready(bias.float(), torch.float32, dev)
    ptrs = [t.data_ptr() for t in (q, k, v)] + [
        None if bias is None else bias.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr()]
    return ptrs, (bh, nq, nk, d, dv, _dtype_code(q), 1.0 / d ** 0.5), (q, k, v, dout)


def flash_bwd_dq(q, k, v, bias, dout, lse, delta, fault: int = 0) -> torch.Tensor:
    """K3a on CUDA tensors: dq [BH, Nq, D] in q's type, from the shapes of
    ``flash_attention_ref`` plus dout [BH, Nq, Dv] and lse, delta [BH, Nq]
    fp32 (delta = rowsum(dO * O)). CPU tensors take the plain version;
    CUDA tensors launch csrc/flash_bwd_dq.cu (fault: a planted fault of
    ``BWD_FAULTS``, for the checks only)."""
    if not q.is_cuda:
        return _bwd_ref(q, k, v, bias, lse, dout, delta)[0]
    ptrs, dims, keep = _bwd_args(q, k, v, bias, dout, lse, delta)
    dq = torch.empty_like(keep[0])
    _launch("flash_bwd_dq", *ptrs, dq.data_ptr(), *dims, fault,
            torch.cuda.current_stream(q.device).cuda_stream)
    return dq


def flash_bwd_dkv(q, k, v, bias, dout, lse, delta,
                  fault: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3b on CUDA tensors, the arguments of ``flash_bwd_dq``: (dk
    [BH, Nk, D], dv [BH, Nk, Dv]) in k's and v's type. CPU tensors take
    the plain version; CUDA tensors launch csrc/flash_bwd_dkv.cu."""
    if not q.is_cuda:
        return _bwd_ref(q, k, v, bias, lse, dout, delta)[1:]
    ptrs, dims, keep = _bwd_args(q, k, v, bias, dout, lse, delta)
    dk, dv = torch.empty_like(keep[1]), torch.empty_like(keep[2])
    _launch("flash_bwd_dkv", *ptrs, dk.data_ptr(), dv.data_ptr(), *dims, fault,
            torch.cuda.current_stream(q.device).cuda_stream)
    return dk, dv


def flash_attention_bwd(q, k, v, bias, out, lse, dout):
    """The backward of K1: (dq, dk, dv). CPU tensors take
    ``flash_attention_bwd_ref``; CUDA tensors compute delta = rowsum(dO * O)
    in fp32 with torch (the JAX package does it in XLA outside its kernels,
    attention.py:325), then launch K3a and K3b."""
    if not q.is_cuda:
        return flash_attention_bwd_ref(q, k, v, bias, out, lse, dout)
    delta = (dout.float() * out.float()).sum(-1)
    dq = flash_bwd_dq(q, k, v, bias, dout, lse, delta)
    dk, dv = flash_bwd_dkv(q, k, v, bias, dout, lse, delta)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K1 with K3a/K3b as its backward: the counterpart of the JAX package's
    ``_flash_core`` and its custom VJP. apply(q, k, v, bias, plain) on
    [BH, N, D] operands (bias [BH, Nk] fp32 or None) -> out [BH, Nq, Dv].

    CPU tensors, or plain=True on any device, compute the plain forward
    (``flash_attention_ref``) and the plain backward
    (``flash_attention_bwd_ref``), so every device takes this same autograd
    route. The bias gets NO gradient, as in JAX (attention.py:431-437):
    every bias that reaches the kernel is a constant validity mask
    (0 / -1e30 from memory attention), never a learned tensor; a learned
    bias would need the backward kernels extended first."""

    @staticmethod
    def forward(ctx, q, k, v, bias, plain: bool):
        if plain:
            out, lse = flash_attention_ref(q, k, v, bias)
        else:
            out, lse = flash_attention_fwd(q, k, v, bias)
        ctx.plain = plain
        ctx.save_for_backward(q, k, v, bias, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        if ctx.plain:
            dq, dk, dv = flash_attention_bwd_ref(q, k, v, bias, out, lse, dout)
        else:
            dq, dk, dv = flash_attention_bwd(q, k, v, bias, out, lse, dout)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    min_flops: int = 1 << 22,
    plain: bool = False,
) -> torch.Tensor:
    """Drop-in for ``layers.sdpa`` on q [B, H, Nq, D], k [B, H, Nk, D],
    v [B, H, Nk, Dv], bias None or [B, 1, 1, Nk].

    The JAX dispatch rule is a rule of this function on every device, not a
    fallback: a problem with Nq * Nk < min_flops, or a bias of any other
    form, goes to the plain ``sdpa``; everything else goes through
    ``FlashAttention`` (K1 forward, K3a/K3b backward; on CPU tensors, or
    with plain=True, their plain versions). The bias gets no gradient on
    that route, as in JAX: it must be a constant mask."""
    b, h, nq, d = q.shape
    nk, dv = k.shape[2], v.shape[-1]
    bias_ok = bias is None or (
        bias.ndim == 4 and bias.shape[1] == 1 and bias.shape[2] == 1
    )
    if nq * nk < min_flops or not bias_ok:
        return sdpa(q, k, v, bias)
    bf = None
    if bias is not None:
        bf = bias[:, 0, 0, :].float()[:, None, :].expand(b, h, nk)
        bf = bf.reshape(b * h, nk)
    out = FlashAttention.apply(q.reshape(b * h, nq, d), k.reshape(b * h, nk, d),
                               v.reshape(b * h, nk, dv), bf, plain)
    return out.reshape(b, h, nq, dv)


# ---------------------------------------------------------------------------
# K2: bank-indirect memory cross-attention forward. Replaces
# det_sam2_tpu/ops/attention.py:_flash_banked_kernel. Bound by operations as
# K1. A pre-pass builds the corrected keys of the attended tiles once a launch
# (csrc/flash_banked_keys.cu: bytes, ~34 MB each way at the serving shape);
# the main kernel runs K1's body over them and reads V straight from the bank
# rows named by the slot list (csrc/flash_banked_fwd.cu says more).
# ---------------------------------------------------------------------------

K2_TILE = 64  # keys a tile of K2's main kernel: each bank tile is padded to it


def _slot_rows(slots: torch.Tensor, ktot: int):
    """(valid [T] bool: slot in [0, Ktot), the slots with invalid ones set to
    row 0) of a slot list."""
    sl = slots.long()
    valid = (sl >= 0) & (sl < ktot)
    return valid, torch.where(valid, sl, torch.zeros_like(sl))


def banked_keys(mem_k, slots, w, cos, sin, layer: int, dtype,
                s_pad: Optional[int] = None) -> torch.Tensor:
    """The keys K2 attends to, [B, T*S_pad, D]: rows j < S of tile t are
    mem_k[slots[t], :, layer, j] plus the per-tile RoPE correction
    [w1*cos - w2*sin, w1*sin + w2*cos] (halves layout), added in fp32 and
    rounded to `dtype`; rows S..S_pad, and every row of a tile whose slot is
    outside [0, Ktot), are zeros. S_pad defaults to S. The plain version of
    K2's pre-pass (``flash_banked_keys``)."""
    ktot, _, _, s, d = mem_k.shape
    s_pad = s if s_pad is None else s_pad
    valid, rows = _slot_rows(slots, ktot)
    half = d // 2
    w1 = w[:, None, :half].float()
    w2 = w[:, None, half:].float()
    corr = torch.cat([cos * w1 - sin * w2, sin * w1 + cos * w2], -1)  # [T,S,D]
    k = mem_k.index_select(0, rows)[:, :, layer]  # [T, B, S, D]
    k = (k.float() + corr[:, None]).to(dtype)
    t, b = k.shape[:2]
    out = k.new_zeros((t, b, s_pad, d))
    out[:, :, :s] = k.masked_fill(~valid[:, None, None, None], 0)
    return out.permute(1, 0, 2, 3).reshape(b, t * s_pad, d)


def flash_banked_keys(mem_k, slots, w, cos, sin, layer: int,
                      s_pad: Optional[int] = None) -> torch.Tensor:
    """K2's pre-pass: ``banked_keys`` in mem_k's type, [B, T*S_pad, D].
    CPU tensors take the plain version; CUDA tensors launch
    csrc/flash_banked_keys.cu."""
    ktot, b, nl, s, d = mem_k.shape
    s_pad = s if s_pad is None else s_pad
    if not mem_k.is_cuda:
        return banked_keys(mem_k, slots, w, cos, sin, layer, mem_k.dtype, s_pad)
    t = slots.shape[0]
    if w.shape != (t, d) or cos.shape != (s, d // 2) or sin.shape != (s, d // 2):
        raise ValueError(f"w {tuple(w.shape)} rope tables {tuple(cos.shape)} "
                         f"{tuple(sin.shape)}")
    if not 0 <= layer < nl:
        raise ValueError(f"layer {layer} not in [0, {nl})")
    if d % 16 or s_pad < s:
        raise ValueError(f"K2 takes D a multiple of 16 and S_pad >= S, got {d}, {s_pad}")
    code = _dtype_code(mem_k)
    dev = mem_k.device
    mem_k = _ready(mem_k, mem_k.dtype, dev)
    slots = _ready(slots.to(torch.int32), torch.int32, dev)
    w, cos, sin = (_ready(x.float(), torch.float32, dev) for x in (w, cos, sin))
    keys = torch.empty((b, t * s_pad, d), dtype=mem_k.dtype, device=dev)
    _launch(
        "flash_banked_keys", mem_k.data_ptr(), slots.data_ptr(), w.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), keys.data_ptr(), b, d, ktot, nl, s, s_pad,
        t, layer, code, torch.cuda.current_stream(dev).cuda_stream,
    )
    return keys


def flash_banked_attend_ref(q, keys, mem_v, slots, bias) -> torch.Tensor:
    """Plain version of K2's main kernel: attention of q [B, Nq, D] over
    the keys [B, T*S_pad, D] of ``banked_keys`` and the values
    mem_v[slots[t], b] [Ktot, B, S, Cm] of each tile, with bias [B, T*S]
    fp32; keys S..S_pad of a tile and every key of a slot outside [0, Ktot)
    are dead -> [B, Nq, Cm]."""
    b = q.shape[0]
    ktot, _, s, cm = mem_v.shape
    t = slots.shape[0]
    s_pad = keys.shape[1] // t
    valid, rows = _slot_rows(slots, ktot)
    v = mem_v.new_zeros((t, b, s_pad, cm))
    v[:, :, :s] = mem_v.index_select(0, rows)
    v = v.permute(1, 0, 2, 3).reshape(b, t * s_pad, cm)
    full = torch.full((b, t, s_pad), -1e30, dtype=torch.float32, device=q.device)
    full[:, :, :s] = bias.float().reshape(b, t, s)
    full = full.masked_fill(~valid[None, :, None], -1e30)
    return sdpa(q, keys, v, full.reshape(b, 1, t * s_pad))


def flash_banked_attend(q, keys, mem_v, slots, bias) -> torch.Tensor:
    """K2's main kernel on the pre-pass's keys, with the shapes of
    ``flash_banked_attend_ref`` (S_pad a multiple of ``K2_TILE``). CPU
    tensors take the plain version; CUDA tensors launch
    csrc/flash_banked_fwd.cu."""
    if not q.is_cuda:
        return flash_banked_attend_ref(q, keys, mem_v, slots, bias)
    b, nq, d = q.shape
    ktot, _, s, cm = mem_v.shape
    t = slots.shape[0]
    s_pad = keys.shape[1] // t
    if (mem_v.shape[1] != b or keys.shape != (b, t * s_pad, d) or s_pad % K2_TILE
            or s_pad < s or bias.shape != (b, t * s)):
        raise ValueError(f"q {tuple(q.shape)} keys {tuple(keys.shape)} mem_v "
                         f"{tuple(mem_v.shape)} bias {tuple(bias.shape)}")
    _check_dims(d, cm)
    code = _dtype_code(q)
    dev = q.device
    q, keys, mem_v = (_ready(x, q.dtype, dev) for x in (q, keys, mem_v))
    slots = _ready(slots.to(torch.int32), torch.int32, dev)
    bias = _ready(bias.float(), torch.float32, dev)
    out = torch.empty((b, nq, cm), dtype=q.dtype, device=dev)
    _launch(
        "flash_banked_fwd", q.data_ptr(), keys.data_ptr(), mem_v.data_ptr(),
        slots.data_ptr(), bias.data_ptr(), out.data_ptr(), b, nq, d, cm, ktot,
        s, s_pad, t, code, 1.0 / d ** 0.5,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return out


def flash_attention_banked_ref(q, mem_k, mem_v, slots, w, bias, cos, sin,
                               layer: int) -> torch.Tensor:
    """Plain version of K2: gather the slot rows, add the correction, then
    plain attention. q [B, Nq, D]; mem_k [Ktot, B, L, S, D];
    mem_v [Ktot, B, S, Cm]; slots [T] int32; w [T, D] fp32; bias [B, T*S]
    fp32; cos/sin [S, D/2] fp32 -> [B, Nq, Cm]. The keys of a slot outside
    [0, Ktot) are dead."""
    keys = banked_keys(mem_k, slots, w, cos, sin, layer, q.dtype)
    return flash_banked_attend_ref(q, keys, mem_v, slots, bias)


def flash_attention_banked_fwd(q, mem_k, mem_v, slots, w, bias, cos, sin,
                               layer: int) -> torch.Tensor:
    """K2 with the shapes of ``flash_attention_banked_ref``. CPU tensors
    take the plain version; CUDA tensors launch the pre-pass
    (``flash_banked_keys``, each bank tile padded to ``K2_TILE`` keys) and
    the main kernel over its keys (``flash_banked_attend``). A slot outside
    [0, Ktot) is a dead tile."""
    if not q.is_cuda:
        return flash_attention_banked_ref(q, mem_k, mem_v, slots, w, bias,
                                          cos, sin, layer)
    if mem_k.dtype != q.dtype or mem_k.shape[1] != q.shape[0] or mem_k.shape[-1] != q.shape[-1]:
        raise ValueError(f"q {q.dtype} {tuple(q.shape)} mem_k {mem_k.dtype} "
                         f"{tuple(mem_k.shape)}")
    s = mem_k.shape[3]
    keys = flash_banked_keys(mem_k, slots, w, cos, sin, layer,
                             -(-s // K2_TILE) * K2_TILE)
    return flash_banked_attend(q, keys, mem_v, slots, bias)


class _BankedInferenceOnly(torch.autograd.Function):
    """Identity gate on K2's output whose backward raises: the counterpart
    of the JAX package's ``_banked_inference_only``. K2 reads K/V from
    bank-resident caches and has no backward kernel, so a training path
    handed a banked bank fails here with a message instead of training with
    a silently dropped gradient. apply(out, *inputs): the differentiable
    inputs make the output require a gradient on every device (the kernel's
    own output has no autograd history)."""

    @staticmethod
    def forward(ctx, out, *inputs):
        return out.clone()

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "flash_attention_banked is inference-only (no VJP): banked-mode "
            "memory cross-attention reads K/V from bank-resident caches. For "
            "training/finetuning, assemble memory densely — build the bank "
            "with banked_layers=0 (init_bank default) so MemoryAttention takes "
            "the differentiable gather path (see make_train_step)."
        )


def flash_attention_banked(q, mem_k, mem_v, slots, w, bias, cos, sin,
                           layer: int, plain: bool = False) -> torch.Tensor:
    """Bank-indirect memory cross-attention with the JAX signature:
    q [B, 1, Nq, D] (single head) -> [B, 1, Nq, Cm] raw-value output (the
    caller applies v_proj / out_proj). plain=True computes K2's plain
    version on any device.

    Inference only, on every device: differentiating the output raises
    NotImplementedError, as in JAX. Training assembles memory densely (the
    gather path, K1 with a bias)."""
    if q.shape[1] != 1:
        raise ValueError("banked attention is single-head")
    fn = flash_attention_banked_ref if plain else flash_attention_banked_fwd
    out = fn(q[:, 0], mem_k, mem_v, slots, w, bias, cos, sin, layer)
    diff = [t for t in (q, mem_k, mem_v, w) if t.requires_grad]
    if torch.is_grad_enabled() and diff:
        out = _BankedInferenceOnly.apply(out, *diff)
    return out[:, None]


def plain_attention_fns():
    """(attention_fn, banked_attention_fn) computing every kernel's plain
    version on any device, for the reference run of a session: the same
    dispatch rule and autograd route as the kernels (K1's plain version
    under the rule, forward and backward; K2's, inference only)."""
    return (functools.partial(flash_attention, plain=True),
            functools.partial(flash_attention_banked, plain=True))
