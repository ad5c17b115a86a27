"""Flash attention for the H100: forward, backward and banked kernels.

Counterpart of the JAX package's ``ops/attention.py``, whose Pallas TPU
kernels become hand-written CUDA C++ for Hopper (sm_90a):

  K1  ``flash_attention_fwd``        csrc/flash_fwd.cu
      replaces ``_flash_kernel`` / ``_flash_kernel_nobias`` (``_flash_call``)
  K2  ``flash_attention_banked_fwd`` csrc/flash_banked_fwd.cu
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

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_banked_fwd": 0,
                             "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_HEADERS = ("flash_common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # q, k, v, bias, out, lse, bh, nq, nk, d, dv, dtype, scale, stream
    "flash_fwd": [_P] * 6 + [_I] * 6 + [_F, _P],
    # q, mem_k, mem_v, slots, w, bias, cos, sin, out,
    # nb, nq, d, cm, ktot, nl, s, ntile, layer, dtype, scale, stream
    "flash_banked_fwd": [_P] * 9 + [_I] * 10 + [_F, _P],
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


def _launch(name: str, *args) -> None:
    err = getattr(_lib(name), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
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
# P and the output accumulator on chip, one pass over K/V per 64 query rows,
# on the tensor cores in bf16 (csrc/flash_fwd.cu says more).
# ---------------------------------------------------------------------------


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
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on [BH, N, D] operands (the shapes of the TPU ``_flash_call``):
    (out [BH, Nq, Dv] in q's type, lse [BH, Nq] fp32). CPU tensors take
    ``flash_attention_ref``; CUDA tensors launch csrc/flash_fwd.cu."""
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
        lse.data_ptr(), bh, nq, nk, d, dv, code, 1.0 / d ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    return out, lse


# ---------------------------------------------------------------------------
# K3a / K3b: flash backward. Replace det_sam2_tpu/ops/attention.py:
# _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel (with their _nobias forms).
# Bound by operations (2 * Nq * Nk * (2D + Dv) and 2 * Nq * Nk * (2D + 2Dv)
# FLOPs over the live keys); the kernels recompute P from the saved lse one
# key tile (K3a) or query tile (K3b) at a time, so neither the scores nor P
# ever reach device memory (csrc/flash_bwd_dq.cu, flash_bwd_dkv.cu say more).
# ---------------------------------------------------------------------------

# planted faults of the backward kernels (csrc/flash_common.cuh BwdFault),
# for the checks that must catch them; production calls pass 0
BWD_FAULTS = {"dq without the delta term": 1, "a live key tile skipped": 2,
              "P not zeroed where lse <= -1e29": 3, "dv from the wrong tile": 4}


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


def _bwd_ref(q, k, v, bias, lse, dout, delta):
    """``flash_attention_bwd_ref`` given delta [BH, Nq] in place of out."""
    bh, nq, d = q.shape
    nk = k.shape[1]
    scale = 1.0 / d ** 0.5
    step = max(1, (1 << 27) // max(1, nq * nk))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    for i in range(0, bh, step):
        sl = slice(i, i + step)
        g = dout[sl].float()
        s = torch.matmul(q[sl].float(), k[sl].float().transpose(-1, -2)) * scale
        if bias is not None:
            s = s + bias[sl].float()[:, None, :]
        l = lse[sl].float()[..., None]
        p = torch.where(l > -1e29, torch.exp(s - l), torch.zeros_like(s))
        ds = p * (torch.matmul(g, v[sl].float().transpose(-1, -2))
                  - delta[sl].float()[..., None])
        dq[sl] = (torch.matmul(ds.to(k.dtype).float(), k[sl].float()) * scale).to(q.dtype)
        dk[sl] = (torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q[sl].float())
                  * scale).to(k.dtype)
        dv[sl] = torch.matmul(p.transpose(-1, -2), g).to(v.dtype)
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
# K1; the kernel reads K/V straight from the bank rows named by the slot list
# (no gathered copy in device memory) and adds the per-tile RoPE correction
# in fp32 while staging K (csrc/flash_banked_fwd.cu says more).
# ---------------------------------------------------------------------------


def banked_keys(mem_k, slots, w, cos, sin, layer: int, dtype) -> torch.Tensor:
    """The keys K2 reads: [B, T*S, D] = mem_k[slots, :, layer] plus the
    per-tile RoPE correction [w1*cos - w2*sin, w1*sin + w2*cos] (halves
    layout), added in fp32 and rounded to `dtype`."""
    half = w.shape[-1] // 2
    w1 = w[:, None, :half].float()
    w2 = w[:, None, half:].float()
    corr = torch.cat([cos * w1 - sin * w2, sin * w1 + cos * w2], -1)  # [T,S,D]
    k = mem_k.index_select(0, slots.long())[:, :, layer]  # [T, B, S, D]
    k = (k.float() + corr[:, None]).to(dtype)
    t, b, s, d = k.shape
    return k.permute(1, 0, 2, 3).reshape(b, t * s, d)


def flash_attention_banked_ref(q, mem_k, mem_v, slots, w, bias, cos, sin,
                               layer: int) -> torch.Tensor:
    """Plain version of K2: gather the slot rows, add the correction, then
    plain attention. q [B, Nq, D]; mem_k [Ktot, B, L, S, D];
    mem_v [Ktot, B, S, Cm]; slots [T] int32; w [T, D] fp32; bias [B, T*S]
    fp32; cos/sin [S, D/2] fp32 -> [B, Nq, Cm]."""
    k = banked_keys(mem_k, slots, w, cos, sin, layer, q.dtype)
    v = mem_v.index_select(0, slots.long())  # [T, B, S, Cm]
    t, b, s, cm = v.shape
    v = v.permute(1, 0, 2, 3).reshape(b, t * s, cm)
    return sdpa(q, k, v, bias.float()[:, None, :])


def flash_attention_banked_fwd(q, mem_k, mem_v, slots, w, bias, cos, sin,
                               layer: int) -> torch.Tensor:
    """K2 with the shapes of ``flash_attention_banked_ref``. CPU tensors
    take the plain version; CUDA tensors launch csrc/flash_banked_fwd.cu.
    Slots must name rows in [0, Ktot); the kernel reads an out-of-range slot
    as a dead tile rather than out of bounds."""
    if not q.is_cuda:
        return flash_attention_banked_ref(q, mem_k, mem_v, slots, w, bias,
                                          cos, sin, layer)
    b, nq, d = q.shape
    ktot, _, nl, s, _ = mem_k.shape
    cm = mem_v.shape[-1]
    t = slots.shape[0]
    if mem_k.shape != (ktot, b, nl, s, d) or mem_v.shape != (ktot, b, s, cm):
        raise ValueError(f"bank shapes mem_k {mem_k.shape} mem_v {mem_v.shape}")
    if w.shape != (t, d) or bias.shape != (b, t * s):
        raise ValueError(f"w {tuple(w.shape)} bias {tuple(bias.shape)}")
    if cos.shape != (s, d // 2) or sin.shape != (s, d // 2):
        raise ValueError(f"rope tables {tuple(cos.shape)} {tuple(sin.shape)}")
    if not 0 <= layer < nl:
        raise ValueError(f"layer {layer} not in [0, {nl})")
    _check_dims(d, cm)
    if d % 16:
        raise ValueError(f"K2 takes D a multiple of 16, got {d}")
    code = _dtype_code(q)
    dev = q.device
    q, mem_k, mem_v = (_ready(x, q.dtype, dev) for x in (q, mem_k, mem_v))
    slots = _ready(slots.to(torch.int32), torch.int32, dev)
    w, bias, cos, sin = (_ready(x.float(), torch.float32, dev)
                         for x in (w, bias, cos, sin))
    out = torch.empty((b, nq, cm), dtype=q.dtype, device=dev)
    _launch(
        "flash_banked_fwd", q.data_ptr(), mem_k.data_ptr(), mem_v.data_ptr(),
        slots.data_ptr(), w.data_ptr(), bias.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), out.data_ptr(), b, nq, d, cm, ktot, nl, s, t, layer,
        code, 1.0 / d ** 0.5, torch.cuda.current_stream(dev).cuda_stream,
    )
    return out


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
