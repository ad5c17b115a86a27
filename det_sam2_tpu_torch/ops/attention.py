"""Flash attention for the H100: the two forward kernels of the main path.

Counterpart of the JAX package's ``ops/attention.py``, whose Pallas TPU
kernels become hand-written CUDA C++ for Hopper (sm_90a):

  K1  ``flash_attention_fwd``        csrc/flash_fwd.cu
      replaces ``_flash_kernel`` / ``_flash_kernel_nobias`` (``_flash_call``)
  K2  ``flash_attention_banked_fwd`` csrc/flash_banked_fwd.cu
      replaces ``_flash_banked_kernel`` (``_flash_banked_call``)

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
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from det_sam2_tpu_torch.modeling.layers import sdpa, sdpa_lse

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_banked_fwd": 0}

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


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    min_flops: int = 1 << 22,
) -> torch.Tensor:
    """Drop-in for ``layers.sdpa`` on q [B, H, Nq, D], k [B, H, Nk, D],
    v [B, H, Nk, Dv], bias None or [B, 1, 1, Nk].

    The JAX dispatch rule is a rule of this function on every device, not a
    fallback: a problem with Nq * Nk < min_flops, or a bias of any other
    form, goes to the plain ``sdpa``; everything else goes to K1 (which on
    CPU tensors is its plain version)."""
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
    out, _ = flash_attention_fwd(q.reshape(b * h, nq, d), k.reshape(b * h, nk, d),
                                 v.reshape(b * h, nk, dv), bf)
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


def flash_attention_banked(q, mem_k, mem_v, slots, w, bias, cos, sin,
                           layer: int) -> torch.Tensor:
    """Bank-indirect memory cross-attention with the JAX signature:
    q [B, 1, Nq, D] (single head) -> [B, 1, Nq, Cm] raw-value output (the
    caller applies v_proj / out_proj). Inference only."""
    if q.shape[1] != 1:
        raise ValueError("banked attention is single-head")
    return flash_attention_banked_fwd(q[:, 0], mem_k, mem_v, slots, w, bias,
                                      cos, sin, layer)[:, None]


def plain_attention_fns():
    """(attention_fn, banked_attention_fn) computing every kernel's plain
    version on any device, for the reference run of a session. K1's plain
    version under the dispatch rule is ``sdpa`` itself."""
    def banked(q, mem_k, mem_v, slots, w, bias, cos, sin, layer):
        return flash_attention_banked_ref(q[:, 0], mem_k, mem_v, slots, w, bias,
                                          cos, sin, layer)[:, None]

    return sdpa, banked
