"""LayerNorm over the trailing axis, fp32 statistics, one pass on the H100.

The JAX package's LayerNorm is plain jnp that XLA fuses into one sweep, so
this replaces no Pallas kernel: it is the port's way to the same single
pass. ``csrc/layer_norm.cu`` reads each row once into registers, takes the
shifted one-pass statistics of the plain version
(``modeling.layers.layer_norm_ref``) with warp shuffles and writes the row
once; the plain version makes about twelve full passes.

``layer_norm`` refuses what the kernel does not take (``check_launch``) on
any device; then a CPU tensor computes the plain version and a CUDA tensor
launches the kernel on the current stream, one launch a call (none for an
empty batch), and adds one to ``ops.attention.LAUNCHES["layer_norm"]``. The
kernel joins the attention kernels' build, loading and counts
(``ops.attention.register_kernel``). ``modeling.layers.LayerNorm`` decides
which of the two a module call takes.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from det_sam2_tpu_torch.modeling.layers import layer_norm_ref
from det_sam2_tpu_torch.ops import attention as att

_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, b, y, rows, c, vec, g, n, dtype, eps, sms, fault, stream
att.register_kernel("layer_norm", [_P] * 4 + [ctypes.c_longlong] + [_I] * 5
                    + [ctypes.c_float, _I, _I, _P])
# planted faults (csrc/layer_norm.cu kFault*), for the checks that must
# catch them; production calls pass 0
FAULTS = {"unshifted variance": 1, "last vector of a row not read": 2,
          "w and b swapped": 3}

LANE_ELEMS = 48  # the most elements a lane holds (csrc/layer_norm.cu kLaneElems)
MAX_C = 32 * LANE_ELEMS
# the kernel's instances: slots a lane, by (element bytes, vector elements).
# 16-byte vectors have every count, so a lane holds no register it does not
# use; narrower ones (C not a multiple of 16 bytes) one slot or the most
INSTANCES = {(2, 8): (1, 2, 3, 4, 5, 6), (2, 4): (1, 12), (2, 2): (1, 24), (2, 1): (1, 48),
             (4, 4): tuple(range(1, 13)), (4, 2): (1, 24), (4, 1): (1, 48)}
_DTYPES = {torch.bfloat16: 1, torch.float32: 0}


@functools.lru_cache(maxsize=64)
def plan(c: int, elem_bytes: int) -> Tuple[int, int, int]:
    """(VEC, G, N) for rows of c elements of elem_bytes each: VEC elements
    a vector, the widest of at most 16 bytes that divides c; G lanes a row,
    the power of two up to 32 that leaves the smallest share of vector slots
    idle (then the fewest slots a lane), among those whose lanes hold at
    most LANE_ELEMS elements; N the kernel instance's slots a lane, the
    fewest that hold the row."""
    vec = 16 // elem_bytes
    while c % vec:
        vec //= 2
    nv = c // vec
    best = None
    for g in (1, 2, 4, 8, 16, 32):
        n = -(-nv // g)
        if n * vec > LANE_ELEMS:
            continue
        key = ((g * n - nv) / (g * n), n)
        if best is None or key < best[0]:
            best = (key, g, n)
    if best is None:
        raise ValueError(f"layer_norm takes rows of at most {MAX_C} elements, got {c}")
    _, g, n = best
    return vec, g, min(k for k in INSTANCES[(elem_bytes, vec)] if k >= n)


def check_launch(x: torch.Tensor) -> None:
    """Raise on exactly what csrc/layer_norm.cu does not take: a type other
    than bf16 or fp32 (TypeError), an empty or too long row (ValueError)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer_norm takes bf16 or fp32, got {x.dtype}")
    c = x.shape[-1] if x.dim() else 0
    if not 1 <= c <= MAX_C:
        raise ValueError(f"layer_norm takes rows of 1 to {MAX_C} elements, got {c}")


@functools.lru_cache(maxsize=8)
def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def launch_args(src: torch.Tensor, out: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                eps: float, fault: int = 0):
    """The C entry's arguments for src [..., C] -> out of src's type and
    shape, both contiguous and 16-byte aligned, w and b fp32 [C], all on
    one card: ``att.launch("layer_norm", *launch_args(...))``."""
    c = src.shape[-1]
    vec, g, n = plan(c, src.element_size())
    return (src.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), src.numel() // c, c,
            vec, g, n, _DTYPES[src.dtype], float(eps), _sms(src.device), fault,
            torch.cuda.current_stream(src.device).cuda_stream)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
               fault: int = 0) -> torch.Tensor:
    """LayerNorm of x [..., C] over C with fp32 statistics, weight and bias
    [C] taken as fp32; the result in x's type and shape, contiguous. A CPU
    tensor takes the plain version; a CUDA tensor launches
    csrc/layer_norm.cu (a non-contiguous x is made contiguous first)."""
    check_launch(x)
    c = x.shape[-1]
    if weight.numel() != c or bias.numel() != c:
        raise ValueError(f"layer_norm: weight {tuple(weight.shape)} and bias "
                         f"{tuple(bias.shape)} for rows of {c}")
    if not x.is_cuda:
        if fault:
            raise ValueError("planted faults exist only in the kernel")
        return layer_norm_ref(x, weight, bias, eps)
    w, b = (t if t.dtype == torch.float32 and t.device == x.device and t.is_contiguous()
            else t.detach().to(x.device, torch.float32).contiguous() for t in (weight, bias))
    src = x.contiguous()
    if src.data_ptr() % 16:  # a view into a larger buffer
        src = src.clone()
    out = torch.empty(src.shape, dtype=src.dtype, device=src.device)
    if src.numel():
        att.launch("layer_norm", *launch_args(src, out, w, b, eps, fault))
    return out


ROW_ULPS = 16  # fp32 ulps of a row's largest |normalised output|, times its conditioning


def _ulp(m: torch.Tensor, mantissa_bits: int) -> torch.Tensor:
    """Spacing of a float type with that many mantissa bits at |m|."""
    _, e = torch.frexp(m.abs().clamp_min(torch.finfo(torch.float32).tiny))
    return torch.ldexp(torch.ones_like(m), e - 1 - mantissa_bits)


def gate_ratio(out: torch.Tensor, ref: torch.Tensor, x: torch.Tensor, bias: torch.Tensor,
               eps: float) -> float:
    """The kernel's error against the plain version on x in units of its
    gate (<= 1 passes). An element may be off by one ulp of the output type
    at |ref| (the last rounding: the two results may be neighbours) plus
    ROW_ULPS fp32 ulps of its row's largest |ref - bias| (the normalised,
    scaled part, which carries the statistics) times the row's
    conditioning E[(x-c)^2] / (Var[x] + eps) (at least 1). The second part
    is the fp32 error of the shifted one-pass statistics, which both
    versions carry in full, each summing in its own order: the shift
    c = x[0] can sit a few spreads from the mean, and then
    E[(x-c)^2] - (E[x]-c)^2 cancels that much (on an H100, against float64,
    both versions read up to ~55 fp32 ulps of the row's largest output at
    C = 144, where c sits 4 spreads out). An output near zero comes from a
    cancellation too, where its own ulp says nothing."""
    xd = x.double()
    xc = xd - xd[..., :1]
    m2 = xc.square().mean(-1, keepdim=True)
    var = (m2 - xc.mean(-1, keepdim=True).square()).clamp_min(0.0)
    cond = (m2 / (var + eps)).clamp_min(1.0).float()
    o, r = out.float(), ref.float()
    scaled = (r - bias.float()).abs().amax(-1, keepdim=True)
    allow = (_ulp(r, 7 if out.dtype == torch.bfloat16 else 23)
             + ROW_ULPS * cond * _ulp(scaled, 23))
    bad = ~torch.isfinite(o)
    ratio = ((o - r).abs() / allow).masked_fill(bad, math.inf)
    return float(ratio.max()) if ratio.numel() else 0.0
