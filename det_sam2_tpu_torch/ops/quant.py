"""W8A8 int8 products for the Hiera trunk (opt-in, inference only).

Counterpart of the JAX package's ``ops/quant.py``. Weights are quantised per
output channel to int8 (symmetric absmax), activations per token (row) on
the fly, and the product runs as int8 x int8 -> int32: on CUDA through
``torch._int_mm`` (cuBLASLt's int8 tensor-core GEMM), on the CPU through the
same call's CPU version. The int32 sums are exact, so both give the same
bits. The rescale (row scale x channel scale) and the bias stay fp32 / plain
torch, as the JAX package's epilogue:

    y = (int32_product.float() * s_row * w_scale).to(out_dtype) + bias.to(out_dtype)

Rounding is half to even on both sides (``torch.round`` = ``jnp.round``),
``scale = max(absmax, 1e-12) / 127`` is fp32 and the quantised values are
clipped to +-127, so on the same inputs a quantised layer here gives the
JAX layer's bits.

Scope: the trunk blocks' dense layers (qkv, attention out, MLP, the
dim-change shortcut ``proj``); ``patch_embed``, the neck, memory attention and
the SAM heads stay floating point. Usage::

    sd = quantize_trunk(state_dict, skip=cfg.hiera.quant_skip)
    cfg = replace(cfg, hiera=replace(cfg.hiera, quantize_int8=True))
    engine = SAM2Engine(cfg, params=sd, dtype=torch.bfloat16)

(``build.build_sam2_engine(..., quantize_int8=True)`` does this.)
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import torch
from torch import nn

INT8_MAX = 127.0
_EPS = 1e-12

# int8 products run since the last reset (chip_smoke reads it to show that
# a quantised path multiplied in int8, never in floating point)
INT8_PRODUCTS = {"int8_mm": 0}


def reset_counts() -> None:
    INT8_PRODUCTS["int8_mm"] = 0


def _quantize(x: torch.Tensor, dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    absmax = xf.abs().amax(dim=dim, keepdim=True)
    s = absmax.clamp_min(_EPS) / INT8_MAX
    x_q = torch.clamp(torch.round(xf / s), -INT8_MAX, INT8_MAX).to(torch.int8)
    return x_q, s


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [Cout, Cin] (torch layout) -> (w_q int8 [Cout, Cin], scale fp32
    [Cout]): one symmetric absmax scale per output channel, over Cin."""
    w_q, s = _quantize(w, dim=1)
    return w_q, s[:, 0]


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [..., Cin] -> (x_q int8 [..., Cin], s_row fp32 [..., 1]): one scale
    per row (token), over the contracted last axis."""
    return _quantize(x, dim=-1)


def int8_mm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """x_q [M, K] int8 @ w_q[N, K]^T int8 -> [M, N] int32, exact. On CUDA
    ``torch._int_mm`` needs M > 16 and K, N multiples of 8: another shape
    raises rather than take a floating-point product."""
    m, k = x_q.shape
    n = w_q.shape[0]
    if x_q.is_cuda and (m <= 16 or k % 8 or n % 8):
        raise ValueError(
            f"the int8 product [{m}, {k}] x [{k}, {n}] is outside torch._int_mm's "
            "CUDA shapes (M > 16, K and N multiples of 8)")
    INT8_PRODUCTS["int8_mm"] += 1
    return torch._int_mm(x_q, w_q.t())


def int8_matmul_prequant(x_q: torch.Tensor, s_row: torch.Tensor,
                         w_q: torch.Tensor, w_scale: torch.Tensor,
                         out_dtype: torch.dtype) -> torch.Tensor:
    """The product of rows quantised once (``quantize_rows``) with w_q [N, K],
    rescaled in fp32: [..., K] -> [..., N] of out_dtype."""
    lead = x_q.shape[:-1]
    y = int8_mm(x_q.reshape(-1, x_q.shape[-1]), w_q).reshape(lead + (w_q.shape[0],))
    return (y.float() * s_row * w_scale).to(out_dtype)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    """round(x / s_row) @ w_q^T * (s_row * w_scale): x [..., K] float, w_q
    [N, K] int8, w_scale [N] fp32 -> [..., N] of out_dtype."""
    x_q, s_row = quantize_rows(x)
    return int8_matmul_prequant(x_q, s_row, w_q, w_scale, out_dtype)


class QuantLinear(nn.Module):
    """nn.Linear over int8 weights (the JAX package's ``QuantDense``):
    buffers ``weight_q`` int8 [Cout, Cin], ``weight_scale`` fp32 [Cout] and
    ``bias`` [Cout], the state dict ``quantize_trunk`` makes from a Linear's
    ``weight`` / ``bias``. Buffers, not parameters: no optimizer sees them.
    The output has the input's type."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.register_buffer("weight_q", torch.zeros(out_features, in_features,
                                                     dtype=torch.int8))
        self.register_buffer("weight_scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features))

    def _apply(self, fn, recurse=True):
        # the scales follow the module to its device but stay fp32 whatever
        # type the model is cast to: the epilogue rescales in fp32
        scale = self._buffers["weight_scale"]
        super()._apply(fn, recurse)
        self._buffers["weight_scale"] = scale.to(self._buffers["weight_q"].device)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = int8_matmul(x, self.weight_q, self.weight_scale, x.dtype)
        return y + self.bias.to(x.dtype)


def linear(in_features: int, out_features: int, quant: bool) -> nn.Module:
    """A QuantLinear when `quant`, else an nn.Linear."""
    cls = QuantLinear if quant else nn.Linear
    return cls(in_features, out_features)


# ----------------------------------------------------------------------
# state-dict conversion: fp trunk -> int8 trunk
# ----------------------------------------------------------------------

_TRUNK_DENSE = re.compile(
    r"(^|\.)trunk\.blocks\.\d+\.(attn\.qkv|attn\.proj|mlp\.layers\.\d+|proj)\.weight$")
_KINDS = {"attn.qkv": "qkv", "attn.proj": "attn_out", "proj": "proj"}


def block_dense_kind(key: str) -> str:
    """Layer kind of a trunk block's dense weight ("qkv" / "attn_out" /
    "mlp" / "proj"), or "" when the state-dict key is none of them (e.g.
    ``image_encoder.trunk.patch_embed.proj.weight``, a convolution)."""
    m = _TRUNK_DENSE.search(key)
    if m is None:
        return ""
    return _KINDS.get(m.group(2), "mlp")


def quant_kinds(hiera_cfg) -> Tuple[str, ...]:
    """The kinds a HieraConfig quantises: none unless quantize_int8, else
    every kind not in quant_skip."""
    if not hiera_cfg.quantize_int8:
        return ()
    return tuple(k for k in ("qkv", "attn_out", "mlp", "proj")
                 if k not in hiera_cfg.quant_skip)


def quantize_trunk(state_dict: Dict[str, torch.Tensor],
                   skip: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """Rewrite every trunk block dense ``weight`` into ``weight_q`` (int8) and
    ``weight_scale`` (fp32); every other entry is kept as it is. The result
    loads into a model built with ``HieraConfig.quantize_int8=True``.
    `skip`: layer kinds kept full precision; it must match the model's
    ``quant_skip``."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        kind = block_dense_kind(key)
        if kind and kind not in skip:
            w_q, scale = quantize_weight(torch.as_tensor(value))
            stem = key[: -len("weight")]
            out[stem + "weight_q"] = w_q
            out[stem + "weight_scale"] = scale
        else:
            out[key] = value
    return out
