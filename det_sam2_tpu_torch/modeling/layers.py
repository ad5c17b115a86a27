"""Shared building blocks: LayerNorm, GELU, MLP and plain attention.

Counterpart of the JAX package's ``modeling/layers.py``. Feature maps are
NHWC (channels last), as in the JAX package, so LayerNorm2d is the trailing-
axis LayerNorm. Convolutions see NCHW views of the same memory.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

# ImageNet normalization (SAM 2 transforms defaults)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def exact_gelu(x: torch.Tensor) -> torch.Tensor:
    """erf GELU (torch ``nn.GELU`` default)."""
    return F.gelu(x)


def approx_gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh GELU; ~1e-3 abs from the erf form, below bf16 resolution."""
    return F.gelu(x, approximate="tanh")


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW conv module to an NHWC tensor: the permuted view is a
    channels-last NCHW tensor, so no copy is made around the conv."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class MLP(nn.Module):
    """N-layer perceptron with an activation between layers and an optional
    sigmoid on the output (SAM 2 ``sam2_utils.MLP``)."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, activation: Callable = F.relu,
                 sigmoid_output: bool = False):
        super().__init__()
        dims_in = [input_dim] + [hidden_dim] * (num_layers - 1)
        dims_out = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(dims_in, dims_out)
        )
        self.activation = activation
        self.sigmoid_output = sigmoid_output

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.activation(x)
        if self.sigmoid_output:
            x = torch.sigmoid(x)
        return x


class LayerNorm(nn.Module):
    """LayerNorm over the trailing axis with fp32 statistics.

    The variance is the SHIFTED one-pass form of the JAX package: with
    c = x[..., :1], Var[x] = E[(x-c)^2] - (E[x]-c)^2. Both moments are
    O(std^2 + (mean-c)^2), so the subtraction does not cancel when
    |mean| >> std (the unshifted E[x^2] - E[x]^2 loses ~mean^2 * eps_fp32).
    """

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        orig_dtype = x.dtype
        x = x.float()
        xc = x - x[..., :1]
        mean_c = xc.mean(-1, keepdim=True)
        mean2_c = xc.square().mean(-1, keepdim=True)
        var = (mean2_c - mean_c.square()).clamp_min(0.0)
        y = (xc - mean_c) * torch.rsqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(orig_dtype)


def uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    """U[0, 1) fp32 of `shape` drawn from `generator` on the generator's own
    device, then placed on `device`."""
    return torch.rand(shape, generator=generator,
                      device=generator.device).to(device)


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator] = None,
              keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stochastic depth on the leading (batch) axis: each sample is kept
    with probability keep = 1 - rate and scaled by 1 / keep, or zeroed.
    The mask is `keep` when given, else drawn from `generator`; with rate 0
    or neither, x is returned as is (inference never draws).

    Under rematerialisation the masks must be drawn OUTSIDE the checkpointed
    region and passed in as `keep`: torch.utils.checkpoint replays the
    global RNG states, not an explicit generator, so a mask drawn inside
    would be drawn anew in the recomputation and the gradients would belong
    to another network (the JAX package replays the same key)."""
    if rate == 0.0 or (generator is None and keep is None):
        return x
    if keep is None:
        keep = uniform((x.shape[0],), generator, x.device) < 1.0 - rate
    mask = keep.reshape((-1,) + (1,) * (x.ndim - 1))
    return torch.where(mask, x / (1.0 - rate), torch.zeros_like(x))


def sdpa_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             bias: Optional[torch.Tensor] = None):
    """Plain scaled dot-product attention and its row logsumexp:
    q [..., Nq, D], k [..., Nk, D], v [..., Nk, Dv], additive fp32 bias
    broadcastable to [..., Nq, Nk] -> (out [..., Nq, Dv], lse [..., Nq]).

    Logits and softmax are fp32 (products of bf16 inputs are exact in fp32);
    P is rounded to v's type before the P.V product, which accumulates in
    fp32. A query row whose bias is <= -1e29 for every key (an object slot
    with no valid memory) gets P = 0, so the row comes out as zeros, as from
    the flash kernels. ``F.scaled_dot_product_attention`` would give a
    uniform softmax there instead.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias
    lse = torch.logsumexp(logits, dim=-1)
    probs = torch.exp(logits - lse[..., None])
    if bias is not None:
        dead = bias.amax(dim=-1, keepdim=True) <= -1e29
        probs = probs.masked_fill(dead, 0.0)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype), lse


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sdpa_lse`` without the logsumexp: the plain attention that the
    flash kernels replace."""
    return sdpa_lse(q, k, v, bias)[0]
