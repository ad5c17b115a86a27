"""Hiera hierarchical ViT trunk.

Counterpart of the JAX package's ``modeling/hiera.py``. NHWC end to end;
windowed attention stacks windows in the batch axis. Global-attention
blocks (and a windowed block whose single window is the whole grid) call
``attention_fn`` (K1, ``ops.attention.flash_attention``); windowed blocks
are plain attention, as the JAX package left them to XLA. With
``cfg.quantize_int8`` the blocks' dense layers of the kinds not in
``cfg.quant_skip`` are ``ops.quant.QuantLinear`` (W8A8, inference only).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .configs import HieraConfig
from .layers import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    MLP,
    LayerNorm,
    drop_path,
    exact_gelu,
    sdpa,
    uniform,
)


def window_partition(x: torch.Tensor, ws: int):
    """[B, H, W, C] -> ([B*nW, ws, ws, C], (Hp, Wp)), zero-padding H, W up
    to multiples of ws."""
    b, h, w, c = x.shape
    pad_h = (ws - h % ws) % ws
    pad_w = (ws - w % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)
    return x, (hp, wp)


def window_unpartition(windows: torch.Tensor, ws: int,
                       pad_hw: Tuple[int, int], hw: Tuple[int, int]):
    """Inverse of window_partition; crops the padding."""
    hp, wp = pad_hw
    h, w = hw
    c = windows.shape[-1]
    b = windows.shape[0] // ((hp // ws) * (wp // ws))
    x = windows.reshape(b, hp // ws, wp // ws, ws, ws, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    return x[:, :h, :w, :]


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """MaxPool2d(2, 2) (floor) on NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class PatchEmbed(nn.Module):
    """7x7 stride-4 conv patch embedding. A uint8 frame is normalised with
    the ImageNet mean/std first; a float input is taken as normalised."""

    def __init__(self, embed_dim: int, kernel: int = 7, stride: int = 4,
                 padding: int = 3):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, kernel, stride, padding)

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> the convolution's NCHW input in the weights' type."""
        if x.dtype == torch.uint8:
            mean = torch.tensor(IMAGENET_MEAN, device=x.device)
            std = torch.tensor(IMAGENET_STD, device=x.device)
            x = (x.float() / 255.0 - mean) / std
        return x.to(self.proj.weight.dtype).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, 3]
        return self.proj(self.normalize(x)).permute(0, 2, 3, 1)


class MultiScaleAttention(nn.Module):
    """Windowed / global attention with optional 2x query pooling."""

    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 q_pool: bool, is_global: bool, attention_fn: Callable,
                 quant_qkv: bool = False, quant_out: bool = False):
        super().__init__()
        # quantised, qkv is one int8 product over rows quantised once, and
        # the output projection's rows span (heads, D)
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)
        self.num_heads = num_heads
        self.q_pool = q_pool
        self.is_global = is_global
        self.attention_fn = attention_fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
        b, h, w, _ = x.shape
        n = h * w
        qkv = self.qkv(x.reshape(b, n, -1)).reshape(b, n, 3, self.num_heads, -1)
        q, k, v = qkv.unbind(2)  # [B, N, heads, D]
        oh, ow = h, w
        if self.q_pool:
            q = max_pool_2x(q.reshape(b, h, w, -1))
            oh, ow = q.shape[1], q.shape[2]
            q = q.reshape(b, oh * ow, self.num_heads, -1)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [B, heads, N, D]
        # a windowed block with b == 1 (one window = the whole grid) is
        # global attention: it takes the same route
        if self.is_global or b == 1:
            o = self.attention_fn(q, k, v)
        else:
            o = F.scaled_dot_product_attention(q, k, v)
        o = o.transpose(1, 2).reshape(b, oh * ow, -1)
        return self.proj(o).reshape(b, oh, ow, -1)


class MultiScaleBlock(nn.Module):
    """Hiera block: (windowed) attention with optional q-pool + MLP."""

    def __init__(self, dim: int, dim_out: int, num_heads: int,
                 window_size: int, q_stride: Optional[Tuple[int, int]],
                 mlp_ratio: float, attention_fn: Callable, gelu: Callable,
                 drop_path_rate: float = 0.0, quant_kinds: Tuple[str, ...] = ()):
        super().__init__()
        self.drop_path_rate = drop_path_rate
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.window_size = window_size
        self.q_stride = q_stride
        self.attn = MultiScaleAttention(
            dim, dim_out, num_heads, q_pool=q_stride is not None,
            is_global=window_size == 0, attention_fn=attention_fn,
            quant_qkv="qkv" in quant_kinds, quant_out="attn_out" in quant_kinds,
        )
        self.norm2 = LayerNorm(dim_out, eps=1e-6)
        self.mlp = MLP(dim_out, int(dim_out * mlp_ratio), dim_out, 2,
                       activation=gelu, quant="mlp" in quant_kinds)
        self.proj = (nn.Linear(dim, dim_out)
                     if dim != dim_out else None)

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, H, W, C]; keep None, or [2, B] bool: the drop-path masks of
        the attention and MLP branches (per image, applied after
        window_unpartition, never on the window-stacked batch)."""
        shortcut = x
        x = self.norm1(x)
        if self.proj is not None:
            shortcut = self.proj(x)
            if self.q_stride:
                shortcut = max_pool_2x(shortcut)
        ws = self.window_size
        h, w = x.shape[1], x.shape[2]
        if ws > 0:
            x, pad_hw = window_partition(x, ws)
        x = self.attn(x)
        if self.q_stride:
            ws = self.window_size // self.q_stride[0]
            h, w = shortcut.shape[1], shortcut.shape[2]
            pad_h = (ws - h % ws) % ws if ws > 0 else 0
            pad_w = (ws - w % ws) % ws if ws > 0 else 0
            pad_hw = (h + pad_h, w + pad_w)
        if self.window_size > 0:
            x = window_unpartition(x, ws, pad_hw, (h, w))
        k_attn, k_mlp = (None, None) if keep is None else keep
        x = shortcut + drop_path(x, self.drop_path_rate, keep=k_attn)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path_rate, keep=k_mlp)


class Hiera(nn.Module):
    """4-stage hierarchical trunk; returns per-stage NHWC maps, highest
    resolution first."""

    def __init__(self, cfg: HieraConfig, attention_fn: Callable = sdpa,
                 gelu: Callable = exact_gelu):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.patch_embed = PatchEmbed(c.embed_dim, c.patch_kernel,
                                      c.patch_stride, c.patch_padding)
        bkg_h, bkg_w = c.window_pos_embed_bkg_spatial_size
        ws0 = c.window_spec[0]
        self.pos_embed = nn.Parameter(torch.zeros(1, c.embed_dim, bkg_h, bkg_w))
        self.pos_embed_window = nn.Parameter(torch.zeros(1, c.embed_dim, ws0, ws0))
        q_pool_blocks = set(c.q_pool_blocks)
        global_blocks = set(c.global_att_blocks or ())
        kinds = ()
        blocks = []
        embed_dim, num_heads, cur_stage = c.embed_dim, c.num_heads, 1
        # stochastic depth, linear over depth on both residual branches
        dpr = [c.drop_path_rate * i / max(c.depth - 1, 1) for i in range(c.depth)]
        for i in range(c.depth):
            dim_out = embed_dim
            window_size = c.window_spec[cur_stage - 1]
            if i in global_blocks:
                window_size = 0
            if i - 1 in c.stage_ends:
                dim_out = int(embed_dim * c.dim_mul)
                num_heads = int(num_heads * c.head_mul)
                cur_stage += 1
            blocks.append(MultiScaleBlock(
                embed_dim, dim_out, num_heads, window_size,
                c.q_stride if i in q_pool_blocks else None, c.mlp_ratio,
                attention_fn, gelu, drop_path_rate=dpr[i], quant_kinds=kinds,
            ))
            embed_dim = dim_out
        self.blocks = nn.ModuleList(blocks)

    def draw_drop_path(self, n: int, generator: torch.Generator,
                       device) -> Optional[torch.Tensor]:
        """The drop-path keep masks of a forward over n images, [depth, 2, n]
        bool (block i keeps an image's branch with probability 1 - dpr[i]),
        or None when drop_path_rate is 0. Drawn before the forward, so that
        a rematerialised trunk replays the same masks."""
        if self.cfg.drop_path_rate <= 0.0:
            return None
        rates = torch.tensor([b.drop_path_rate for b in self.blocks], device=device)
        u = uniform((len(self.blocks), 2, n), generator, device)
        return u < (1.0 - rates)[:, None, None]

    def pos_embed_at(self, h: int, w: int) -> torch.Tensor:
        """The fp32 positional embedding [1, h, w, C] of an (h, w) patch
        grid: the background embedding resized bicubically plus the tiled
        window embedding."""
        ws0 = self.cfg.window_spec[0]
        if h % ws0 or w % ws0:
            raise ValueError(
                f"Hiera input must give a post-patch-embed grid divisible by "
                f"window_spec[0]={ws0}; got {h}x{w}"
            )
        pe = F.interpolate(self.pos_embed.float(), size=(h, w), mode="bicubic",
                           align_corners=False)
        pe = pe + self.pos_embed_window.float().tile(1, 1, h // ws0, w // ws0)
        return pe.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor,
                drop_keep: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """x [B, H, W, 3] -> per-stage maps; drop_keep from
        ``draw_drop_path`` (training) or None (no stochastic depth)."""
        c = self.cfg
        x = self.patch_embed(x)
        x = x + self.pos_embed_at(x.shape[1], x.shape[2]).to(x.dtype)
        outputs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x, None if drop_keep is None else drop_keep[i])
            if i in c.stage_ends:
                outputs.append(x)
        return outputs
