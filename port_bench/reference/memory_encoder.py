"""Memory encoder: (pixel features, predicted mask) -> 64-d memory map.

Counterpart of the JAX package's ``modeling/memory_encoder.py`` (SAM 2
MaskDownSampler, CXBlock, Fuser, MemoryEncoder), NHWC, with the SAM 2.1
state-dict names. The mask downsampler is the plain chain of stride-2 convs
(the JAX package's space-to-depth form is a TPU rearrangement of it).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .configs import MemoryEncoderConfig
from .layers import LayerNorm, conv_nhwc, exact_gelu


class MaskDownSampler(nn.Module):
    """Stride-s convs + LayerNorm + GELU down to total_stride, then a 1x1
    conv to in_dim. ``encoder`` indices follow SAM 2.1: conv 3i, norm 3i+1,
    GELU 3i+2, final conv 3n."""

    def __init__(self, c: MemoryEncoderConfig):
        super().__init__()
        n = int(math.log2(c.mask_downsampler_total_stride)
                // math.log2(c.mask_downsampler_stride))
        layers, cin = [], 1
        for _ in range(n):
            cout = cin * c.mask_downsampler_stride ** 2
            layers += [
                nn.Conv2d(cin, cout, c.mask_downsampler_kernel,
                          c.mask_downsampler_stride, c.mask_downsampler_padding),
                LayerNorm(cout, eps=1e-6),
                nn.GELU(),
            ]
            cin = cout
        layers.append(nn.Conv2d(cin, c.in_dim, 1))
        self.encoder = nn.Sequential(*layers)
        self.num_layers = n

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, 1]
        enc = self.encoder
        for i in range(self.num_layers):
            x = exact_gelu(enc[3 * i + 1](conv_nhwc(enc[3 * i], x)))
        return conv_nhwc(enc[3 * self.num_layers], x)


class CXBlock(nn.Module):
    """ConvNeXt block: depthwise 7x7, LayerNorm, MLP, layer scale."""

    def __init__(self, dim: int, kernel: int = 7, padding: int = 3,
                 layer_scale_init_value: float = 1e-6):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, kernel, padding=padding, groups=dim)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(layer_scale_init_value * torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(conv_nhwc(self.dwconv, x))
        y = self.pwconv2(exact_gelu(self.pwconv1(y)))
        return x + self.gamma * y


class Fuser(nn.Module):
    def __init__(self, c: MemoryEncoderConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            CXBlock(c.fuser_dim, c.cx_kernel, c.cx_padding,
                    c.layer_scale_init_value)
            for _ in range(c.fuser_num_layers)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class MemoryEncoder(nn.Module):
    """Fuse pixel features with the downsampled mask; project to out_dim."""

    def __init__(self, c: MemoryEncoderConfig):
        super().__init__()
        self.mask_downsampler = MaskDownSampler(c)
        self.pix_feat_proj = nn.Conv2d(c.in_dim, c.in_dim, 1)
        self.fuser = Fuser(c)
        self.out_proj = (nn.Conv2d(c.in_dim, c.out_dim, 1)
                         if c.out_dim != c.in_dim else None)

    def forward(self, pix_feat: torch.Tensor, masks: torch.Tensor,
                skip_mask_sigmoid: bool = False) -> torch.Tensor:
        """pix_feat [B, s, s, C], masks [B, H, W, 1] -> [B, s, s, out_dim]."""
        if not skip_mask_sigmoid:
            masks = torch.sigmoid(masks)
        masks = self.mask_downsampler(masks)
        x = conv_nhwc(self.pix_feat_proj, pix_feat) + masks
        x = self.fuser(x)
        if self.out_proj is not None:
            x = conv_nhwc(self.out_proj, x)
        return x
