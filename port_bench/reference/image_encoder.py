"""FPN neck + image encoder.

Counterpart of the JAX package's ``modeling/image_encoder.py``: 1x1 lateral
convs to d_model, nearest 2x top-down on the configured levels, and
scalp-dropping of the lowest-resolution level. NHWC.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .configs import FpnNeckConfig, HieraConfig
from .hiera import Hiera
from .layers import conv_nhwc, exact_gelu, sdpa


class FpnNeck(nn.Module):
    """Lateral 1x1 convs + top-down pathway. ``convs[j]`` takes
    ``backbone_channel_list[j]`` channels (lowest resolution first)."""

    def __init__(self, cfg: FpnNeckConfig):
        super().__init__()
        assert cfg.fuse_type in ("sum", "avg")
        self.cfg = cfg
        self.convs = nn.ModuleList(
            nn.Sequential(OrderedDict(conv=nn.Conv2d(c, cfg.d_model, 1)))
            for c in cfg.backbone_channel_list
        )

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """xs: trunk outputs, highest resolution first -> same-indexed
        features."""
        c = self.cfg
        n = len(xs) - 1
        out: List[torch.Tensor] = [None] * len(xs)
        prev = None
        for i in range(n, -1, -1):
            lateral = conv_nhwc(self.convs[n - i], xs[i])
            if i in c.fpn_top_down_levels and prev is not None:
                td = prev.float().repeat_interleave(2, 1).repeat_interleave(2, 2)
                prev = lateral + td.to(lateral.dtype)
                if c.fuse_type == "avg":
                    prev = prev / 2
            else:
                prev = lateral
            out[i] = prev
        return out


class ImageEncoder(nn.Module):
    """Trunk -> neck -> scalp."""

    def __init__(self, hiera_cfg: HieraConfig, neck_cfg: FpnNeckConfig,
                 scalp: int = 1, attention_fn: Callable = sdpa,
                 gelu: Callable = exact_gelu):
        super().__init__()
        self.trunk = Hiera(hiera_cfg, attention_fn=attention_fn, gelu=gelu)
        self.neck = FpnNeck(neck_cfg)
        self.scalp = scalp

    def forward(self, sample: torch.Tensor,
                drop_keep: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
        """sample [B, H, W, 3] -> NHWC FPN features, highest res first.
        drop_keep: the trunk's drop-path masks (``Hiera.draw_drop_path``)."""
        return self.neck_features(self.trunk(sample, drop_keep))

    def neck_features(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        """The trunk's stage outputs -> the scalped FPN features."""
        features = self.neck(xs)
        if self.scalp > 0:
            features = features[: -self.scalp]
        return features
