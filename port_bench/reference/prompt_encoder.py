"""Prompt encoder: points / boxes / masks -> sparse and dense embeddings.

Counterpart of the JAX package's ``modeling/prompt_encoder.py`` (SAM 2
PromptEncoder), with the SAM 2.1 state-dict names.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .layers import LayerNorm, conv_nhwc, exact_gelu
from .position_encoding import (
    random_pe_grid,
    random_pe_points,
)


class PositionEmbeddingRandom(nn.Module):
    """Holds the random-Fourier gaussian matrix [2, F] as a parameter: the
    JAX package trains it (``pe_gaussian``), so a finetune updates it here
    too. Its state-dict key is the SAM 2.1 checkpoint's, where it is a
    buffer, so strict loading is unchanged."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.positional_encoding_gaussian_matrix = nn.Parameter(
            torch.randn(2, num_pos_feats))


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256,
                 image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024),
                 mask_in_chans: int = 16):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = image_embedding_size
        self.input_image_size = input_image_size
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        # rows: neg (0), pos (1), box top-left (2), box bottom-right (3)
        self.point_embeddings = nn.ModuleList(
            nn.Embedding(1, embed_dim) for _ in range(4)
        )
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.no_mask_embed = nn.Embedding(1, embed_dim)
        ch = mask_in_chans
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, ch // 4, 2, 2),
            LayerNorm(ch // 4, eps=1e-6),
            nn.GELU(),
            nn.Conv2d(ch // 4, ch, 2, 2),
            LayerNorm(ch, eps=1e-6),
            nn.GELU(),
            nn.Conv2d(ch, embed_dim, 1),
        )

    @property
    def gaussian(self) -> torch.Tensor:
        return self.pe_layer.positional_encoding_gaussian_matrix

    @property
    def mask_input_hw(self) -> Tuple[int, int]:
        return (4 * self.image_embedding_size[0], 4 * self.image_embedding_size[1])

    def get_dense_pe(self) -> torch.Tensor:
        """[H, W, C] positional grid for the mask decoder."""
        h, w = self.image_embedding_size
        return random_pe_grid(h, w, self.gaussian.float())

    def _table(self) -> torch.Tensor:
        """[not_a_point; neg; pos; box_tl; box_br] embeddings [5, C]."""
        return torch.cat([self.not_a_point_embed.weight]
                         + [e.weight for e in self.point_embeddings], dim=0)

    def embed_points(self, coords: torch.Tensor, labels: torch.Tensor,
                     pad: bool) -> torch.Tensor:
        """coords [B, P, 2] px, labels [B, P] in {-1, 0, 1, 2, 3} ->
        [B, P(+1), C]; pad appends one (0, 0) / -1 point."""
        b = coords.shape[0]
        coords = coords.float() + 0.5
        if pad:
            coords = torch.cat([coords, coords.new_zeros(b, 1, 2)], dim=1)
            labels = torch.cat([labels, -labels.new_ones(b, 1)], dim=1)
        pe = random_pe_points(coords, self.input_image_size, self.gaussian.float())
        pe = torch.where(labels[..., None] == -1, 0.0, pe)
        pe = pe + self._table().float()[labels.long() + 1]
        return pe.to(self.no_mask_embed.weight.dtype)

    def embed_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes [B, 4] xyxy px -> [B, 2, C] corner embeddings."""
        coords = boxes.float().reshape(-1, 2, 2) + 0.5
        pe = random_pe_points(coords, self.input_image_size, self.gaussian.float())
        corners = torch.cat([self.point_embeddings[2].weight,
                             self.point_embeddings[3].weight], dim=0)
        return (pe + corners.float()).to(self.no_mask_embed.weight.dtype)

    def embed_masks(self, masks: torch.Tensor) -> torch.Tensor:
        """masks [B, 4H, 4W, 1] -> dense embeddings [B, H, W, C]."""
        md = self.mask_downscaling
        x = conv_nhwc(md[0], masks.to(md[0].weight.dtype))
        x = exact_gelu(md[1](x))
        x = conv_nhwc(md[3], x)
        x = exact_gelu(md[4](x))
        return conv_nhwc(md[6], x)

    def no_mask_dense(self, batch: int) -> torch.Tensor:
        h, w = self.image_embedding_size
        return self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
            batch, h, w, self.embed_dim)

    def forward(self, points: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                boxes: Optional[torch.Tensor] = None,
                masks: Optional[torch.Tensor] = None, batch: int = 1):
        """-> (sparse [B, N, C], dense [B, H, W, C])."""
        if points is not None:
            batch = points[0].shape[0]
        elif boxes is not None:
            batch = boxes.shape[0]
        elif masks is not None:
            batch = masks.shape[0]
        parts = []
        if points is not None:
            parts.append(self.embed_points(*points, pad=boxes is None))
        if boxes is not None:
            parts.append(self.embed_boxes(boxes))
        w = self.no_mask_embed.weight
        sparse = (torch.cat(parts, dim=1) if parts
                  else w.new_zeros(batch, 0, self.embed_dim))
        dense = self.embed_masks(masks) if masks is not None else self.no_mask_dense(batch)
        return sparse, dense
