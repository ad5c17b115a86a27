"""Positional encodings: 2-D sine, random Fourier, 1-D sine, axial RoPE.

Counterpart of the JAX package's ``modeling/position_encoding.py``. The
deterministic tables (sine, RoPE) are built with numpy and cached by shape;
callers move them to their device once. RoPE keeps the JAX package's
"halves" layout: q/k projection columns are permuted with
``rope_channel_perm`` so that the rotation pairs channel j with j + D/2. The
memory bank's cached keys and K2's [S, D/2] cos/sin tables are in that
layout.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def sine_pos_embed_2d(h: int, w: int, num_pos_feats: int,
                      temperature: float = 10000.0) -> np.ndarray:
    """[h, w, num_pos_feats] (channels last): concat(pe_y, pe_x), each half
    interleaving sin/cos over pair-shared frequencies (SAM 2
    PositionEmbeddingSine, normalize=True)."""
    assert num_pos_feats % 2 == 0
    half = num_pos_feats // 2
    scale = 2 * math.pi
    eps = 1e-6
    y = np.arange(1, h + 1, dtype=np.float64)[:, None] * np.ones((1, w))
    x = np.arange(1, w + 1, dtype=np.float64)[None, :] * np.ones((h, 1))
    y = y / (h + eps) * scale
    x = x / (w + eps) * scale
    dim_t = np.arange(half, dtype=np.float64)
    dim_t = temperature ** (2 * (dim_t // 2) / half)

    def _interleave(p):
        out = np.empty_like(p)
        out[..., 0::2] = np.sin(p[..., 0::2])
        out[..., 1::2] = np.cos(p[..., 1::2])
        return out

    pe_y = _interleave(y[..., None] / dim_t)
    pe_x = _interleave(x[..., None] / dim_t)
    return np.concatenate([pe_y, pe_x], axis=-1).astype(np.float32)


def get_1d_sine_pe(pos: torch.Tensor, dim: int,
                   temperature: float = 10000.0) -> torch.Tensor:
    """1-D sine embedding of positions [...] -> [..., dim]: first half sin,
    second half cos over pair-shared frequencies."""
    pe_dim = dim // 2
    dim_t = np.arange(pe_dim, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / pe_dim)
    emb = pos[..., None] / torch.as_tensor(dim_t, device=pos.device)
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def random_pe_encode(coords01: torch.Tensor,
                     gaussian: torch.Tensor) -> torch.Tensor:
    """coords [..., 2] in [0, 1] -> [..., 2F] with gaussian [2, F]."""
    c = 2.0 * coords01 - 1.0
    c = c @ gaussian
    c = (2.0 * math.pi) * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def random_pe_grid(h: int, w: int, gaussian: torch.Tensor) -> torch.Tensor:
    """Dense grid encoding [h, w, 2F] of cell centres as (x, y)."""
    ye = (torch.arange(h, dtype=torch.float32, device=gaussian.device) + 0.5) / h
    xe = (torch.arange(w, dtype=torch.float32, device=gaussian.device) + 0.5) / w
    grid = torch.stack(
        [xe[None, :].expand(h, w), ye[:, None].expand(h, w)], dim=-1
    )
    return random_pe_encode(grid.to(gaussian.dtype), gaussian)


def random_pe_points(coords_px: torch.Tensor, image_hw,
                     gaussian: torch.Tensor) -> torch.Tensor:
    """Pixel coords [..., 2] as (x, y) -> [..., 2F]."""
    h, w = image_hw
    scale = torch.tensor([1.0 / w, 1.0 / h], dtype=coords_px.dtype,
                         device=coords_px.device)
    return random_pe_encode(coords_px * scale, gaussian)


@functools.lru_cache(maxsize=None)
def axial_rope_cos_sin(head_dim: int, end_x: int, end_y: int,
                       theta: float = 10000.0):
    """cos/sin tables [end_x * end_y, head_dim // 2]: the first head_dim // 4
    pairs rotate by the x coordinate (t % end_x), the rest by y."""
    quarter = head_dim // 4
    freqs = 1.0 / (
        theta ** (np.arange(0, head_dim, 4, dtype=np.float64)[:quarter] / head_dim)
    )
    t = np.arange(end_x * end_y, dtype=np.float64)
    tx = t % end_x
    ty = np.floor(t / end_x)
    ang = np.concatenate([np.outer(tx, freqs), np.outer(ty, freqs)], axis=-1)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def rope_channel_perm(head_dim: int) -> np.ndarray:
    """[0, 2, 4, ..., 1, 3, 5, ...]: maps interleaved rotation pairs to
    [first half | second half]. q.k is invariant under a permutation shared
    by q and k."""
    perm = np.empty(head_dim, np.int64)
    perm[: head_dim // 2] = np.arange(0, head_dim, 2)
    perm[head_dim // 2:] = np.arange(1, head_dim, 2)
    return perm


def apply_rope_halves(x: torch.Tensor, cos: torch.Tensor,
                      sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (j, j + D/2) of the last dim by cos/sin [..., N, D/2],
    in fp32; returns x's dtype."""
    orig_dtype = x.dtype
    xf = x.float()
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(orig_dtype)
