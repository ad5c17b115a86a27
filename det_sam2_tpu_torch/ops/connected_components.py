"""Hole filling on low-res mask logits, on the device.

Counterpart of the JAX package's ``fill_holes_in_mask_scores_jax`` with its
stencil path (``small_components_jax`` / ``_small_via_stencil``). Plain torch:
this was never a Pallas kernel. A fixed ceil(max_area) rounds of 8-neighbour
min-label propagation (one 3x3 min-pool each) and a bounded-displacement
stencil give the exact mask of components with area <= max_area; there is
no data-dependent loop and no host synchronisation.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_BIG = torch.finfo(torch.float32).max


def _propagate_once(labels: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """One 8-neighbour min step: a 3x3 min-pool (out-of-bounds neighbours
    are the identity); background keeps the sentinel."""
    lead = labels.shape[:-2]
    x = labels.reshape(-1, 1, *labels.shape[-2:])
    out = -F.max_pool2d(-x, 3, 1, 1)
    return torch.where(fg, out.reshape(*lead, *labels.shape[-2:]), _BIG)


def _offset_grid(a: int, w: int, device):
    """Over the (a+1) x (2a+1) window of offsets (dr, dc) = (i, j - a): the
    flat-index offset dr*w + dc, and which offsets count (dc >= 0 when
    dr == 0)."""
    dr = torch.arange(a + 1, device=device)[:, None]
    dc = torch.arange(-a, a + 1, device=device)[None, :]
    return (dr * w + dc).float(), ~((dr == 0) & (dc < 0))


def _small_via_stencil(fg, labels, changed, max_area: float, a: int):
    """Exact per-group area test: after `a` rounds every pixel holding label
    L = r0*w + c0 lies at (r0 + dr, c0 + dc) with dr in [0, a], dc in
    [-a, a] (dc >= 0 when dr == 0), so group areas, and whether a group
    holds a pixel that still changes, are sums over that fixed window. The
    window is one strided view (unfold) of the padded maps, so the whole
    test is a handful of tensor ops."""
    h, w = fg.shape[-2:]
    dev = labels.device
    iota = torch.arange(h * w, dtype=torch.float32, device=dev).reshape(h, w)
    offs, counted = _offset_grid(a, w, dev)  # [a+1, 2a+1]

    def windows(x, pad, value):  # [..., h, w, a+1, 2a+1]
        return F.pad(x, pad, value=value).unfold(-2, a + 1, 1).unfold(-2, 2 * a + 1, 1)

    # pixel (r+dr, c+dc) holds label r*w + c
    eq = (windows(labels, (a, a, 0, a), _BIG) == iota[..., None, None]) & counted
    area = eq.sum((-2, -1))
    grp_changed = (eq & windows(changed, (a, a, 0, a), False)).any(-1).any(-1)
    small2d = (area > 0) & (area <= max_area) & ~grp_changed

    # back-map: pixel (r, c) holding label (r-dr)*w + (c-dc) reads small2d
    # at that root; window index (i, j) = (a - dr, a - dc)
    roots = iota[..., None, None] - offs.flip(0, 1)
    hit = (labels[..., None, None] == roots) & windows(small2d, (a, a, a, 0), False)
    return (hit & counted.flip(0, 1)).any(-1).any(-1) & fg


def small_components(masks: torch.Tensor, max_area: float) -> torch.Tensor:
    """Mask of pixels in 8-connected components of `masks != 0` with area
    <= max_area, for masks [..., H, W].

    ceil(max_area) propagation rounds are exact: a component of area <= A
    has diameter < A, so its label group converges to the component; a
    larger one may split into groups, but a group passing the area test
    either still changes in one more round (excluded) or is a min-rooted
    radius-A ball of more than A pixels (excluded)."""
    assert max_area > 0, max_area
    a = max(int(math.ceil(max_area)), 1)
    fg = masks != 0
    h, w = fg.shape[-2:]
    iota = torch.arange(h * w, dtype=torch.float32, device=masks.device)
    labels = torch.where(fg, iota.reshape(h, w), _BIG)
    for _ in range(a):
        labels = _propagate_once(labels, fg)
    changed = (_propagate_once(labels, fg) != labels) & fg
    return _small_via_stencil(fg, labels, changed, max_area, a)


def fill_holes_in_mask_scores(mask: torch.Tensor, max_area: float) -> torch.Tensor:
    """Background components (logits <= 0) with area <= max_area become 0.1
    (foreground) in mask logits [..., H, W]."""
    is_hole = small_components(mask <= 0, max_area)
    return torch.where(is_hole, torch.tensor(0.1, dtype=mask.dtype,
                                             device=mask.device), mask)
