"""Hole filling on low-res mask logits, on the device; and a host labeller.

Counterpart of the JAX package's ``fill_holes_in_mask_scores_jax`` with its
stencil path (``small_components_jax`` / ``_small_via_stencil``). Plain torch:
this was never a Pallas kernel. A fixed ceil(max_area) rounds of 8-neighbour
min-label propagation (one 3x3 min-pool each) and a bounded-displacement
stencil give the exact mask of components with area <= max_area; there is
no data-dependent loop and no host synchronisation.

The host functions at the end label components with scipy (imported when
called): the image predictor's hole / sprinkle cleanup, whose areas (64
pixels for the AMG) are too large for the stencil's window, and the AMG's
small-region pass.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
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


# ---------------------------------------------------------------------------
# host labeller (numpy / scipy): the image predictor's cleanup and the AMG
# ---------------------------------------------------------------------------


def connected_components_np(masks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """masks [..., H, W] (nonzero = foreground) -> (labels int32, areas
    int64), both [..., H, W]: 8-connected components of each [H, W] plane,
    labels > 0 on foreground (numbered across planes), areas the pixel
    count of each pixel's component (0 on background). The counterpart of
    the JAX package's ``get_connected_components_np`` (a C++ union-find or
    cv2 there, scipy here; label numbers differ, areas do not)."""
    from scipy import ndimage

    m = np.asarray(masks) != 0
    lead, (h, w) = m.shape[:-2], m.shape[-2:]
    structure = np.zeros((3, 3, 3), bool)
    structure[1] = True  # 8-neighbours within a plane, none across planes
    labels, _ = ndimage.label(m.reshape(-1, h, w), structure=structure)
    sizes = np.bincount(labels.ravel())
    sizes[0] = 0
    return (labels.astype(np.int32).reshape(*lead, h, w),
            sizes[labels].reshape(*lead, h, w))


def fill_holes_and_sprinkles_np(
    masks: np.ndarray, threshold: float, max_hole_area: float,
    max_sprinkle_area: float,
) -> np.ndarray:
    """SAM 2's postprocess_masks cleanup of mask logits [..., H, W] on the
    host: background components (<= threshold) of area <= max_hole_area
    become threshold + 10, foreground components of area <=
    max_sprinkle_area become threshold - 10. Both passes label the original
    mask (the sprinkle pass does not see the filled holes); the writes apply
    in that order."""
    orig = np.asarray(masks, np.float32)
    out = orig
    if max_hole_area > 0:
        labels, areas = connected_components_np(orig <= threshold)
        out = np.where((labels > 0) & (areas <= max_hole_area), threshold + 10.0, out)
    if max_sprinkle_area > 0:
        labels, areas = connected_components_np(orig > threshold)
        out = np.where((labels > 0) & (areas <= max_sprinkle_area), threshold - 10.0, out)
    return out.astype(np.float32)
