"""SAM 2's hole filling of low-res mask logits, with scipy's labeller."""

from __future__ import annotations

import numpy as np
from scipy import ndimage

_EIGHT = np.ones((3, 3), bool)


def fill_holes(logits: np.ndarray, max_area: float) -> np.ndarray:
    """logits [H, W] float32 -> the same with every 8-connected component of
    background (logits <= 0) of at most ``max_area`` pixels set to 0.1
    (SAM 2's ``fill_holes_in_mask_scores``)."""
    if max_area <= 0:
        return logits
    labels, _ = ndimage.label(logits <= 0, structure=_EIGHT)
    areas = np.bincount(labels.ravel())
    hole = (labels > 0) & (areas[labels] <= max_area)
    return np.where(hole, np.float32(0.1), logits).astype(np.float32)
