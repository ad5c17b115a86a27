"""SA-V / DAVIS-style J&F benchmark.

Counterpart of the JAX package's ``tools/sav_benchmark.py`` (after the
reference's sav_dataset/utils/sav_benchmark.py): per-object J (region IoU)
and F (boundary F-measure, boundaries matched within a dilated tolerance
band), the first and last annotated frames skipped as in the reference,
averaged into J&F.

The JAX module takes cv2's morphology when cv2 is installed: a 3x3 erosion
whose border counts as foreground and a dilation by cv2's elliptic
structuring element. The port computes the same in numpy and scipy (scipy
imported inside the function), cv2's ellipse rebuilt row by row, so its
results equal the JAX module's cv2 path without cv2.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np


def db_eval_iou(annotation: np.ndarray, segmentation: np.ndarray) -> float:
    """Region similarity J = |A & S| / |A | S| (empty-empty -> 1)."""
    a = annotation > 0
    s = segmentation > 0
    union = np.logical_or(a, s).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(a, s).sum() / union)


def _seg_to_boundary(seg: np.ndarray) -> np.ndarray:
    """Boundary pixels of a binary mask: the mask minus its 3x3 erosion, the
    image border counting as foreground (cv2.erode's default border)."""
    seg = seg > 0
    pad = np.pad(seg, 1, constant_values=True)
    h, w = seg.shape
    er = np.logical_and.reduce([pad[i:i + h, j:j + w] for i in range(3) for j in range(3)])
    return seg & ~er


def _cv2_ellipse(radius: int) -> np.ndarray:
    """cv2.getStructuringElement(MORPH_ELLIPSE, (2r+1, 2r+1)) as bool: row i
    holds the columns c +- round(c * sqrt(1 - (i - r)^2 / r^2)), rounded half
    to even as cv2's saturate_cast does."""
    n = 2 * radius + 1
    k = np.zeros((n, n), bool)
    for i in range(n):
        dy = i - radius
        dx = int(np.rint(radius * np.sqrt((radius * radius - dy * dy) / (radius * radius))))
        k[i, max(radius - dx, 0):min(radius + dx + 1, n)] = True
    return k


def db_eval_boundary(
    annotation: np.ndarray, segmentation: np.ndarray, bound_th: float = 0.008
) -> float:
    """Boundary F-measure with a bound_th * diagonal matching tolerance
    (DAVIS semantics as in sav_benchmark.py)."""
    from scipy import ndimage

    a = annotation > 0
    s = segmentation > 0
    fg_b = _seg_to_boundary(s)
    gt_b = _seg_to_boundary(a)

    bound_pix = max(
        1, int(np.ceil(bound_th * np.linalg.norm(annotation.shape)))
    )
    st = _cv2_ellipse(bound_pix)
    fg_dil = ndimage.binary_dilation(fg_b, st)
    gt_dil = ndimage.binary_dilation(gt_b, st)

    gt_match = gt_b & fg_dil
    fg_match = fg_b & gt_dil
    n_fg = fg_b.sum()
    n_gt = gt_b.sum()
    if n_fg == 0 and n_gt == 0:
        return 1.0
    if n_fg == 0 or n_gt == 0:
        return 0.0
    precision = fg_match.sum() / n_fg
    recall = gt_match.sum() / n_gt
    if precision + recall == 0:
        return 0.0
    return float(2 * precision * recall / (precision + recall))


def evaluate_object(
    gt_masks: Sequence[np.ndarray], pred_masks: Sequence[np.ndarray],
    skip_first_and_last: bool = True,
) -> Dict[str, float]:
    """Per-object J / F over a video (first and last frames skipped as in the
    reference's semi-supervised protocol)."""
    assert len(gt_masks) == len(pred_masks)
    idxs = range(len(gt_masks))
    if skip_first_and_last and len(gt_masks) > 2:
        idxs = range(1, len(gt_masks) - 1)
    js, fs = [], []
    for i in idxs:
        js.append(db_eval_iou(gt_masks[i], pred_masks[i]))
        fs.append(db_eval_boundary(gt_masks[i], pred_masks[i]))
    j = float(np.mean(js)) if js else 1.0
    f = float(np.mean(fs)) if fs else 1.0
    return {"J": j, "F": f, "J&F": (j + f) / 2}


def evaluate_videos(
    results: Dict[str, Dict[int, Tuple[List[np.ndarray], List[np.ndarray]]]],
    skip_first_and_last: bool = True,
) -> Dict[str, float]:
    """results: {video: {obj_id: (gt_list, pred_list)}} -> global means."""
    per_obj = []
    for video, objs in results.items():
        for obj_id, (gt, pred) in objs.items():
            per_obj.append(evaluate_object(gt, pred, skip_first_and_last))
    if not per_obj:
        return {"J": 0.0, "F": 0.0, "J&F": 0.0}
    return {
        "J": float(np.mean([r["J"] for r in per_obj])),
        "F": float(np.mean([r["F"] for r in per_obj])),
        "J&F": float(np.mean([r["J&F"] for r in per_obj])),
    }


def load_palettised_png_masks(mask_dir: str) -> Dict[int, Dict[int, np.ndarray]]:
    """Load DAVIS-style palettised PNGs: {frame_idx: {obj_id: mask}}."""
    from PIL import Image

    out: Dict[int, Dict[int, np.ndarray]] = {}
    for name in sorted(os.listdir(mask_dir)):
        if not name.endswith(".png"):
            continue
        frame_idx = int(os.path.splitext(name)[0])
        arr = np.asarray(Image.open(os.path.join(mask_dir, name)))
        per_obj = {}
        for obj_id in np.unique(arr):
            if obj_id == 0:
                continue
            per_obj[int(obj_id)] = arr == obj_id
        out[frame_idx] = per_obj
    return out
