"""Automatic-mask-generation utilities (numpy).

The port's own copy of the JAX package's ``utils/amg.py`` (itself SAM 2's
``sam2/utils/amg.py``): MaskData, RLE encode / decode, stability score,
point grids, crop boxes, uncrop helpers, batched mask -> box, a greedy NMS.
``remove_small_regions`` labels 8-connected regions with scipy (imported
when called) in place of cv2, an optional package the port does not need,
and breaks cv2's ties the way cv2 does.
"""

from __future__ import annotations

import math
from copy import deepcopy
from itertools import product
from typing import Any, Dict, Generator, List, Tuple

import numpy as np


class MaskData:
    """Dict of parallel arrays/lists with filter/cat (amg.py:18-90)."""

    def __init__(self, **kwargs):
        for v in kwargs.values():
            assert isinstance(v, (list, np.ndarray))
        self._stats = dict(kwargs)

    def __setitem__(self, key, item):
        self._stats[key] = item

    def __getitem__(self, key):
        return self._stats[key]

    def __delitem__(self, key):
        del self._stats[key]

    def items(self):
        return self._stats.items()

    def filter(self, keep: np.ndarray):
        for k, v in self._stats.items():
            if v is None:
                continue
            if isinstance(v, np.ndarray):
                self._stats[k] = v[keep]
            elif isinstance(v, list):
                if keep.dtype == bool:
                    self._stats[k] = [a for a, m in zip(v, keep) if m]
                else:
                    self._stats[k] = [v[i] for i in keep]

    def cat(self, other: "MaskData"):
        for k, v in other.items():
            if k not in self._stats or self._stats[k] is None:
                self._stats[k] = deepcopy(v)
            elif isinstance(v, np.ndarray):
                self._stats[k] = np.concatenate([self._stats[k], v], axis=0)
            elif isinstance(v, list):
                self._stats[k] = self._stats[k] + deepcopy(v)


def batch_iterator(batch_size: int, *args) -> Generator[List[Any], None, None]:
    assert len(args) > 0 and all(len(a) == len(args[0]) for a in args)
    n_batches = len(args[0]) // batch_size + int(len(args[0]) % batch_size != 0)
    for b in range(n_batches):
        yield [arg[b * batch_size : (b + 1) * batch_size] for arg in args]


def mask_to_rle(masks: np.ndarray) -> List[Dict[str, Any]]:
    """[B, H, W] binary -> uncompressed column-major RLEs (amg.py:131-158)."""
    b, h, w = masks.shape
    out = []
    for i in range(b):
        flat = masks[i].transpose().reshape(-1).astype(bool)  # column-major
        change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
        idx = np.concatenate([[0], change, [h * w]])
        counts = np.diff(idx).tolist()
        if flat[0]:
            counts = [0] + counts
        out.append({"size": [h, w], "counts": counts})
    return out


def rle_to_mask(rle: Dict[str, Any]) -> np.ndarray:
    """(amg.py:161-172): the runs alternate background / foreground,
    column-major; expanded with one np.repeat."""
    h, w = rle["size"]
    counts = np.asarray(rle["counts"], np.int64)
    mask = np.repeat(np.arange(len(counts)) % 2 == 1, counts)
    return mask.reshape(w, h).transpose()


def area_from_rle(rle: Dict[str, Any]) -> int:
    return sum(rle["counts"][1::2])


def calculate_stability_score(
    masks: np.ndarray, mask_threshold: float, threshold_offset: float
) -> np.ndarray:
    """(amg.py:180-198). The pixel axes are flattened by their size, not by
    -1, which numpy cannot resolve for zero masks (no mask survived the IoU
    filter)."""
    flat = masks.reshape(*masks.shape[:-2], masks.shape[-2] * masks.shape[-1])
    intersections = (flat > (mask_threshold + threshold_offset)).sum(-1)
    unions = (flat > (mask_threshold - threshold_offset)).sum(-1)
    return intersections / np.maximum(unions, 1)


def build_point_grid(n_per_side: int) -> np.ndarray:
    """(amg.py:201-208)"""
    offset = 1 / (2 * n_per_side)
    points_one_side = np.linspace(offset, 1 - offset, n_per_side)
    px = np.tile(points_one_side[None, :], (n_per_side, 1))
    py = np.tile(points_one_side[:, None], (1, n_per_side))
    return np.stack([px, py], axis=-1).reshape(-1, 2)


def build_all_layer_point_grids(
    n_per_side: int, n_layers: int, scale_per_layer: int
) -> List[np.ndarray]:
    return [
        build_point_grid(int(n_per_side / (scale_per_layer ** i)))
        for i in range(n_layers + 1)
    ]


def generate_crop_boxes(
    im_size: Tuple[int, int], n_layers: int, overlap_ratio: float
) -> Tuple[List[List[int]], List[int]]:
    """(amg.py:222-256)"""
    crop_boxes, layer_idxs = [], []
    im_h, im_w = im_size
    short_side = min(im_h, im_w)
    crop_boxes.append([0, 0, im_w, im_h])
    layer_idxs.append(0)

    def crop_len(orig_len, n_crops, overlap):
        return int(math.ceil((overlap * (n_crops - 1) + orig_len) / n_crops))

    for i_layer in range(n_layers):
        n_crops_per_side = 2 ** (i_layer + 1)
        overlap = int(overlap_ratio * short_side * (2 / n_crops_per_side))
        crop_w = crop_len(im_w, n_crops_per_side, overlap)
        crop_h = crop_len(im_h, n_crops_per_side, overlap)
        crop_box_x0 = [int((crop_w - overlap) * i) for i in range(n_crops_per_side)]
        crop_box_y0 = [int((crop_h - overlap) * i) for i in range(n_crops_per_side)]
        for x0, y0 in product(crop_box_x0, crop_box_y0):
            box = [x0, y0, min(x0 + crop_w, im_w), min(y0 + crop_h, im_h)]
            crop_boxes.append(box)
            layer_idxs.append(i_layer + 1)
    return crop_boxes, layer_idxs


def uncrop_boxes_xyxy(boxes: np.ndarray, crop_box: List[int]) -> np.ndarray:
    x0, y0 = crop_box[0], crop_box[1]
    return boxes + np.asarray([[x0, y0, x0, y0]], boxes.dtype)


def uncrop_points(points: np.ndarray, crop_box: List[int]) -> np.ndarray:
    x0, y0 = crop_box[0], crop_box[1]
    return points + np.asarray([[x0, y0]], points.dtype)


def uncrop_masks(
    masks: np.ndarray, crop_box: List[int], orig_h: int, orig_w: int
) -> np.ndarray:
    x0, y0, x1, y1 = crop_box
    if x0 == 0 and y0 == 0 and x1 == orig_w and y1 == orig_h:
        return masks
    pad = ((0, 0), (y0, orig_h - y1), (x0, orig_w - x1))
    return np.pad(masks, pad)


def is_box_near_crop_edge(
    boxes: np.ndarray, crop_box: List[int], orig_box: List[int], atol: float = 20.0
) -> np.ndarray:
    """(amg.py:91-106)"""
    crop = np.asarray(crop_box, np.float32)
    orig = np.asarray(orig_box, np.float32)
    boxes = uncrop_boxes_xyxy(boxes, crop_box).astype(np.float32)
    near_crop = np.isclose(boxes, crop[None], atol=atol, rtol=0)
    near_image = np.isclose(boxes, orig[None], atol=atol, rtol=0)
    near_crop = near_crop & ~near_image
    return near_crop.any(axis=1)


def box_xyxy_to_xywh(box: np.ndarray) -> np.ndarray:
    out = np.array(box, dtype=box.dtype if hasattr(box, "dtype") else None)
    out = out.copy()
    out[2] = out[2] - out[0]
    out[3] = out[3] - out[1]
    return out


def batched_mask_to_box(masks: np.ndarray) -> np.ndarray:
    """[..., H, W] -> xyxy [..., 4]; empty masks -> zeros (SAM's inclusive
    edges)."""
    from det_sam2_tpu_torch.utils.misc import mask_to_box_np

    return mask_to_box_np(masks)


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes [N,4] x [M,4] -> [N,M]."""
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(
        a[:, 3] - a[:, 1], 0, None
    )
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
        b[:, 3] - b[:, 1], 0, None
    )
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float) -> np.ndarray:
    """Greedy NMS -> kept indices (replaces torchvision batched_nms)."""
    order = np.argsort(-scores)
    keep = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(i)
        ious = box_iou(boxes[i : i + 1], boxes)[0]
        suppressed |= ious > iou_threshold
        suppressed[i] = True
    return np.asarray(keep, np.int64)


def _first_in_cv2_order(labels: np.ndarray, candidates: np.ndarray) -> int:
    """The candidate label that cv2's connectedComponents numbers first.
    cv2 (8-connectivity) scans 2x2 blocks, row pairs first: each component
    is numbered at the first block that holds a pixel of it (two components
    never share a block: its pixels are all 8-neighbours)."""
    ys, xs = np.nonzero(np.isin(labels, candidates))
    block = (ys // 2) * ((labels.shape[1] + 1) // 2) + xs // 2
    first = np.full(int(candidates.max()) + 1, np.iinfo(np.int64).max)
    np.minimum.at(first, labels[ys, xs], block)
    return int(candidates[np.argmin(first[candidates])])


def remove_small_regions(
    mask: np.ndarray, area_thresh: float, mode: str
) -> Tuple[np.ndarray, bool]:
    """Remove small connected holes or islands (SAM's amg.py:292-315, which
    labels with cv2.connectedComponentsWithStats). With no island large
    enough, the largest is kept; between islands of equal size the one cv2
    numbers first."""
    from det_sam2_tpu_torch.ops.connected_components import connected_components_np

    assert mode in ("holes", "islands")
    correct_holes = mode == "holes"
    working_mask = correct_holes ^ np.asarray(mask, bool)
    regions, _ = connected_components_np(working_mask)
    n = int(regions.max())
    sizes = np.bincount(regions.ravel(), minlength=n + 1)[1:]
    small_regions = np.flatnonzero(sizes < area_thresh) + 1
    if len(small_regions) == 0:
        return mask, False
    fill = np.zeros(n + 1, bool)  # label -> the region is True in the result
    fill[0] = True
    fill[small_regions] = True
    if not correct_holes:
        fill = ~fill  # the islands at least area_thresh large
        if not fill.any():
            largest = np.flatnonzero(sizes == sizes.max()) + 1
            fill[_first_in_cv2_order(regions, largest)] = True
    return fill[regions], True


def coco_encode_rle(uncompressed_rle: Dict[str, Any]) -> Dict[str, Any]:
    try:
        from pycocotools import mask as mask_utils  # pragma: no cover
    except ImportError as e:
        raise ImportError("coco_encode_rle requires pycocotools") from e
    h, w = uncompressed_rle["size"]
    rle = mask_utils.frPyObjects(uncompressed_rle, h, w)
    rle["counts"] = rle["counts"].decode("utf-8")
    return rle
