"""Interactive-prompt simulation: GT boxes, box noising, correction clicks.

Counterpart of the JAX package's ``training/samplers.py`` (and its
``mask_to_box``, from ``training/sam2_train.py``). Each sampler draws its
uniform noise from an explicit ``torch.Generator`` and hands it to an inner
form that takes the noise as an argument, so a test can give both packages
the same numbers. The host "center" click sampler, which the JAX package
computes with cv2's precise distance transform, takes scipy's exact
Euclidean transform here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from det_sam2_tpu_torch.modeling.layers import uniform


def mask_to_box(masks: torch.Tensor) -> torch.Tensor:
    """GT masks [B, H, W] (bool / float) -> xyxy boxes [B, 4] fp32 in
    pixels; an empty mask gives (0, 0, 0, 0)."""
    b, h, w = masks.shape
    pos = masks > 0
    dev = masks.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
    big = torch.tensor(1e9, device=dev)
    x_min = torch.where(pos, xs, big).amin((1, 2))
    y_min = torch.where(pos, ys, big).amin((1, 2))
    x_max = torch.where(pos, xs, -big).amax((1, 2))
    y_max = torch.where(pos, ys, -big).amax((1, 2))
    box = torch.stack([x_min, y_min, x_max, y_max], -1)
    return torch.where(pos.any((1, 2))[:, None], box, torch.zeros_like(box))


def box_points_from_uniform(u: Optional[torch.Tensor], masks: torch.Tensor,
                            noise: float = 0.1, noise_bound: int = 20):
    """``sample_box_points`` given its noise u [B, 4] U[0, 1) (unused when
    noise is 0) -> (coords [B, 2, 2], labels [B, 2] = 2, 3)."""
    b, h, w = masks.shape
    box = mask_to_box(masks)
    labels = torch.tensor([2, 3], dtype=torch.int32, device=masks.device).expand(b, 2)
    if noise > 0.0:
        bw = box[:, 2] - box[:, 0]
        bh = box[:, 3] - box[:, 1]
        max_dx = torch.clamp(bw * noise, max=float(noise_bound))
        max_dy = torch.clamp(bh * noise, max=float(noise_bound))
        eps = (2.0 * u - 1.0) * torch.stack([max_dx, max_dy, max_dx, max_dy], -1)
        bounds = torch.tensor([w - 1, h - 1, w - 1, h - 1], dtype=torch.float32,
                              device=masks.device)
        box = torch.minimum(torch.clamp(box + eps, min=0.0), bounds)
    return box.reshape(b, 2, 2), labels


def sample_box_points(generator: torch.Generator, masks: torch.Tensor,
                      noise: float = 0.1, noise_bound: int = 20):
    """GT masks [B, H, W] -> noised corner prompts ([B, 2, 2] coords,
    [B, 2] labels 2/3); the noise moves each corner by up to `noise` of the
    box side, capped at noise_bound pixels."""
    u = None
    if noise > 0.0:
        u = uniform((masks.shape[0], 4), generator, masks.device)
    return box_points_from_uniform(u, masks, noise, noise_bound)


def error_points_from_uniform(u: torch.Tensor, gt_masks: torch.Tensor,
                              pred_masks: Optional[torch.Tensor]):
    """``sample_random_points_from_errors`` given its noise u
    [B, num_pt, H, W, 2] U[0, 1): the random-argmax trick over the
    false-positive (label 0) and false-negative (label 1) pixels; when the
    prediction is all correct, a background pixel (label 0).
    -> (coords [B, num_pt, 2] fp32 xy, labels [B, num_pt] int32)."""
    gt = gt_masks > 0
    pred = torch.zeros_like(gt) if pred_masks is None else pred_masks > 0
    b, h, w = gt.shape
    num_pt = u.shape[1]
    fp = ~gt & pred
    fn = gt & ~pred
    all_correct = (gt == pred).reshape(b, -1).all(1)[:, None, None]
    chan0 = (fp | (all_correct & ~gt)).to(u.dtype)
    chan1 = fn.to(u.dtype)
    weights = torch.stack([chan0, chan1], -1).reshape(b, 1, h, w, 2)
    idx = (u * weights).reshape(b, num_pt, -1).argmax(2)
    labels = (idx % 2).to(torch.int32)
    pix = idx // 2
    x = (pix % w).float()
    y = (pix // w).float()
    return torch.stack([x, y], 2), labels


def sample_random_points_from_errors(generator: torch.Generator,
                                     gt_masks: torch.Tensor,
                                     pred_masks: Optional[torch.Tensor],
                                     num_pt: int = 1):
    """Correction clicks drawn uniformly from the error regions of
    pred_masks against gt_masks ([B, H, W] each; pred None = from the GT)."""
    b, h, w = gt_masks.shape
    u = uniform((b, num_pt, h, w, 2), generator, gt_masks.device)
    return error_points_from_uniform(u, gt_masks, pred_masks)


def _edt32(mask: np.ndarray) -> np.ndarray:
    """cv2.distanceTransform(mask, DIST_L2, 0), the precise transform: each
    pixel's Euclidean distance to the nearest zero pixel, the correctly
    rounded float32 square root of the exact squared distance. cv2's own
    (its IPP path) is one float32 ulp off at a few pixels of some masks; the
    order of distinct distances, and so the sampled clicks, are the same."""
    from scipy import ndimage

    if not mask.any():
        return np.zeros(mask.shape, np.float32)
    _, (iy, ix) = ndimage.distance_transform_edt(mask, return_indices=True)
    yy, xx = np.indices(mask.shape)
    d2 = (yy - iy) ** 2 + (xx - ix) ** 2
    return np.sqrt(d2.astype(np.float32))


def sample_one_point_from_error_center_np(
    gt_masks: np.ndarray, pred_masks: Optional[np.ndarray], padding: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """RITM centre-click sampling (host numpy): one click a row at the pixel
    deepest inside the larger error region, positive for a false negative
    -> (points [B, 1, 2] fp32 xy, labels [B, 1] int32). padding: the image
    border counts as outside the error regions (sam2_utils.py:255-311)."""
    gt = np.asarray(gt_masks) > 0
    pred = np.zeros_like(gt) if pred_masks is None else np.asarray(pred_masks) > 0
    b, h, w = gt.shape
    fp = ~gt & pred
    fn = gt & ~pred
    points = np.zeros((b, 1, 2), np.float32)
    labels = np.ones((b, 1), np.int32)
    for i in range(b):
        fn_m, fp_m = fn[i], fp[i]
        if padding:
            fn_m = np.pad(fn_m, 1)
            fp_m = np.pad(fp_m, 1)
        fn_dt = _edt32(fn_m)
        fp_dt = _edt32(fp_m)
        if padding:
            fn_dt = fn_dt[1:-1, 1:-1]
            fp_dt = fp_dt[1:-1, 1:-1]
        fn_idx = int(np.argmax(fn_dt))
        fp_idx = int(np.argmax(fp_dt))
        is_pos = fn_dt.reshape(-1)[fn_idx] > fp_dt.reshape(-1)[fp_idx]
        idx = fn_idx if is_pos else fp_idx
        points[i, 0] = (idx % w, idx // w)
        labels[i, 0] = int(is_pos)
    return points, labels


def get_next_point(generator: torch.Generator, gt_masks: torch.Tensor,
                   pred_masks: Optional[torch.Tensor], method: str = "uniform"):
    """The next correction click (sam2_utils.py:313-321); the in-graph
    sampler is the uniform one, as in the JAX package."""
    if method == "uniform":
        return sample_random_points_from_errors(generator, gt_masks, pred_masks)
    raise ValueError(f"unknown in-graph sampling method {method}")
