"""SAM2ImagePredictor: single-image promptable segmentation.

Counterpart of the JAX package's ``image_predictor.py``, with the same API:
set_image caches the image's features (the no-memory embedding is added in
``SAM2Engine.predict_step``), set_image_batch encodes several images in
batched encoder calls, predict / predict_batch encode point, box and mask
prompts and return numpy masks at the original image resolution. Runs on
its engine's device (CUDA unless the engine was built on the CPU).

The resize to the original resolution runs on the engine's device and
gives the bits of the JAX package's host ``resize_masks_np``, which is
cv2.resize (``ops.mask_resize``: the hand-written kernel on CUDA, the numpy
rebuild on the CPU); a call reads its outputs back once; the optional
hole / sprinkle cleanup labels the low-res logits on the host
(``fill_holes_and_sprinkles_np``), which takes one read-back more.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from det_sam2_tpu_torch.ops.connected_components import fill_holes_and_sprinkles_np
from det_sam2_tpu_torch.ops.mask_resize import resize_masks_cv2
from det_sam2_tpu_torch.track import SAM2Engine
from det_sam2_tpu_torch.utils.misc import prepare_frame, to_host


class SAM2ImagePredictor:
    def __init__(
        self,
        engine: SAM2Engine,
        mask_threshold: float = 0.0,
        max_hole_area: float = 0.0,
        max_sprinkle_area: float = 0.0,
    ):
        self.engine = engine
        self.cfg = engine.cfg
        self.image_size = engine.cfg.image_size
        self.mask_threshold = mask_threshold
        self.max_hole_area = max_hole_area
        self.max_sprinkle_area = max_sprinkle_area
        self.reset_predictor()

    def reset_predictor(self) -> None:
        self._features = None
        self._orig_hw: Optional[Tuple[int, int]] = None
        self._is_image_set = False
        self._is_batch = False
        self._batch_features = None
        self._orig_hw_list: List[Tuple[int, int]] = []

    # ------------------------------------------------------------------

    def set_image(self, image: np.ndarray) -> None:
        """image: RGB uint8 [H, W, 3]."""
        self.reset_predictor()
        self._orig_hw = image.shape[:2]
        frame = prepare_frame(image, self.image_size)
        self._features = self.engine.encode_image(frame[None])
        self._is_image_set = True

    def set_image_batch(
        self, image_list: List[np.ndarray], max_chunk: int = 8
    ) -> None:
        """Embed several images in batched encoder calls of up to max_chunk
        images (encoder activations grow with the batch; the features are
        small and concatenate cheaply). select_batch_image pins one of them
        for the single-image API."""
        self.reset_predictor()
        self._orig_hw_list = [im.shape[:2] for im in image_list]
        frames = np.stack(
            [prepare_frame(im, self.image_size) for im in image_list]
        )
        chunks = [
            self.engine.encode_image(frames[i : i + max_chunk])
            for i in range(0, len(frames), max_chunk)
        ]
        self._batch_features = tuple(
            torch.cat([c[k] for c in chunks], 0) for k in range(len(chunks[0]))
        )
        self._is_batch = True
        self._is_image_set = True

    def select_batch_image(self, index: int) -> None:
        """Pin image `index` of a set_image_batch() call so the single-image
        API (predict / same-image predict_batch) runs against it."""
        if self._batch_features is None:
            raise RuntimeError("call set_image_batch before select_batch_image")
        self._features = tuple(
            f[index : index + 1] for f in self._batch_features
        )
        self._orig_hw = self._orig_hw_list[index]

    def _transform_coords(self, coords: np.ndarray, normalize: bool) -> np.ndarray:
        """To model pixels; normalize=True divides by the original size first
        (normalize_coords=False means the inputs are already in [0, 1])."""
        coords = np.asarray(coords, np.float32)
        if normalize:
            h, w = self._orig_hw
            coords = coords / np.asarray([w, h], np.float32)
        return coords * self.image_size

    def predict(
        self,
        point_coords: Optional[np.ndarray] = None,
        point_labels: Optional[np.ndarray] = None,
        box: Optional[np.ndarray] = None,
        mask_input: Optional[np.ndarray] = None,
        multimask_output: bool = True,
        return_logits: bool = False,
        normalize_coords: bool = True,
    ):
        """Returns (masks [M, H, W], iou_predictions [M], low_res [M, s4,
        s4]), with a leading prompt-row axis when several box rows are given.
        Coordinates are in original-image pixels when normalize_coords."""
        if not self._is_image_set:
            raise RuntimeError("call set_image before predict")
        if self._features is None:
            raise RuntimeError(
                "predict() after set_image_batch requires select_batch_image"
                " to pin one image (or use predict_batch)"
            )
        coords, labels = self._prepare_prompts(
            point_coords, point_labels, box, normalize_coords
        )  # [B, N, 2] / [B, N]: B > 1 for batched box prompts
        mi = None
        if mask_input is not None:
            mi = np.asarray(mask_input, np.float32)
            if mi.ndim == 3:
                mi = mi[None]
        out = self.engine.predict_step(
            self._features, coords, labels,
            mask_input=mi, multimask=multimask_output,
        )
        multimasks, ious = out["multimasks"], out["ious"]
        if coords.shape[0] == 1:  # a single prompt row: no batch axis
            multimasks, ious = multimasks[0], ious[0]
        return self._postprocess(multimasks, ious, return_logits)

    def predict_batch(
        self,
        point_coords_batch=None,  # [B, P, 2] (same image) or list per image
        point_labels_batch=None,  # [B, P] or list per image
        mask_input_batch=None,  # [B, 1, s4, s4] logits or list per image
        multimask_output: bool = True,
        return_logits: bool = False,
        normalize_coords: bool = True,
        box_batch=None,  # list per image, or [B, 4] in same-image mode
    ):
        """Two modes:

        * after set_image_batch(): per-image prompt lists -> lists of
          (masks, ious, low_res), one entry per image;
        * after set_image() / select_batch_image(): a prompt batch against
          the SAME image as one decoder call (the AMG's hot path).
        """
        if self._is_batch and (
            point_coords_batch is None
            or isinstance(point_coords_batch, (list, tuple))
        ):
            return self._predict_image_batch(
                point_coords_batch, point_labels_batch, box_batch,
                mask_input_batch, multimask_output, return_logits,
                normalize_coords,
            )
        if not self._is_image_set or self._features is None:
            raise RuntimeError(
                "call set_image (or set_image_batch + select_batch_image) "
                "before predict_batch with a same-image prompt batch"
            )
        coords, labels = self._prepare_prompts(
            point_coords_batch, point_labels_batch, box_batch,
            normalize_coords,
        )  # box_batch ([B, 4]) joins each row ahead of its points
        out = self.engine.predict_step(
            self._features, coords, labels,
            mask_input=mask_input_batch,
            multimask=multimask_output,
        )
        return self._postprocess(out["multimasks"], out["ious"], return_logits)

    def _predict_image_batch(
        self, point_coords_batch, point_labels_batch, box_batch,
        mask_input_batch, multimask_output, return_logits, normalize_coords,
    ):
        """Per-image prediction against a set_image_batch() embedding: the
        encode was batched; prompts (which differ per image) decode per image
        against the sliced features."""
        n = len(self._orig_hw_list)

        def pick(batch, i):
            return None if batch is None else batch[i]

        all_masks, all_ious, all_low = [], [], []
        for i in range(n):
            self.select_batch_image(i)
            masks, ious, low_res = self.predict(
                point_coords=pick(point_coords_batch, i),
                point_labels=pick(point_labels_batch, i),
                box=pick(box_batch, i),
                mask_input=pick(mask_input_batch, i),
                multimask_output=multimask_output,
                return_logits=return_logits,
                normalize_coords=normalize_coords,
            )
            all_masks.append(masks)
            all_ious.append(ious)
            all_low.append(low_res)
        return all_masks, all_ious, all_low

    def _prepare_prompts(self, point_coords, point_labels, box, normalize):
        """Batched prompt rows [B, N, 2] / [B, N]: a Bx4 `box` becomes B rows
        each starting with the [2, 3]-labelled corner pair, followed by the
        same row's points."""
        box_c = box_l = None
        if box is not None:
            b = np.asarray(box, np.float32).reshape(-1, 2, 2)  # [B, 2, 2]
            box_c = self._transform_coords(b, normalize)
            box_l = np.tile(np.asarray([[2, 3]], np.int32), (b.shape[0], 1))
        pt_c = pt_l = None
        if point_coords is not None:
            if point_labels is None:
                raise ValueError("point_coords need point_labels")
            pt_c = self._transform_coords(
                np.asarray(point_coords, np.float32), normalize
            )
            pt_l = np.asarray(point_labels, np.int32)
            if pt_c.ndim == 2:
                pt_c, pt_l = pt_c[None], pt_l[None]
        if box_c is not None and pt_c is not None:
            if box_c.shape[0] != pt_c.shape[0]:
                raise ValueError(
                    f"box batch {box_c.shape[0]} != point batch "
                    f"{pt_c.shape[0]} (each box row pairs with a point row)"
                )
            return (np.concatenate([box_c, pt_c], axis=1),
                    np.concatenate([box_l, pt_l], axis=1))
        if box_c is not None:
            return box_c, box_l
        if pt_c is not None:
            return pt_c, pt_l
        return (np.zeros((1, 1, 2), np.float32),
                -np.ones((1, 1), np.int32))

    def _postprocess(self, low_res: torch.Tensor, ious: torch.Tensor,
                     return_logits: bool):
        """(masks at the original resolution, ious, low-res logits) in numpy,
        read back in one synchronisation (two with the cleanup, which needs
        the low-res logits on the host). The optional hole / sprinkle
        cleanup runs on the LOW-RES logits before the resize, as SAM 2 does:
        the areas are low-res pixels and the +-10 patches are smoothed by
        the bilinear upscale; the low-res logits returned are the raw ones.
        The masks of all prompts resize as one cv2 image of B * M channels,
        128 at a time, as the JAX package resizes them."""
        if self.max_hole_area > 0 or self.max_sprinkle_area > 0:
            (low_np,) = to_host(low_res)
            filled = torch.from_numpy(fill_holes_and_sprinkles_np(
                low_np, self.mask_threshold, self.max_hole_area,
                self.max_sprinkle_area)).to(low_res.device)
            masks, ious_np = to_host(resize_masks_cv2(filled, self._orig_hw), ious)
        else:
            masks, ious_np, low_np = to_host(
                resize_masks_cv2(low_res, self._orig_hw), ious, low_res)
        if not return_logits:
            masks = masks > self.mask_threshold
        return masks, ious_np, low_np
