"""SAM2AutomaticMaskGenerator: grid-prompted whole-image segmentation.

Counterpart of the JAX package's ``automatic_mask_generator.py`` (SAM 2's
SAM2AutomaticMaskGenerator), with the same defaults: point grids x crop
boxes -> batched prediction -> IoU / stability filtering -> NMS -> optional
small-region removal, returning COCO-style mask records. Host numpy around
the image predictor's batched ``predict_batch``; the crops of one image are
encoded in one ``set_image_batch``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from det_sam2_tpu_torch.image_predictor import SAM2ImagePredictor
from det_sam2_tpu_torch.utils.amg import (
    MaskData,
    area_from_rle,
    batch_iterator,
    batched_mask_to_box,
    box_xyxy_to_xywh,
    build_all_layer_point_grids,
    calculate_stability_score,
    generate_crop_boxes,
    is_box_near_crop_edge,
    mask_to_rle,
    nms,
    remove_small_regions,
    rle_to_mask,
    uncrop_boxes_xyxy,
    uncrop_masks,
    uncrop_points,
)


class SAM2AutomaticMaskGenerator:
    def __init__(
        self,
        predictor: SAM2ImagePredictor,
        points_per_side: Optional[int] = 32,
        points_per_batch: int = 64,
        pred_iou_thresh: float = 0.8,
        stability_score_thresh: float = 0.95,
        stability_score_offset: float = 1.0,
        mask_threshold: float = 0.0,
        box_nms_thresh: float = 0.7,
        crop_n_layers: int = 0,
        crop_nms_thresh: float = 0.7,
        crop_overlap_ratio: float = 512 / 1500,
        crop_n_points_downscale_factor: int = 1,
        point_grids: Optional[List[np.ndarray]] = None,
        min_mask_region_area: int = 0,
        output_mode: str = "binary_mask",
        use_m2m: bool = False,
        multimask_output: bool = True,
    ):
        assert (points_per_side is None) != (point_grids is None), (
            "exactly one of points_per_side or point_grids must be provided"
        )
        if point_grids is None:
            point_grids = build_all_layer_point_grids(
                points_per_side, crop_n_layers, crop_n_points_downscale_factor
            )
        assert output_mode in ("binary_mask", "uncompressed_rle", "coco_rle")
        self.predictor = predictor
        self.point_grids = point_grids
        self.points_per_batch = points_per_batch
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_score_thresh = stability_score_thresh
        self.stability_score_offset = stability_score_offset
        self.mask_threshold = mask_threshold
        self.box_nms_thresh = box_nms_thresh
        self.crop_n_layers = crop_n_layers
        self.crop_nms_thresh = crop_nms_thresh
        self.crop_overlap_ratio = crop_overlap_ratio
        self.min_mask_region_area = min_mask_region_area
        self.output_mode = output_mode
        self.use_m2m = use_m2m
        self.multimask_output = multimask_output
        # None -> min_mask_region_area (SAM 2's behaviour); set to 0.0 to
        # disable the per-predict low-res fill while keeping the host
        # small-region postprocess
        self.predictor_fill_area: Optional[float] = None

    # ------------------------------------------------------------------

    def generate(self, image: np.ndarray) -> List[Dict[str, Any]]:
        """image: RGB uint8 [H, W, 3] -> list of mask records
        (SAM 2's generate)."""
        # SAM 2 constructs its OWN predictor with hole/sprinkle
        # areas = min_mask_region_area so every _predict fills low-res
        # holes (automatic_mask_generator.py:116-119); ours is caller-
        # supplied and possibly shared, so apply the areas only for the
        # duration of this generate() instead of mutating it permanently.
        # predictor_fill_area overrides the per-predict fill size without
        # touching the host postprocess_small_regions pass (0 disables —
        # used to compare against a SAM 2 whose CUDA CC extension no-ops).
        fill = self.predictor_fill_area
        if fill is None:
            fill = float(self.min_mask_region_area)
        saved = (self.predictor.max_hole_area,
                 self.predictor.max_sprinkle_area)
        if fill > 0:
            self.predictor.max_hole_area = fill
            self.predictor.max_sprinkle_area = fill
        try:
            mask_data = self._generate_masks(image)
        finally:
            (self.predictor.max_hole_area,
             self.predictor.max_sprinkle_area) = saved
        if self.min_mask_region_area > 0:
            mask_data = self.postprocess_small_regions(
                mask_data, self.min_mask_region_area,
                max(self.box_nms_thresh, self.crop_nms_thresh),
            )
        if self.output_mode == "coco_rle":
            from det_sam2_tpu_torch.utils.amg import coco_encode_rle

            mask_data["segmentations"] = [
                coco_encode_rle(r) for r in mask_data["rles"]
            ]
        elif self.output_mode == "binary_mask":
            mask_data["segmentations"] = [
                rle_to_mask(r) for r in mask_data["rles"]
            ]
        else:
            mask_data["segmentations"] = mask_data["rles"]

        records = []
        for idx in range(len(mask_data["segmentations"])):
            records.append(
                {
                    "segmentation": mask_data["segmentations"][idx],
                    "area": area_from_rle(mask_data["rles"][idx]),
                    "bbox": box_xyxy_to_xywh(mask_data["boxes"][idx]).tolist(),
                    "predicted_iou": float(mask_data["iou_preds"][idx]),
                    "point_coords": [mask_data["points"][idx].tolist()],
                    "stability_score": float(
                        mask_data["stability_score"][idx]
                    ),
                    "crop_box": box_xyxy_to_xywh(
                        np.asarray(mask_data["crop_boxes"][idx], np.float32)
                    ).tolist(),
                }
            )
        return records

    def _generate_masks(self, image: np.ndarray) -> MaskData:
        orig_size = image.shape[:2]
        crop_boxes, layer_idxs = generate_crop_boxes(
            orig_size, self.crop_n_layers, self.crop_overlap_ratio
        )
        data = MaskData()
        if len(crop_boxes) > 1:
            # encode every crop in ONE batched FPN forward (all crops are
            # resized to image_size, so they stack), then decode per crop
            crops = [
                image[y0:y1, x0:x1, :] for x0, y0, x1, y1 in crop_boxes
            ]
            self.predictor.set_image_batch(crops)
            for i, (crop_box, layer_idx) in enumerate(
                zip(crop_boxes, layer_idxs)
            ):
                self.predictor.select_batch_image(i)
                data.cat(
                    self._process_crop(
                        image, crop_box, layer_idx, orig_size,
                        preencoded=True,
                    )
                )
            self.predictor.reset_predictor()
        else:
            for crop_box, layer_idx in zip(crop_boxes, layer_idxs):
                crop_data = self._process_crop(
                    image, crop_box, layer_idx, orig_size
                )
                data.cat(crop_data)

        if len(crop_boxes) > 1 and len(data["boxes"]) > 0:
            # prefer masks from smaller crops (as SAM 2 does)
            scores = 1.0 / np.asarray(
                [(cb[2] - cb[0]) * (cb[3] - cb[1]) for cb in data["crop_boxes"]],
                np.float32,
            )
            keep = nms(
                data["boxes"].astype(np.float32), scores, self.crop_nms_thresh
            )
            data.filter(keep)
        return data

    def _process_crop(self, image, crop_box, crop_layer_idx, orig_size,
                      preencoded: bool = False) -> MaskData:
        x0, y0, x1, y1 = crop_box
        cropped = image[y0:y1, x0:x1, :]
        cropped_size = cropped.shape[:2]
        if not preencoded:
            self.predictor.set_image(cropped)

        points_scale = np.asarray(cropped_size, np.float32)[None, ::-1]
        points_for_image = self.point_grids[crop_layer_idx] * points_scale

        data = MaskData()
        for (points,) in batch_iterator(self.points_per_batch, points_for_image):
            batch_data = self._process_batch(
                points, cropped_size, crop_box, orig_size
            )
            data.cat(batch_data)
        if not preencoded:
            self.predictor.reset_predictor()

        if len(data["boxes"]) > 0:
            keep = nms(
                data["boxes"].astype(np.float32),
                data["iou_preds"].astype(np.float32),
                self.box_nms_thresh,
            )
            data.filter(keep)

        data["boxes"] = uncrop_boxes_xyxy(data["boxes"], crop_box)
        data["points"] = uncrop_points(data["points"], crop_box)
        data["crop_boxes"] = [crop_box for _ in range(len(data["rles"]))]
        return data

    def _process_batch(self, points, im_size, crop_box, orig_size) -> MaskData:
        orig_h, orig_w = orig_size
        coords = points[:, None, :]  # [B, 1, 2] in crop pixels
        labels = np.ones((len(points), 1), np.int32)
        masks, iou_preds, low_res = self.predictor.predict_batch(
            coords, labels,
            multimask_output=self.multimask_output,
            return_logits=True,
            normalize_coords=True,
        )
        # flatten [B, M, ...] -> [B*M, ...]
        m = masks.reshape(-1, *masks.shape[2:])
        data = MaskData(
            masks=m,
            iou_preds=iou_preds.reshape(-1),
            points=np.repeat(points, masks.shape[1], axis=0),
            low_res_masks=low_res.reshape(-1, *low_res.shape[2:]),
        )

        if self.use_m2m:
            # one-step refinement feeding the low-res logits back with the
            # original click (SAM 2's refine_with_m2m)
            new_masks, new_ious = [], []
            for pts, lrm in batch_iterator(
                self.points_per_batch, data["points"], data["low_res_masks"]
            ):
                m, iou, _ = self.predictor.predict_batch(
                    pts[:, None, :],
                    np.ones((len(pts), 1), np.int32),
                    mask_input_batch=lrm[:, None],
                    multimask_output=False,
                    return_logits=True,
                )
                new_masks.append(m[:, 0])
                new_ious.append(iou[:, 0])
            data["masks"] = np.concatenate(new_masks)
            data["iou_preds"] = np.concatenate(new_ious)

        if self.pred_iou_thresh > 0.0:
            data.filter(data["iou_preds"] > self.pred_iou_thresh)
        data["stability_score"] = calculate_stability_score(
            data["masks"], self.mask_threshold, self.stability_score_offset
        )
        if self.stability_score_thresh > 0.0:
            data.filter(data["stability_score"] >= self.stability_score_thresh)

        data["masks"] = data["masks"] > self.mask_threshold
        data["boxes"] = batched_mask_to_box(data["masks"])
        keep = ~is_box_near_crop_edge(
            data["boxes"], crop_box, [0, 0, orig_w, orig_h]
        )
        if not keep.all():
            data.filter(keep)

        data["masks"] = uncrop_masks(data["masks"], crop_box, orig_h, orig_w)
        data["rles"] = mask_to_rle(data["masks"])
        del data["masks"]
        del data["low_res_masks"]
        return data

    @staticmethod
    def postprocess_small_regions(
        mask_data: MaskData, min_area: int, nms_thresh: float
    ) -> MaskData:
        """Remove small holes/islands, dedup with NMS (SAM 2's postprocess_small_regions)."""
        if len(mask_data["rles"]) == 0:
            return mask_data
        new_masks, scores = [], []
        for rle in mask_data["rles"]:
            mask = rle_to_mask(rle)
            mask, changed = remove_small_regions(mask, min_area, "holes")
            unchanged = not changed
            mask, changed = remove_small_regions(mask, min_area, "islands")
            unchanged = unchanged and not changed
            new_masks.append(mask)
            scores.append(float(unchanged))

        masks = np.stack(new_masks)
        boxes = batched_mask_to_box(masks)
        keep = nms(boxes.astype(np.float32), np.asarray(scores), nms_thresh)
        for i in keep:
            if scores[i] == 0.0:  # mask changed; re-encode
                mask_data["rles"][i] = mask_to_rle(masks[i : i + 1])[0]
                mask_data["boxes"][i] = boxes[i]
        mask_data.filter(keep)
        return mask_data
