"""Dataset label correction: re-fit detector boxes to SAM 2's mask boxes.

Counterpart of the JAX package's ``tools/process_dataset.py`` (after the
reference's notebooks/process_dataset.py): for each image and its YOLO label
file, prompt the image predictor with each labelled box, take the mask, and
replace the box with the mask's tight box (normalised YOLO xywh). Runs on
the predictor's device; PIL decodes the images (imported inside the
function).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from det_sam2_tpu_torch.image_predictor import SAM2ImagePredictor
from det_sam2_tpu_torch.utils.misc import mask_to_box_np


def yolo_to_xyxy(line: str, w: int, h: int) -> Tuple[int, List[float]]:
    parts = line.split()
    cls = int(parts[0])
    cx, cy, bw, bh = (float(v) for v in parts[1:5])
    return cls, [
        (cx - bw / 2) * w, (cy - bh / 2) * h,
        (cx + bw / 2) * w, (cy + bh / 2) * h,
    ]


def xyxy_to_yolo(cls: int, box: np.ndarray, w: int, h: int) -> str:
    x1, y1, x2, y2 = box
    cx, cy = (x1 + x2) / 2 / w, (y1 + y2) / 2 / h
    bw, bh = (x2 - x1) / w, (y2 - y1) / h
    return f"{cls} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}"


def refine_labels_for_image(
    predictor: SAM2ImagePredictor, image: np.ndarray, label_lines: List[str]
) -> List[str]:
    h, w = image.shape[:2]
    predictor.set_image(image)
    out_lines = []
    for line in label_lines:
        if not line.strip():
            continue
        cls, box = yolo_to_xyxy(line, w, h)
        masks, ious, _ = predictor.predict(
            box=np.asarray(box, np.float32), multimask_output=False
        )
        mask = masks[0]
        if mask.sum() == 0:  # keep the original box for empty masks
            out_lines.append(line.strip())
            continue
        tight = mask_to_box_np(mask[None])[0]
        out_lines.append(xyxy_to_yolo(cls, tight, w, h))
    return out_lines


def process_dataset(
    predictor: SAM2ImagePredictor,
    images_dir: str,
    labels_dir: str,
    output_labels_dir: str,
) -> None:
    from PIL import Image

    os.makedirs(output_labels_dir, exist_ok=True)
    for name in sorted(os.listdir(images_dir)):
        stem, ext = os.path.splitext(name)
        if ext.lower() not in (".jpg", ".jpeg", ".png"):
            continue
        label_path = os.path.join(labels_dir, stem + ".txt")
        if not os.path.exists(label_path):
            continue
        image = np.asarray(
            Image.open(os.path.join(images_dir, name)).convert("RGB")
        )
        with open(label_path) as f:
            lines = f.readlines()
        refined = refine_labels_for_image(predictor, image, lines)
        with open(os.path.join(output_labels_dir, stem + ".txt"), "w") as f:
            f.write("\n".join(refined) + "\n")
