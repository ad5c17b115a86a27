"""SA-V dataset browsing helpers.

Counterpart of the JAX package's ``tools/sav_utils.py`` (after the
reference's sav_dataset/utils/sav_utils.py): enumerate videos, load per-frame
annotations (palettised PNGs or per-object RLE manifests) and render mask
overlays for inspection. PIL is imported inside the functions that read or
write images.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from det_sam2_tpu_torch.utils.amg import rle_to_mask


class SAVDataset:
    """Browse a DAVIS/SA-V-style dataset:
    <root>/JPEGImages/<video>/*.jpg + <root>/Annotations/<video>/*.png
    or <root>/<video>_manual.json SA-V RLE manifests."""

    def __init__(self, root: str):
        self.root = root
        img_dir = os.path.join(root, "JPEGImages")
        if os.path.isdir(img_dir):
            self.img_dir = img_dir
            self.ann_dir = os.path.join(root, "Annotations")
            self.videos = sorted(os.listdir(img_dir))
        else:
            self.img_dir = root
            self.ann_dir = root
            self.videos = sorted(
                d for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d))
            )

    def frame_paths(self, video: str) -> List[str]:
        d = os.path.join(self.img_dir, video)
        return [
            os.path.join(d, n)
            for n in sorted(os.listdir(d))
            if n.lower().endswith((".jpg", ".jpeg", ".png"))
        ]

    def load_frame(self, video: str, idx: int) -> np.ndarray:
        from PIL import Image

        return np.asarray(Image.open(self.frame_paths(video)[idx]).convert("RGB"))

    def load_annotations(self, video: str) -> Dict[int, Dict[int, np.ndarray]]:
        """{frame_idx: {obj_id: bool mask}} from palettised PNGs or an SA-V
        RLE manifest (<video>_manual.json with masklet lists)."""
        png_dir = os.path.join(self.ann_dir, video)
        if os.path.isdir(png_dir):
            from det_sam2_tpu_torch.tools.sav_benchmark import (
                load_palettised_png_masks,
            )

            return load_palettised_png_masks(png_dir)
        manifest = os.path.join(self.root, f"{video}_manual.json")
        if not os.path.exists(manifest):
            raise FileNotFoundError(f"no annotations for {video}")
        with open(manifest) as f:
            data = json.load(f)
        out: Dict[int, Dict[int, np.ndarray]] = {}
        for obj_id, masklet in enumerate(data.get("masklet", []), start=1):
            for frame_idx, rle in enumerate(masklet):
                if rle is None:
                    continue
                out.setdefault(frame_idx, {})[obj_id] = rle_to_mask(rle)
        return out

    def render_overlay(
        self, video: str, frame_idx: int, alpha: float = 0.5,
        out_path: Optional[str] = None,
    ) -> np.ndarray:
        """Frame with colored mask overlays (sav_utils.py visualization)."""
        frame = self.load_frame(video, frame_idx).copy()
        anns = self.load_annotations(video).get(frame_idx, {})
        rng = np.random.default_rng(0)
        for obj_id, mask in sorted(anns.items()):
            color = rng.integers(60, 255, 3)
            frame[mask] = (
                (1 - alpha) * frame[mask] + alpha * color
            ).astype(np.uint8)
        if out_path:
            from PIL import Image

            Image.fromarray(frame).save(out_path)
        return frame
