"""Semi-supervised VOS inference (DAVIS / MOSE / SA-V protocol).

Counterpart of the JAX package's ``tools/vos_inference.py`` (after the
reference's tools/vos_inference.py): load ground-truth PNG masks as prompts
(first frame, or each object's first appearance with
--track_object_appearing_later_in_video), run propagate_in_video and write
palettised PNGs per frame; joint multi-object inference and per-object
separate inference. Runs on the predictor's device; PIL reads and writes the
PNGs (imported inside the functions).

    python -m det_sam2_tpu_torch.tools.vos_inference --base_video_dir V \
        --input_mask_dir M --output_mask_dir O [--model hiera_b+] [--checkpoint C]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np

import torch

from det_sam2_tpu_torch.video_predictor import SAM2VideoPredictor

# DAVIS palette (the reference writes palettised PNGs with this palette)
DAVIS_PALETTE = np.zeros((256, 3), np.uint8)
for i in range(256):
    v, p = i, np.zeros(3, np.uint8)
    for j in range(8):
        p[0] |= ((v >> 0) & 1) << (7 - j)
        p[1] |= ((v >> 1) & 1) << (7 - j)
        p[2] |= ((v >> 2) & 1) << (7 - j)
        v >>= 3
    DAVIS_PALETTE[i] = p


def save_palettised_png(mask_per_obj: Dict[int, np.ndarray], path: str):
    from PIL import Image

    if mask_per_obj:
        h, w = next(iter(mask_per_obj.values())).shape
    else:
        raise ValueError("no masks to save")
    canvas = np.zeros((h, w), np.uint8)
    for obj_id, m in sorted(mask_per_obj.items()):
        canvas[m > 0] = obj_id
    img = Image.fromarray(canvas, mode="P")
    img.putpalette(DAVIS_PALETTE.reshape(-1).tolist())
    img.save(path)


def load_gt_masks(mask_dir: str) -> Dict[int, Dict[int, np.ndarray]]:
    from det_sam2_tpu_torch.tools.sav_benchmark import load_palettised_png_masks

    return load_palettised_png_masks(mask_dir)


def vos_inference(
    predictor: SAM2VideoPredictor,
    frames_dir: str,
    gt_mask_dir: str,
    output_dir: str,
    use_all_masks: bool = False,
    track_object_appearing_later: bool = False,
    per_object_png: bool = False,
) -> None:
    """Joint multi-object VOS (reference vos_inference :118-247).

    use_all_masks prompts with EVERY annotated frame (independent of the
    track-later flag, reference :145-166). Without track_object_appearing_
    later, an object id appearing only in a later prompt frame is an error
    (reference :196-205); with it, later-appearing objects are added online
    at their first annotated frame — the joint-session extension our online
    new-object API enables (the reference needs separate per-object
    sessions for this, :249-366)."""
    os.makedirs(output_dir, exist_ok=True)
    session = predictor.init_state(frames_dir)
    gt = load_gt_masks(gt_mask_dir)

    if use_all_masks:
        prompt_frames = sorted(gt.keys())
    elif track_object_appearing_later:
        # first appearance per object
        seen = set()
        prompt_frames = []
        for fidx in sorted(gt.keys()):
            if set(gt[fidx].keys()) - seen:
                prompt_frames.append(fidx)
                seen |= set(gt[fidx].keys())
    else:
        prompt_frames = [min(gt.keys())]

    first_frame_objs = set(gt[prompt_frames[0]].keys())
    prompted_objs = set()
    for fidx in prompt_frames:
        for obj_id, mask in sorted(gt[fidx].items()):
            if (
                not track_object_appearing_later
                and obj_id not in first_frame_objs
            ):
                raise RuntimeError(
                    f"object {obj_id} first appears at frame {fidx}; pass "
                    "--track_object_appearing_later_in_video for datasets "
                    "where objects appear after the first frame (LVOS, "
                    "YouTube-VOS)"
                )
            if use_all_masks or obj_id not in prompted_objs:
                predictor.add_new_mask(session, fidx, obj_id, mask)
                prompted_objs.add(obj_id)

    results: Dict[int, Dict[int, np.ndarray]] = {}
    for frame_idx, obj_ids, masks in predictor.propagate_in_video(session):
        results[frame_idx] = {
            obj_id: (masks[i, 0] > 0.0) for i, obj_id in enumerate(obj_ids)
        }
    for frame_idx, per_obj in sorted(results.items()):
        save_palettised_png(
            per_obj, os.path.join(output_dir, f"{frame_idx:05d}.png")
        )


def vos_separate_inference_per_object(
    predictor: SAM2VideoPredictor,
    frames_dir: str,
    gt_mask_dir: str,
    output_dir: str,
    use_all_masks: bool = False,
) -> None:
    """Per-object independent tracking for later-appearing objects:
    each object is prompted at its own first annotated frame (all its
    annotated frames with use_all_masks), propagated forward from there,
    then merged across objects by score with the non-overlap constraint
    (reference :249-366)."""
    from det_sam2_tpu_torch.modeling.sam2_base import (
        apply_non_overlapping_constraints,
    )

    os.makedirs(output_dir, exist_ok=True)
    gt = load_gt_masks(gt_mask_dir)

    # per object: its annotated (non-empty) frames — first only unless
    # use_all_masks (reference :283-305)
    inputs_per_object: Dict[int, Dict[int, np.ndarray]] = {}
    for fidx in sorted(gt.keys()):
        for obj_id, mask in sorted(gt[fidx].items()):
            if not np.any(mask):
                continue
            d = inputs_per_object.setdefault(obj_id, {})
            if d and not use_all_masks:
                continue
            d[fidx] = mask

    object_ids = sorted(inputs_per_object)
    if not object_ids:
        raise RuntimeError(f"no non-empty input masks in {gt_mask_dir}")
    scores_per_object: Dict[int, Dict[int, np.ndarray]] = {}
    session = predictor.init_state(frames_dir)
    num_frames = session.num_frames
    hw = (session.video_height, session.video_width)
    for obj_id in object_ids:
        predictor.reset_state(session)
        input_frames = sorted(inputs_per_object[obj_id])
        for fidx in input_frames:
            predictor.add_new_mask(
                session, fidx, obj_id, inputs_per_object[obj_id][fidx]
            )
        # forward-only from the object's first prompt (reference :320-326)
        for frame_idx, _, masks in predictor.propagate_in_video(
            session, start_frame_idx=min(input_frames), reverse=False
        ):
            scores_per_object.setdefault(obj_id, {})[frame_idx] = np.asarray(
                masks[0, 0], np.float32
            )

    # consolidate: frames an object never visited score -1024 (absent),
    # then suppress overlaps by keeping the max-scoring object per pixel
    for frame_idx in range(num_frames):
        scores = np.full((len(object_ids), 1, *hw), -1024.0, np.float32)
        for i, obj_id in enumerate(object_ids):
            got = scores_per_object.get(obj_id, {}).get(frame_idx)
            if got is not None:
                scores[i, 0] = got
        merged = apply_non_overlapping_constraints(
            torch.from_numpy(scores)
        ).numpy()
        per_obj = {
            obj_id: merged[i, 0] > 0.0 for i, obj_id in enumerate(object_ids)
        }
        save_palettised_png(
            per_obj, os.path.join(output_dir, f"{frame_idx:05d}.png")
        )


def main():  # pragma: no cover (CLI)
    from det_sam2_tpu_torch.build import build_sam2_video_predictor
    from det_sam2_tpu_torch.configs import MODEL_CONFIGS

    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="hiera_b+", choices=MODEL_CONFIGS)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--base_video_dir", required=True)
    ap.add_argument("--input_mask_dir", required=True)
    ap.add_argument("--output_mask_dir", required=True)
    ap.add_argument("--video_list_file", default=None)
    ap.add_argument("--use_all_masks", action="store_true")
    ap.add_argument("--track_object_appearing_later_in_video",
                    action="store_true")
    ap.add_argument("--per_obj_png_file", action="store_true")
    ap.add_argument(
        "--joint_tracking_for_later_objects", action="store_true",
        help="extension: handle later-appearing objects in ONE joint "
        "session via online new-object addition instead of the "
        "reference's separate per-object sessions (faster: one "
        "propagation pass instead of one per object)",
    )
    args = ap.parse_args()

    # bf16 on CUDA (raises without a card); the checkpoint is a SAM 2.1 .pt
    # or a save_params_npz file
    predictor = build_sam2_video_predictor(
        args.model, args.checkpoint, dtype=torch.bfloat16
    )
    # reference main: non_overlap unless writing per-object PNG trees
    # (vos_inference.py:441-443)
    predictor.non_overlap_masks = not args.per_obj_png_file

    if args.video_list_file:
        with open(args.video_list_file) as f:
            videos = [v.strip() for v in f if v.strip()]
    else:
        videos = sorted(os.listdir(args.base_video_dir))
    # reference routing (:471-478): later-appearing objects need the
    # separate per-object protocol — unless our joint extension is on
    separate = args.track_object_appearing_later_in_video and not (
        args.joint_tracking_for_later_objects
    )
    for video in videos:
        frames_dir = os.path.join(args.base_video_dir, video)
        gt_dir = os.path.join(args.input_mask_dir, video)
        out_dir = os.path.join(args.output_mask_dir, video)
        if separate or args.per_obj_png_file:
            vos_separate_inference_per_object(
                predictor, frames_dir, gt_dir, out_dir,
                use_all_masks=args.use_all_masks,
            )
        else:
            vos_inference(
                predictor, frames_dir, gt_dir, out_dir,
                use_all_masks=args.use_all_masks,
                track_object_appearing_later=(
                    args.track_object_appearing_later_in_video
                ),
            )


if __name__ == "__main__":  # pragma: no cover
    main()
