"""Evaluation harness: grid search over pipeline hyperparameters with
precision / recall / F1 on billiards events.

Counterpart of the JAX package's ``app/eval.py`` (Det-SAM2's
eval_det-sam2.py EvalDetSAM2PostProcess): itertools.product over the
hyperparameter lists with validity constraints, per-video run ->
postprocess -> P / R / F1 against `postprocess.jsonl` ground truth for pot /
collision / rebound events, appended to eval_results.json.

GT jsonl format (one video per line):
  {"video": "video149.mp4",
   "pot": {"4": "left_up", ...},
   "collision": [[2, 3], ...],
   "rebound": {"1": ["right"], ...}}
"""

from __future__ import annotations

import itertools
import json
import os
from typing import Callable, Dict, List, Sequence

from det_sam2_tpu_torch.app.postprocess import VideoPostProcessor


def precision_recall_f1(true_set: set, pred_set: set):
    """(eval_det-sam2.py:263-283)"""
    if not true_set and not pred_set:
        return 1.0, 1.0, 1.0
    tp = len(true_set & pred_set)
    fp = len(pred_set - true_set)
    fn = len(true_set - pred_set)
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if precision + recall > 0
        else 0.0
    )
    return precision, recall, f1


def pot_metrics(pot_gt: Dict, pot_pred: Dict):
    gt = {(int(ball), hole) for ball, hole in pot_gt.items()}
    pred = {(int(b), d["hole"]) for b, d in pot_pred.items()}
    return precision_recall_f1(gt, pred)


def collision_metrics(collision_gt: Sequence, collision_pred: Dict):
    gt = {tuple(sorted(p)) for p in collision_gt}
    pred = {
        tuple(sorted(p)) for pairs in collision_pred.values() for p in pairs
    }
    return precision_recall_f1(gt, pred)


def rebound_metrics(rebound_gt: Dict, rebound_pred: Dict):
    gt = {
        (int(ball), side)
        for ball, sides in rebound_gt.items()
        for side in sides
    }
    pred = {
        (int(b), side) for items in rebound_pred.values() for b, side in items
    }
    return precision_recall_f1(gt, pred)


def evaluate_video(
    post: VideoPostProcessor, gt: Dict
) -> Dict[str, Dict[str, float]]:
    p, r, f = pot_metrics(gt.get("pot", {}), post.disappeared_balls)
    out = {"pot": {"precision": p, "recall": r, "f1": f}}
    p, r, f = collision_metrics(gt.get("collision", []), post.ball_collision)
    out["collision"] = {"precision": p, "recall": r, "f1": f}
    p, r, f = rebound_metrics(gt.get("rebound", {}), post.ball_rebound)
    out["rebound"] = {"precision": p, "recall": r, "f1": f}
    return out


def average_metrics(results: Dict[str, Dict]) -> Dict:
    """(eval_det-sam2.py:calulate_avg_metrics)"""
    out = {}
    n = max(len(results), 1)
    for event in ("pot", "collision", "rebound"):
        out[event] = {
            k: sum(r[event][k] for r in results.values()) / n
            for k in ("precision", "recall", "f1")
        }
    return out


class EvalDetSAM2PostProcess:
    """Grid-search evaluator. `processor_factory(**params)` must build a
    fresh (VideoProcessor, VideoPostProcessor) pair for a parameter combo —
    the cheap re-instantiation Det-SAM2 leans on
    (eval_det-sam2.py:50-93)."""

    def __init__(self, processor_factory: Callable[..., tuple]):
        self.processor_factory = processor_factory

    @staticmethod
    def valid_combo(params: Dict) -> bool:
        """(eval_det-sam2.py:134-143)"""
        if params["max_frame_num_to_track"] < params["frame_buffer_size"]:
            return False
        if (
            params["detect_interval"] == 0
            and params.get("load_inference_state_path") is None
        ):
            return False
        if (
            params["max_inference_state_frames"] != -1
            and params["max_inference_state_frames"]
            < params["max_frame_num_to_track"]
        ):
            return False
        return True

    def eval_videos(
        self,
        videos: Dict[str, object],  # name -> video source (path or frames)
        gt_by_video: Dict[str, Dict],
        params: Dict,
    ) -> Dict:
        per_video = {}
        for name, source in videos.items():
            processor, post = self.processor_factory(**params)
            processor.run(source)
            pockets = processor.special_classes_detection
            if pockets:
                post.get_hole_name(list(pockets))
                post.get_boundary_from_holes()
                segments = {
                    idx - processor.pre_frames: segs
                    for idx, segs in processor.video_segments.items()
                }
                post.run(segments)
            per_video[name] = evaluate_video(post, gt_by_video.get(name, {}))
        return average_metrics(per_video)

    def eval_all_settings(
        self,
        videos: Dict[str, object],
        eval_jsonl_path: str,
        eval_output_dir: str,
        param_grid: Dict[str, List],
    ) -> List[Dict]:
        """Run every valid combination; append results to eval_results.json
        (eval_det-sam2.py:95-176)."""
        gt_by_video = {}
        with open(eval_jsonl_path) as f:
            for line in f:
                if line.strip():
                    rec = json.loads(line)
                    gt_by_video[rec["video"]] = rec

        os.makedirs(eval_output_dir, exist_ok=True)
        out_path = os.path.join(eval_output_dir, "eval_results.json")
        all_results = []
        if os.path.exists(out_path):
            with open(out_path) as f:
                all_results = json.load(f)

        keys = list(param_grid.keys())
        for values in itertools.product(*param_grid.values()):
            params = dict(zip(keys, values))
            if not self.valid_combo(params):
                continue
            avg = self.eval_videos(videos, gt_by_video, params)
            all_results.append(
                {"params_setting": params, "average_results": avg}
            )
            with open(out_path, "w") as f:
                json.dump(all_results, f, indent=4)
        return all_results
