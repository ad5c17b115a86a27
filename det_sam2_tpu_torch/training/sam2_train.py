"""Training-time forward: simulated-prompt video tracking with memory.

Counterpart of the JAX package's ``training/sam2_train.py``. The reference's
host-rng decisions (which frames are initial conditioning frames, which get
correction clicks, point vs box vs mask prompts) are a ``PromptSchedule``
sampled with numpy; the per-click randomness (box noise, click positions,
the Bernoulli(prob_to_sample_from_gt) source choice) and nothing else is
drawn from a ``torch.Generator`` inside the forward. The per-frame memories
are plain Python dicts of tensors, and memory is assembled densely (gather
mode, K1 with a bias): the banked mode is inference only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from det_sam2_tpu_torch.configs import SAM2Config
from det_sam2_tpu_torch.modeling.layers import uniform
from det_sam2_tpu_torch.modeling.sam2_base import SAM2Model
from det_sam2_tpu_torch.track import use_multimask
from det_sam2_tpu_torch.training.samplers import (
    sample_box_points,
    sample_random_points_from_errors,
)


@dataclasses.dataclass(frozen=True)
class PromptSchedule:
    """One training batch's prompt structure."""

    init_cond_frames: Tuple[int, ...] = (0,)
    frames_to_correct: Tuple[int, ...] = ()
    use_pt_input: bool = True
    # per init-cond frame: box corners (True) or one sampled click (False)
    use_box_per_frame: Tuple[bool, ...] = (True,)
    num_correction_pt: int = 0
    prob_to_sample_from_gt: float = 0.0


@dataclasses.dataclass(frozen=True)
class PromptSimConf:
    """Train-side prompt-simulation knobs of SAM2Train; the defaults are the
    MOSE finetune recipe's (sam2.1_hiera_b+_MOSE_finetune.yaml:181-193)."""

    prob_to_use_pt_input: float = 0.5
    prob_to_use_box_input: float = 0.5
    num_frames_to_correct: int = 2
    rand_frames_to_correct: bool = True
    num_init_cond_frames: int = 2
    rand_init_cond_frames: bool = True
    num_correction_pt_per_frame: int = 7
    prob_to_sample_from_gt: float = 0.1


def sample_prompt_schedule(rng: np.random.Generator, num_frames: int,
                           conf: PromptSimConf) -> PromptSchedule:
    """Host-rng sampling of SAM2Train.prepare_prompt_inputs, with the JAX
    package's order of calls on `rng`, so a seeded generator gives the same
    schedule in both packages."""
    prob_pt = conf.prob_to_use_pt_input
    num_frames_to_correct = conf.num_frames_to_correct
    num_init_cond = conf.num_init_cond_frames
    if num_frames == 1:
        # static-image SAM task: force point input, single frame
        prob_pt = 1.0
        num_frames_to_correct = 1
        num_init_cond = 1
    use_pt_input = bool(rng.random() < prob_pt)
    if conf.rand_init_cond_frames and num_init_cond > 1:
        num_init_cond = int(rng.integers(1, num_init_cond, endpoint=True))
    if (use_pt_input and conf.rand_frames_to_correct
            and num_frames_to_correct > num_init_cond):
        num_frames_to_correct = int(
            rng.integers(num_init_cond, num_frames_to_correct, endpoint=True))

    if num_init_cond == 1:
        init_cond = [0]
    else:
        init_cond = [0] + rng.choice(range(1, num_frames), num_init_cond - 1,
                                     replace=False).tolist()
    rest = [t for t in range(num_frames) if t not in init_cond]

    use_box_per_frame = tuple(
        bool(rng.random() < conf.prob_to_use_box_input) if use_pt_input else False
        for _ in init_cond
    )

    if not use_pt_input:
        frames_to_correct: List[int] = []
    elif num_frames_to_correct == num_init_cond:
        frames_to_correct = list(init_cond)
    else:
        extra = num_frames_to_correct - num_init_cond
        frames_to_correct = init_cond + rng.choice(rest, extra, replace=False).tolist()

    return PromptSchedule(
        init_cond_frames=tuple(int(t) for t in init_cond),
        frames_to_correct=tuple(int(t) for t in frames_to_correct),
        use_pt_input=use_pt_input,
        use_box_per_frame=use_box_per_frame,
        num_correction_pt=conf.num_correction_pt_per_frame if use_pt_input else 0,
        prob_to_sample_from_gt=conf.prob_to_sample_from_gt,
    )


def _training_memory(model: SAM2Model, cfg: SAM2Config, t: int,
                     cond_ts: Sequence[int], mem_feats: Dict[int, torch.Tensor],
                     mem_ptrs: Dict[int, torch.Tensor], num_frames: int):
    """The memory of training frame t (stride 1, every processed cond frame,
    no past-only pointer filter): (memory [B, Nk, Cm], pos [1, Nk, Cm],
    spatial tile count, pointer token count)."""
    tiles, tpos_idx = [], []
    nm = cfg.num_maskmem
    for ct in cond_ts:
        if ct in mem_feats and ct != t:
            tiles.append(mem_feats[ct])
            tpos_idx.append(nm - 1)
    for d in range(nm - 1, 0, -1):  # t_rel = d, earliest first
        pt = t - d
        if pt >= 0 and pt in mem_feats and pt not in cond_ts:
            tiles.append(mem_feats[pt])
            tpos_idx.append(d - 1)

    cm = cfg.mem_dim
    dev = tiles[0].device
    base = model.sine_pe(cfg.image_embedding_size, cm, dev)[None]  # [1, S, Cm]
    mem = torch.cat(tiles, 1)
    pos = torch.cat([base + model.maskmem_tpos_enc[i, 0, 0][None, None]
                     for i in tpos_idx], 1)

    ptr_list, dist_list = [], []
    for ct in cond_ts:
        if ct in mem_ptrs and ct != t:
            d = t - ct
            ptr_list.append(mem_ptrs[ct])
            dist_list.append(d if cfg.use_signed_tpos_enc_to_obj_ptrs else abs(d))
    max_ptrs = min(num_frames, cfg.max_obj_ptrs_in_encoder)
    for d in range(1, max_ptrs):
        pt = t - d
        if pt >= 0 and pt in mem_ptrs and pt not in cond_ts:
            ptr_list.append(mem_ptrs[pt])
            dist_list.append(d)

    num_ptr_tokens = 0
    if cfg.use_obj_ptrs_in_encoder and ptr_list:
        tpp = cfg.hidden_dim // cm
        ptrs = torch.stack(ptr_list, 1)  # [B, P, C]
        bsz, p, _ = ptrs.shape
        ptr_tok = ptrs.reshape(bsz, p * tpp, cm)
        pe = model.obj_ptr_tpos(torch.tensor(dist_list, dtype=torch.float32, device=dev),
                                torch.tensor(max_ptrs - 1, device=dev))
        ptr_pos = pe.repeat_interleave(tpp, 0)[None]
        mem = torch.cat([mem, ptr_tok.to(mem.dtype)], 1)
        pos = torch.cat([pos, ptr_pos.to(pos.dtype)], 1)
        num_ptr_tokens = p * tpp
    return mem, pos, len(tiles), num_ptr_tokens


def forward_training(
    model: SAM2Model,
    cfg: SAM2Config,
    images: torch.Tensor,  # [T, B, H, W, 3]
    gt_masks: torch.Tensor,  # [T, B, H, W] or [T, B, K, H, W]
    generator: Optional[torch.Generator] = None,
    schedule: Optional[PromptSchedule] = None,
    prompt_kind: str = "box",  # 'box' | 'point' | 'mask' (no schedule given)
    num_correction_steps: int = 0,
    num_init_cond_frames: int = 1,
    box_noise: float = 0.1,
) -> List[Dict]:
    """Simulated-prompt tracking over a training clip -> per-frame output
    dicts (frame order) for ``MultiStepMultiMasksAndIous``.

    Initial conditioning frames are processed first (so later frames attend
    all of them), then the rest in index order. Frames in
    ``schedule.frames_to_correct`` receive ``num_correction_pt`` iterative
    clicks sampled from the prediction's errors (or, with probability
    prob_to_sample_from_gt, from the GT), with the previous low-res logits as
    the dense prompt; every step is supervised. A GT-mask prompt with
    cfg.use_mask_input_as_output_without_sam bypasses the SAM heads.

    generator draws the prompt noise and clicks and, when
    cfg.hiera.drop_path_rate > 0, the trunk's drop-path masks; None takes a
    CPU generator seeded 0. cfg.remat_image_encoder rematerialises the image
    encoder (the masks are drawn outside it)."""
    if schedule is None:
        init_cond = tuple(range(num_init_cond_frames))
        schedule = PromptSchedule(
            init_cond_frames=init_cond,
            frames_to_correct=(init_cond if num_correction_steps > 0
                               and prompt_kind != "mask" else ()),
            use_pt_input=prompt_kind != "mask",
            use_box_per_frame=tuple(prompt_kind == "box" for _ in init_cond),
            num_correction_pt=num_correction_steps,
        )
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    t_total, b_videos = images.shape[0], images.shape[1]
    # multi-object clips: K object tracks per video share one image encode
    if gt_masks.ndim == 5:
        k_objs = gt_masks.shape[2]
        gt_masks = gt_masks.reshape(t_total, b_videos * k_objs, *gt_masks.shape[3:])
    else:
        k_objs = 1
    b = b_videos * k_objs
    flat = images.reshape(t_total * b_videos, *images.shape[2:])
    drop_gen = generator if cfg.hiera.drop_path_rate > 0 else None
    s0, s1, feat = model.forward_image(flat, generator=drop_gen,
                                       remat=cfg.remat_image_encoder)

    def frame_feats(t):
        rows = [x[t * b_videos:(t + 1) * b_videos] for x in (s0, s1, feat)]
        return [r.repeat_interleave(k_objs, 0) if k_objs > 1 else r for r in rows]

    cond_ts = list(schedule.init_cond_frames)
    correct_ts = set(schedule.frames_to_correct)
    processing_order = cond_ts + [t for t in range(t_total) if t not in cond_ts]

    mem_feats: Dict[int, torch.Tensor] = {}
    mem_ptrs: Dict[int, torch.Tensor] = {}
    outs_by_t: Dict[int, Dict] = {}

    def sample_correction(gt, high_res):
        """One correction click: from the errors, or from the GT with a
        Bernoulli(prob_to_sample_from_gt) choice for the whole batch."""
        pt, lb = sample_random_points_from_errors(generator, gt, high_res[:, 0] > 0)
        if schedule.prob_to_sample_from_gt > 0:
            pt_g, lb_g = sample_random_points_from_errors(generator, gt, None)
            from_gt = uniform((), generator, gt.device) < schedule.prob_to_sample_from_gt
            pt = torch.where(from_gt, pt_g, pt)
            lb = torch.where(from_gt, lb_g, lb)
        return pt, lb

    def record(t, out, high_res, obj_ptr, ft, obj_logits):
        maskmem = model.encode_memory(ft, high_res, obj_logits, binarize=False)
        mem_feats[t] = maskmem.reshape(b, -1, cfg.mem_dim)
        mem_ptrs[t] = obj_ptr
        out["pred_masks_high_res"] = high_res
        outs_by_t[t] = out

    for t in processing_order:
        f0, f1, ft = frame_feats(t)
        is_init = t in cond_ts
        gt_t = gt_masks[t]
        out = {"multistep_pred_multimasks_high_res": [], "multistep_pred_ious": [],
               "multistep_object_score_logits": []}

        def supervise(heads):
            out["multistep_pred_multimasks_high_res"].append(heads[1])
            out["multistep_pred_ious"].append(heads[2])
            out["multistep_object_score_logits"].append(heads[6])

        coords, labels, mask_input = None, None, None
        if is_init:
            if not schedule.use_pt_input and cfg.use_mask_input_as_output_without_sam:
                # the GT mask is the output at +-10 logits, the object score
                # comes from its occupancy (SAM 2's _use_mask_as_output)
                heads = model.use_mask_as_output(ft, [f0, f1],
                                                 gt_t.float()[..., None])
                supervise(heads)
                record(t, out, heads[4], heads[5], ft, heads[6])
                continue
            pix = model.no_mem_features(ft)
            if not schedule.use_pt_input:
                mask_input = gt_t.float()[..., None]  # GT mask as the dense prompt
            else:
                if schedule.use_box_per_frame[cond_ts.index(t)]:
                    coords, labels = sample_box_points(generator, gt_t, noise=box_noise)
                else:  # one initial click from the GT
                    coords, labels = sample_random_points_from_errors(generator, gt_t,
                                                                      None)
        else:
            mem, pos, n_tiles, n_ptr = _training_memory(model, cfg, t, cond_ts,
                                                        mem_feats, mem_ptrs, t_total)
            valid = torch.ones(mem.shape[1], dtype=torch.bool, device=mem.device)
            pix = model.attend_memory(ft, mem, pos, valid, num_mem_frames=n_tiles,
                                      num_obj_ptr_tokens=n_ptr)

        num_pts = 0 if labels is None else labels.shape[1]
        heads = model.forward_sam_heads(
            pix, point_coords=coords, point_labels=labels, mask_inputs=mask_input,
            high_res_features=[f0, f1],
            multimask_output=use_multimask(cfg, is_init=is_init, num_pts=num_pts),
            training=True)
        supervise(heads)

        # iterative correction clicks: the previous low-res logits are the
        # dense prompt, clicks accumulate, every step is supervised
        if t in correct_ts and schedule.num_correction_pt > 0:
            acc_coords, acc_labels = coords, labels
            for _ in range(schedule.num_correction_pt):
                new_pt, new_lb = sample_correction(gt_t, heads[4])
                if acc_coords is None:
                    acc_coords, acc_labels = new_pt, new_lb
                else:
                    acc_coords = torch.cat([acc_coords, new_pt], 1)
                    acc_labels = torch.cat([acc_labels, new_lb], 1)
                heads = model.forward_sam_heads(
                    pix, point_coords=acc_coords, point_labels=acc_labels,
                    mask_inputs=heads[3][:, 0, :, :, None], high_res_features=[f0, f1],
                    multimask_output=use_multimask(cfg, is_init=is_init,
                                                   num_pts=acc_labels.shape[1]),
                    training=True)
                supervise(heads)

        record(t, out, heads[4], heads[5], ft, heads[6])
    return [outs_by_t[t] for t in range(t_total)]
