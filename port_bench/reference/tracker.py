"""Plain fp32 SAM 2.1 video tracking of a few object rows.

Written for the benchmark from SAM 2's video semantics (``SAM2Base.
_prepare_memory_conditioned_features``, ``track_step``, ``_encode_new_memory``
and the video predictor's prompt consolidation), not from the program's
ring-buffer bank: the memory is a dict of frame index -> (memory, object
pointer), the selection walks it as SAM 2 does, and the memory tokens are
assembled densely for plain attention. Each row is one object tracked from a
box prompt on frame 0 of its own stream; rows never interact (the memory
encoder's non-overlap constraint is off in SAM 2.1), so a few rows of a
batch can be followed alone.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .configs import SAM2Config
from .holes import fill_holes
from .sam2_base import SAM2Model, resize_bilinear


def use_multimask(cfg: SAM2Config, is_init: bool, num_pts: int) -> bool:
    """SAM 2's ``_use_multimask``."""
    return (cfg.multimask_output_in_sam
            and (is_init or cfg.multimask_output_for_tracking)
            and cfg.multimask_min_pt_num <= num_pts <= cfg.multimask_max_pt_num)


class RowTracker:
    """Tracks R object rows in fp32. ``prompt`` takes frame 0's features and
    one box a row; ``track(k, feats)`` tracks frame k (k = 1, 2, ...) and
    returns the hole-filled low-res mask logits and object scores."""

    def __init__(self, model: SAM2Model, cfg: SAM2Config, num_frames: int):
        self.model = model
        self.cfg = cfg
        self.num_frames = int(num_frames)
        self.cond: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.noncond: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _fill(self, low: torch.Tensor) -> torch.Tensor:
        """Hole filling of [R, 1, h, w] logits, row by row on the host."""
        host = low.detach().float().cpu().numpy()
        out = np.stack([fill_holes(m[0], self.cfg.fill_hole_area)[None] for m in host])
        return torch.from_numpy(out).to(low.device)

    def _encode(self, feat, high_res, obj_logits, binarize: bool) -> torch.Tensor:
        mem = self.model.encode_memory(feat, high_res, obj_logits, binarize=binarize)
        return mem.reshape(mem.shape[0], -1, self.cfg.mem_dim)

    @torch.no_grad()
    def prompt(self, feats, boxes: np.ndarray) -> torch.Tensor:
        """feats (s0, s1, feat) [R, ...] of frame 0; boxes [R, 4] (x0, y0,
        x1, y1) in model pixels. Writes frame 0's conditioning memory and
        returns its hole-filled low-res logits [R, 1, h, w]."""
        cfg, m = self.cfg, self.model
        s0, s1, feat = feats
        r = feat.shape[0]
        dev = feat.device
        points = torch.as_tensor(np.asarray(boxes, np.float32).reshape(r, 2, 2), device=dev)
        labels = torch.tensor([[2, 3]] * r, dtype=torch.int64, device=dev)
        out = m.forward_sam_heads(
            m.no_mem_features(feat), point_coords=points, point_labels=labels,
            high_res_features=[s0, s1],
            multimask_output=use_multimask(cfg, True, 2))
        _, _, _, low, _, ptr, obj_logits = out
        low = self._fill(low)
        # the consolidated prompt frame: the filled low-res mask brought to
        # the model's size, binarised for the memory encoder
        high = resize_bilinear(low, (cfg.image_size, cfg.image_size))
        binarize = cfg.binarize_mask_from_pts_for_mem_enc
        self.cond[0] = (self._encode(feat, high, obj_logits, binarize), ptr)
        return low

    def _memory(self, k: int):
        """SAM 2's memory for frame k (forward, stride r): the conditioning
        frames (all of them: the benchmark prompts frame 0 only), the
        non-conditioning memories at t_pos 1 .. num_maskmem - 1, and the
        object pointers of the last max_obj_ptrs_in_encoder frames."""
        cfg, m = self.cfg, self.model
        nm, r = cfg.num_maskmem, max(1, cfg.memory_temporal_stride_for_eval)
        if len(self.cond) > cfg.max_cond_frames_in_attn:
            raise NotImplementedError("more conditioning frames than are attended")
        entries = [(0, mem) for mem, _ in self.cond.values()]
        for t_pos in range(1, nm):
            t_rel = nm - t_pos
            prev = k - 1 if t_rel == 1 else ((k - 2) // r) * r - (t_rel - 2) * r
            if prev in self.noncond:
                entries.append((t_pos, self.noncond[prev][0]))
        hw = cfg.image_embedding_size
        base = m.sine_pe(hw, cfg.mem_dim, entries[0][1].device)
        mems, poss = [], []
        for t_pos, mem in entries:
            mems.append(mem)
            poss.append(base + m.maskmem_tpos_enc[nm - t_pos - 1, 0, 0].float())
        ptrs, dists = [], []
        for t, (_, ptr) in self.cond.items():
            if (not cfg.only_obj_ptrs_in_the_past_for_eval) or t <= k:
                ptrs.append(ptr)
                dists.append(k - t if cfg.use_signed_tpos_enc_to_obj_ptrs else abs(k - t))
        max_ptrs = min(self.num_frames, cfg.max_obj_ptrs_in_encoder)
        for t_diff in range(1, max_ptrs):
            t = k - t_diff
            if t < 0 or t >= self.num_frames:
                break
            if t in self.noncond:
                ptrs.append(self.noncond[t][1])
                dists.append(t_diff)
        rows = mems[0].shape[0]
        memory = torch.cat(mems, 1)
        memory_pos = torch.cat(poss, 0)[None].expand(rows, -1, -1)
        n_ptr_tokens = 0
        if cfg.use_obj_ptrs_in_encoder and ptrs:
            tpp = cfg.hidden_dim // cfg.mem_dim
            p = torch.stack(ptrs, 1)  # [R, P, C]
            tokens = p.reshape(rows, -1, cfg.mem_dim)  # [R, P * tpp, Cm]
            pe = m.obj_ptr_tpos(torch.tensor(dists, dtype=torch.float32, device=p.device),
                                torch.tensor(max_ptrs - 1, device=p.device))
            pe = pe.repeat_interleave(tpp, 0)[None].expand(rows, -1, -1)
            memory = torch.cat([memory, tokens.float()], 1)
            memory_pos = torch.cat([memory_pos, pe.float()], 1)
            n_ptr_tokens = tokens.shape[1]
        return memory, memory_pos, len(entries), n_ptr_tokens

    @torch.no_grad()
    def track(self, k: int, feats):
        """Track frame k from its features [R, ...]: memory attention, the
        SAM heads (multimask for tracking), the memory of frame k written.
        Returns (hole-filled low-res logits [R, 1, h, w], object pointers
        [R, C]); the memory is encoded from the unfilled masks."""
        cfg, m = self.cfg, self.model
        s0, s1, feat = feats
        memory, memory_pos, n_frames, n_ptr = self._memory(k)
        valid = torch.ones(memory.shape[:2], dtype=torch.bool, device=memory.device)
        pix = m.attend_memory(feat, memory, memory_pos, valid,
                              num_mem_frames=n_frames, num_obj_ptr_tokens=n_ptr)
        out = m.forward_sam_heads(pix, high_res_features=[s0, s1],
                                  multimask_output=use_multimask(cfg, False, 0))
        _, _, _, low, high, ptr, obj_logits = out
        self.noncond[k] = (self._encode(feat, high, obj_logits, False), ptr)
        keep = max(cfg.num_maskmem, cfg.max_obj_ptrs_in_encoder) + 1
        for t in [t for t in self.noncond if t < k - keep]:
            del self.noncond[t]
        return self._fill(low), ptr
