"""SAM2Model: the assembled single-frame model.

Counterpart of the JAX package's ``modeling/sam2_base.py``: image features,
SAM heads, memory cross-attention (gather or banked) and memory encoding.
Memory selection lives in ``state.py``. NHWC, batch = object slots. The
SAM 2.1 state-dict names are kept, so a SAM 2.1 checkpoint's ``model``
entry loads strictly.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from det_sam2_tpu_torch.configs import SAM2Config
from det_sam2_tpu_torch.modeling.image_encoder import ImageEncoder
from det_sam2_tpu_torch.modeling.layers import (
    MLP,
    approx_gelu,
    conv_nhwc,
    exact_gelu,
    sdpa,
)
from det_sam2_tpu_torch.modeling.mask_decoder import MaskDecoder
from det_sam2_tpu_torch.modeling.memory_attention import MemoryAttention
from det_sam2_tpu_torch.modeling.memory_encoder import MemoryEncoder
from det_sam2_tpu_torch.modeling.position_encoding import (
    get_1d_sine_pe,
    sine_pos_embed_2d,
)
from det_sam2_tpu_torch.modeling.prompt_encoder import PromptEncoder

# placeholder score for missing objects
NO_OBJ_SCORE = -1024.0


def resize_bilinear(x: torch.Tensor, hw, antialias: bool = False) -> torch.Tensor:
    """Bilinear resize (align_corners=False) of the last two axes in fp32,
    returned in x's dtype: the operator the JAX package's matmul resize
    emulates."""
    lead = x.shape[:-2]
    y = F.interpolate(x.float().reshape(-1, 1, *x.shape[-2:]), size=tuple(hw),
                      mode="bilinear", align_corners=False, antialias=antialias)
    return y.reshape(*lead, *y.shape[-2:]).to(x.dtype)


class SAM2Model(nn.Module):
    def __init__(self, cfg: SAM2Config, attention_fn: Callable = sdpa,
                 banked_attention_fn: Optional[Callable] = None,
                 dtype: torch.dtype = torch.float32):
        """attention_fn: K1's wrapper (``ops.attention.flash_attention``) or
        plain ``sdpa``; banked_attention_fn: K2's wrapper. dtype picks the
        GELU form when cfg.use_approx_gelu is None: tanh in bf16, erf in
        fp32 (the parameters' dtype is the caller's)."""
        super().__init__()
        c = cfg
        self.cfg = cfg
        use_approx = c.use_approx_gelu
        if use_approx is None:
            use_approx = dtype == torch.bfloat16
        gelu = approx_gelu if use_approx else exact_gelu
        self.image_encoder = ImageEncoder(c.hiera, c.neck, c.scalp,
                                          attention_fn=attention_fn, gelu=gelu)
        self.memory_attention = MemoryAttention(
            c.memory_attention, attention_fn=attention_fn,
            banked_attention_fn=banked_attention_fn,
        )
        self.memory_encoder = MemoryEncoder(c.memory_encoder)
        s = c.image_embedding_size
        self.sam_prompt_encoder = PromptEncoder(
            embed_dim=c.hidden_dim, image_embedding_size=(s, s),
            input_image_size=(c.image_size, c.image_size), mask_in_chans=16,
        )
        self.sam_mask_decoder = MaskDecoder(
            transformer_dim=c.hidden_dim,
            num_multimask_outputs=3,
            iou_head_depth=3,
            iou_head_hidden_dim=256,
            use_high_res_features=c.use_high_res_features_in_sam,
            iou_prediction_use_sigmoid=c.iou_prediction_use_sigmoid,
            dynamic_multimask_via_stability=c.dynamic_multimask_via_stability,
            dynamic_multimask_stability_delta=c.dynamic_multimask_stability_delta,
            dynamic_multimask_stability_thresh=c.dynamic_multimask_stability_thresh,
            pred_obj_scores=c.pred_obj_scores,
            pred_obj_scores_mlp=c.pred_obj_scores_mlp,
            use_multimask_token_for_obj_ptr=c.use_multimask_token_for_obj_ptr,
        )
        self.maskmem_tpos_enc = nn.Parameter(torch.zeros(c.num_maskmem, 1, 1, c.mem_dim))
        self.no_mem_embed = nn.Parameter(torch.zeros(1, 1, c.hidden_dim))
        self.no_mem_pos_enc = nn.Parameter(torch.zeros(1, 1, c.hidden_dim))
        if c.pred_obj_scores and c.use_obj_ptrs_in_encoder:
            self.no_obj_ptr = nn.Parameter(torch.zeros(1, c.hidden_dim))
        if c.no_obj_embed_spatial:
            self.no_obj_embed_spatial = nn.Parameter(torch.zeros(1, c.mem_dim))
        if c.use_obj_ptrs_in_encoder:
            self.mask_downsample = nn.Conv2d(1, 1, 4, 4)
            if c.use_mlp_for_obj_ptr_proj:
                self.obj_ptr_proj = MLP(c.hidden_dim, c.hidden_dim, c.hidden_dim, 3)
            else:
                self.obj_ptr_proj = nn.Linear(c.hidden_dim, c.hidden_dim)
        else:
            self.obj_ptr_proj = nn.Identity()
        if c.proj_tpos_enc_in_obj_ptrs:
            self.obj_ptr_tpos_proj = nn.Linear(c.hidden_dim, c.mem_dim)
        self._consts = {}

    def sine_pe(self, hw: int, dim: int, device) -> torch.Tensor:
        """[hw*hw, dim] fp32 2-D sine encoding on `device` (built once)."""
        key = (hw, dim, device)
        t = self._consts.get(key)
        if t is None:
            t = torch.as_tensor(sine_pos_embed_2d(hw, hw, dim).reshape(hw * hw, dim),
                                device=device)
            self._consts[key] = t
        return t

    # ------------------------------------------------------------------
    # image features
    # ------------------------------------------------------------------

    def forward_image(self, img: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      remat: Optional[bool] = None):
        """img [B, H, W, 3] (uint8 raw or normalised float) -> (feat_s0
        [B, 4s, 4s, C/8], feat_s1 [B, 2s, 2s, C/4], feat [B, s, s, C]) with
        the SAM decoder's high-res convs applied.

        generator: draws the trunk's drop-path masks (training; None =
        inference, which never draws). remat (default
        cfg.remat_image_encoder): run the encoder under
        torch.utils.checkpoint, the counterpart of the JAX package's
        nn.remat(ImageEncoder). The masks are drawn here, before the
        checkpointed call, and passed in, so the recomputation in the
        backward uses the same ones."""
        keep = None
        if generator is not None:
            keep = self.image_encoder.trunk.draw_drop_path(img.shape[0], generator,
                                                           img.device)
        remat = self.cfg.remat_image_encoder if remat is None else remat
        if remat and torch.is_grad_enabled():
            fpn = checkpoint(self.image_encoder, img, keep, use_reentrant=False)
        else:
            fpn = self.image_encoder(img, keep)
        if self.cfg.use_high_res_features_in_sam:
            dec = self.sam_mask_decoder
            return (conv_nhwc(dec.conv_s0, fpn[0]), conv_nhwc(dec.conv_s1, fpn[1]),
                    fpn[2])
        return None, None, fpn[-1]

    # ------------------------------------------------------------------
    # SAM heads
    # ------------------------------------------------------------------

    def forward_sam_heads(self, backbone_features, point_coords=None,
                          point_labels=None, mask_inputs=None,
                          high_res_features: Optional[List[torch.Tensor]] = None,
                          multimask_output: bool = False, gate_no_obj: bool = True,
                          training: bool = False):
        """-> (low_res_multimasks [B, M, s4, s4], high_res_multimasks
        [B, M, H, W], ious [B, M], low_res_masks [B, 1, s4, s4],
        high_res_masks [B, 1, H, W], obj_ptr [B, C], object_score_logits
        [B, 1]); mask logits fp32. training=True turns off the decoder's
        dynamic-stability multimask swap (SAM 2 gates it on
        ``not self.training``)."""
        c = self.cfg
        b = backbone_features.shape[0]
        dev = backbone_features.device
        if point_coords is None:
            point_coords = torch.zeros(b, 1, 2, device=dev)
            point_labels = -torch.ones(b, 1, dtype=torch.int32, device=dev)
        sam_mask_prompt = None
        if mask_inputs is not None:
            target = self.sam_prompt_encoder.mask_input_hw
            if tuple(mask_inputs.shape[1:3]) != target:
                m = resize_bilinear(mask_inputs[..., 0].float(), target,
                                    antialias=True)
                sam_mask_prompt = m[..., None]
            else:
                sam_mask_prompt = mask_inputs
        sparse, dense = self.sam_prompt_encoder(
            points=(point_coords, point_labels), masks=sam_mask_prompt)
        dense_pe = self.sam_prompt_encoder.get_dense_pe()
        low_res_multimasks, ious, sam_tokens, obj_logits = self.sam_mask_decoder(
            backbone_features, dense_pe, sparse, dense, multimask_output,
            high_res_features, training=training,
        )
        low_res_multimasks = low_res_multimasks.float()
        if c.pred_obj_scores and gate_no_obj:
            appearing = obj_logits > 0  # [B, 1]
            low_res_multimasks = torch.where(appearing[:, :, None, None],
                                             low_res_multimasks, NO_OBJ_SCORE)
        high_res_multimasks = resize_bilinear(low_res_multimasks,
                                              (c.image_size, c.image_size))
        sam_token = sam_tokens[:, 0]
        if multimask_output:
            best = ious.argmax(-1)
            rows = torch.arange(b, device=dev)
            low_res_masks = low_res_multimasks[rows, best][:, None]
            high_res_masks = high_res_multimasks[rows, best][:, None]
            if sam_tokens.shape[1] > 1:
                sam_token = sam_tokens[rows, best]
        else:
            low_res_masks, high_res_masks = low_res_multimasks, high_res_multimasks
        obj_ptr = self.obj_ptr_proj(sam_token)
        if c.pred_obj_scores:
            if c.soft_no_obj_ptr:
                lam = torch.sigmoid(obj_logits)
            else:
                lam = (obj_logits > 0).to(obj_ptr.dtype)
            if c.fixed_no_obj_ptr:
                obj_ptr = lam * obj_ptr
            if c.use_obj_ptrs_in_encoder:
                obj_ptr = obj_ptr + (1.0 - lam) * self.no_obj_ptr
        return (low_res_multimasks, high_res_multimasks, ious, low_res_masks,
                high_res_masks, obj_ptr, obj_logits)

    def use_mask_as_output(self, backbone_features,
                           high_res_features: Optional[List[torch.Tensor]],
                           mask_inputs: torch.Tensor):
        """The input mask [B, H, W, 1] as the output, bypassing the SAM
        heads' masks (SAM 2's _use_mask_as_output): +-10 logits, an
        antialiased 1/4 low-res copy, the object pointer from the SAM heads
        on the 4x-downsampled mask, and the object score from occupancy.
        Returns the 7-tuple of ``forward_sam_heads``."""
        c = self.cfg
        out_scale, out_bias = 20.0, -10.0
        mask_f = mask_inputs.float()
        high_res_masks = (mask_f * out_scale + out_bias)[..., 0][:, None]  # [B,1,H,W]
        low_res_masks = resize_bilinear(
            high_res_masks,
            (high_res_masks.shape[-2] // 4, high_res_masks.shape[-1] // 4),
            antialias=True,
        )
        b = mask_inputs.shape[0]
        ious = mask_f.new_ones(b, 1)
        if not c.use_obj_ptrs_in_encoder:
            obj_ptr = mask_f.new_zeros(b, c.hidden_dim)
        else:
            w = self.mask_downsample.weight
            small = conv_nhwc(self.mask_downsample, mask_inputs.to(w.dtype))
            obj_ptr = self.forward_sam_heads(backbone_features, mask_inputs=small,
                                             high_res_features=high_res_features)[5]
        lam = (mask_f.reshape(b, -1) > 0.0).any(1)[:, None].float()
        object_score_logits = out_scale * lam + out_bias
        if c.pred_obj_scores:
            if c.fixed_no_obj_ptr:
                obj_ptr = lam * obj_ptr
            if c.use_obj_ptrs_in_encoder:
                obj_ptr = obj_ptr + (1.0 - lam) * self.no_obj_ptr
        return (low_res_masks, high_res_masks, ious, low_res_masks, high_res_masks,
                obj_ptr, object_score_logits)

    # ------------------------------------------------------------------
    # memory
    # ------------------------------------------------------------------

    def no_mem_features(self, curr_feat: torch.Tensor) -> torch.Tensor:
        """Init-cond-frame path: add the learned no-memory embedding."""
        return curr_feat + self.no_mem_embed.reshape(1, 1, 1, -1).to(curr_feat.dtype)

    def _curr_tokens(self, curr_feat):
        b, h, w, cdim = curr_feat.shape
        curr = curr_feat.reshape(b, h * w, cdim)
        pos = self.sine_pe(h, cdim, curr.device).to(curr.dtype)
        return curr, pos[None].expand(b, -1, -1)

    def attend_memory(self, curr_feat, memory, memory_pos, memory_mask,
                      num_mem_frames: int, num_obj_ptr_tokens: int):
        """Gather-mode memory cross-attention. curr_feat [B, s, s, C];
        memory [B, Nk, mem_dim]; memory_pos [B or 1, Nk, mem_dim];
        memory_mask [Nk] or [B, Nk] bool."""
        b, h, w, cdim = curr_feat.shape
        curr, curr_pos = self._curr_tokens(curr_feat)
        if memory_mask.ndim == 1:
            memory_mask = memory_mask[None].expand(memory.shape[:2])
        if memory_pos.shape[0] == 1 and b > 1:
            memory_pos = memory_pos.expand(memory.shape)
        out = self.memory_attention(
            curr, memory, curr_pos=curr_pos, memory_pos=memory_pos,
            num_obj_ptr_tokens=num_obj_ptr_tokens,
            num_mem_frames=num_mem_frames, memory_mask=memory_mask,
        )
        return out.reshape(b, h, w, cdim)

    def attend_memory_banked(self, curr_feat, mem_k, mem_v, slots, tpos_vecs,
                             memory_mask):
        """Memory cross-attention reading K/V straight from bank rows.
        mem_k [Ktot+1, B, L, S, D]; mem_v [Ktot+1, B, S, Cm]; slots [T+1];
        tpos_vecs [T+1, Cm]; memory_mask [B, (T+1)*S] bool."""
        b, h, w, cdim = curr_feat.shape
        curr, curr_pos = self._curr_tokens(curr_feat)
        out = self.memory_attention(
            curr, curr_pos=curr_pos, memory_mask=memory_mask,
            banked={"mem_k": mem_k, "mem_v": mem_v, "slots": slots,
                    "tpos_vecs": tpos_vecs},
        )
        return out.reshape(b, h, w, cdim)

    def encode_memory(self, curr_feat, high_res_masks, object_score_logits,
                      binarize: bool = False, apply_non_overlap: bool = False):
        """[B, s, s, C] features + [B, 1, H, W] fp32 mask logits ->
        [B, s, s, mem_dim] memory."""
        c = self.cfg
        masks = high_res_masks
        if apply_non_overlap:
            masks = apply_non_overlapping_constraints(masks)
        if binarize:
            mask_for_mem = (masks > 0).float()
        else:
            mask_for_mem = torch.sigmoid(masks)
        if c.sigmoid_scale_for_mem_enc != 1.0:
            mask_for_mem = mask_for_mem * c.sigmoid_scale_for_mem_enc
        if c.sigmoid_bias_for_mem_enc != 0.0:
            mask_for_mem = mask_for_mem + c.sigmoid_bias_for_mem_enc
        dtype = self.memory_encoder.pix_feat_proj.weight.dtype
        maskmem = self.memory_encoder(curr_feat, mask_for_mem[:, 0, :, :, None].to(dtype),
                                      skip_mask_sigmoid=True)
        if c.no_obj_embed_spatial:
            is_obj = (object_score_logits > 0).to(maskmem.dtype)  # [B, 1]
            maskmem = maskmem + (1.0 - is_obj)[:, None, None, :] * (
                self.no_obj_embed_spatial[None, None].to(maskmem.dtype))
        return maskmem

    def project_memory_k(self, mem: torch.Tensor, spatial: bool = True):
        """Bank-write-time K cache: [B, S, Cm] memory -> [B, L, S, D]
        per-layer roped keys of (mem + spatial_pos). spatial=False projects
        obj-ptr staging tokens, whose positional term the caller added and
        which are never rotated."""
        c = self.cfg
        x = mem
        if spatial:
            hw = c.image_embedding_size
            x = mem + self.sine_pe(hw, c.mem_dim, mem.device).to(mem.dtype)[None]
        return self.memory_attention.project_k(x, roped=spatial)

    def obj_ptr_tpos(self, pos: torch.Tensor, t_diff_max: torch.Tensor):
        """Temporal PE for object pointers: pos [P] signed frame distances ->
        [P, mem_dim] fp32."""
        c = self.cfg
        if c.add_tpos_enc_to_obj_ptrs:
            tpos_dim = c.hidden_dim if c.proj_tpos_enc_in_obj_ptrs else c.mem_dim
            pe = get_1d_sine_pe(pos / t_diff_max.clamp_min(1).float(), dim=tpos_dim)
            if c.proj_tpos_enc_in_obj_ptrs:
                w = self.obj_ptr_tpos_proj.weight
                pe = self.obj_ptr_tpos_proj(pe.to(w.dtype))
            return pe.float()
        return torch.zeros(pos.shape[0], c.mem_dim, device=pos.device)


def apply_non_overlapping_constraints(pred_masks: torch.Tensor) -> torch.Tensor:
    """Keep only the argmax object per pixel. pred_masks [O, 1, H, W]."""
    if pred_masks.shape[0] == 1:
        return pred_masks
    max_obj = pred_masks.argmax(0, keepdim=True)
    batch_obj = torch.arange(pred_masks.shape[0], device=pred_masks.device)
    keep = max_obj == batch_obj[:, None, None, None]
    return torch.where(keep, pred_masks, pred_masks.clamp(max=-10.0))
