"""SAM mask decoder: output tokens + two-way transformer + hypernetworks.

Counterpart of the JAX package's ``modeling/mask_decoder.py``, with the SAM
2.1 state-dict names. The 2x2 stride-2 upscaling convs are
``nn.ConvTranspose2d`` (the JAX package writes the same operator as a dense
layer plus depth-to-space).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from det_sam2_tpu_torch.modeling.layers import MLP, LayerNorm, conv_nhwc, exact_gelu
from det_sam2_tpu_torch.modeling.transformer import TwoWayTransformer


class MaskDecoder(nn.Module):
    def __init__(self, transformer_dim: int = 256, num_multimask_outputs: int = 3,
                 iou_head_depth: int = 3, iou_head_hidden_dim: int = 256,
                 use_high_res_features: bool = False,
                 iou_prediction_use_sigmoid: bool = False,
                 dynamic_multimask_via_stability: bool = False,
                 dynamic_multimask_stability_delta: float = 0.05,
                 dynamic_multimask_stability_thresh: float = 0.98,
                 pred_obj_scores: bool = False, pred_obj_scores_mlp: bool = False,
                 use_multimask_token_for_obj_ptr: bool = False):
        super().__init__()
        d = transformer_dim
        self.num_mask_tokens = num_multimask_outputs + 1
        self.use_high_res_features = use_high_res_features
        self.dynamic_multimask_via_stability = dynamic_multimask_via_stability
        self.stability_delta = dynamic_multimask_stability_delta
        self.stability_thresh = dynamic_multimask_stability_thresh
        self.pred_obj_scores = pred_obj_scores
        self.use_multimask_token_for_obj_ptr = use_multimask_token_for_obj_ptr

        self.iou_token = nn.Embedding(1, d)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, d)
        if pred_obj_scores:
            self.obj_score_token = nn.Embedding(1, d)
        self.transformer = TwoWayTransformer(depth=2, embedding_dim=d,
                                             num_heads=8, mlp_dim=2048)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(d, d // 4, 2, 2),
            LayerNorm(d // 4, eps=1e-6),
            nn.GELU(),
            nn.ConvTranspose2d(d // 4, d // 8, 2, 2),
            nn.GELU(),
        )
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(d, d, d // 8, 3) for _ in range(self.num_mask_tokens)
        )
        self.iou_prediction_head = MLP(d, iou_head_hidden_dim,
                                       self.num_mask_tokens, iou_head_depth,
                                       sigmoid_output=iou_prediction_use_sigmoid)
        if pred_obj_scores:
            self.pred_obj_score_head = (MLP(d, d, 1, 3) if pred_obj_scores_mlp
                                        else nn.Linear(d, 1))
        if use_high_res_features:
            # applied in SAM2Model.forward_image; stored here, as in SAM 2.1
            self.conv_s0 = nn.Conv2d(d, d // 8, 1)
            self.conv_s1 = nn.Conv2d(d, d // 4, 1)

    def predict_masks(self, image_embeddings, image_pe, sparse, dense,
                      high_res_features: Optional[List[torch.Tensor]] = None):
        """image_embeddings [B, H, W, C], image_pe [H, W, C], sparse
        [B, N, C], dense [B, H, W, C] -> (masks [B, M, 4H, 4W] fp32, iou
        [B, M], mask tokens [B, M, C], object score logits [B, 1])."""
        b = sparse.shape[0]
        s = 1 if self.pred_obj_scores else 0
        toks = [self.iou_token.weight, self.mask_tokens.weight]
        if self.pred_obj_scores:
            toks.insert(0, self.obj_score_token.weight)
        output_tokens = torch.cat(toks, dim=0)[None].expand(b, -1, -1)
        tokens = torch.cat([output_tokens, sparse.to(output_tokens.dtype)], dim=1)

        h, w, c = image_embeddings.shape[1:4]
        src = (image_embeddings + dense).reshape(b, h * w, c)
        pe = image_pe.reshape(1, h * w, c).expand(b, -1, -1).to(src.dtype)
        hs, src = self.transformer(src, pe, tokens)
        iou_token_out = hs[:, s, :]
        mask_tokens_out = hs[:, s + 1: s + 1 + self.num_mask_tokens, :]

        src = src.reshape(b, h, w, c)
        up = self.output_upscaling
        if not self.use_high_res_features:
            x = exact_gelu(up[1](conv_nhwc(up[0], src)))
            x = exact_gelu(conv_nhwc(up[3], x))
        else:
            feat_s0, feat_s1 = high_res_features
            x = exact_gelu(up[1](conv_nhwc(up[0], src) + feat_s1))
            x = exact_gelu(conv_nhwc(up[3], x) + feat_s0)
        hyper_in = torch.stack(
            [mlp(mask_tokens_out[:, i])
             for i, mlp in enumerate(self.output_hypernetworks_mlps)], dim=1,
        )  # [B, M, C/8]
        masks = torch.einsum("bmc,bhwc->bmhw", hyper_in.float(), x.float())
        iou_pred = self.iou_prediction_head(iou_token_out)
        if self.pred_obj_scores:
            obj_logits = self.pred_obj_score_head(hs[:, 0, :])
        else:
            obj_logits = 10.0 * hs.new_ones(b, 1)
        return masks, iou_pred, mask_tokens_out, obj_logits

    def _stability_scores(self, mask_logits: torch.Tensor) -> torch.Tensor:
        flat = mask_logits.flatten(-2)
        d = self.stability_delta
        area_i = (flat > d).sum(-1).float()
        area_u = (flat > -d).sum(-1).float()
        return torch.where(area_u > 0, area_i / area_u.clamp_min(1.0), 1.0)

    def _dynamic_multimask(self, all_mask_logits, all_iou_scores):
        """Token 0's mask if it is stable, else the best multimask output."""
        multi_logits = all_mask_logits[:, 1:]
        multi_iou = all_iou_scores[:, 1:]
        best = multi_iou.argmax(-1)
        rows = torch.arange(best.shape[0], device=best.device)
        best_logits = multi_logits[rows, best][:, None]
        best_iou = multi_iou[rows, best][:, None]
        single_logits = all_mask_logits[:, 0:1]
        single_iou = all_iou_scores[:, 0:1]
        stable = self._stability_scores(single_logits) >= self.stability_thresh
        out_logits = torch.where(stable[..., None, None], single_logits, best_logits)
        out_iou = torch.where(stable, single_iou, best_iou.to(single_iou.dtype))
        return out_logits, out_iou

    def forward(self, image_embeddings, image_pe, sparse, dense,
                multimask_output: bool, high_res_features=None,
                training: bool = False):
        """training=True turns off the dynamic-stability swap of the single
        mask output (SAM 2 applies it only when not training)."""
        masks, iou_pred, mask_tokens_out, obj_logits = self.predict_masks(
            image_embeddings, image_pe, sparse, dense, high_res_features)
        if multimask_output:
            out_masks, out_iou = masks[:, 1:], iou_pred[:, 1:]
        elif self.dynamic_multimask_via_stability and not training:
            out_masks, out_iou = self._dynamic_multimask(masks, iou_pred)
        else:
            out_masks, out_iou = masks[:, 0:1], iou_pred[:, 0:1]
        if multimask_output and self.use_multimask_token_for_obj_ptr:
            sam_tokens_out = mask_tokens_out[:, 1:]
        else:
            sam_tokens_out = mask_tokens_out[:, 0:1]
        return out_masks, out_iou, sam_tokens_out, obj_logits
