"""Model and behaviour configuration for the SAM 2.1 family.

The port's own copy of the JAX package's ``configs.py``: the same plain
dataclasses, field names, defaults and presets, so a config built for one
package describes the same model in the other. The int8-trunk fields
(``quantize_int8``, ``quant_skip``) select a JAX/TPU code path the port does
not have yet and are left out.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class HieraConfig:
    """Hiera trunk (SAM 2 ``backbones/hieradet.py``)."""

    embed_dim: int = 96
    num_heads: int = 1
    stages: Tuple[int, ...] = (2, 3, 16, 3)
    dim_mul: float = 2.0
    head_mul: float = 2.0
    q_pool: int = 3
    q_stride: Tuple[int, int] = (2, 2)
    window_pos_embed_bkg_spatial_size: Tuple[int, int] = (14, 14)
    window_spec: Tuple[int, ...] = (8, 4, 14, 7)
    global_att_blocks: Tuple[int, ...] = (12, 16, 20)
    mlp_ratio: float = 4.0
    patch_kernel: int = 7
    patch_stride: int = 4
    patch_padding: int = 3
    # stochastic depth of both residual branches of every block, linear over
    # depth (training only: active when the trunk is handed a generator)
    drop_path_rate: float = 0.0

    @property
    def depth(self) -> int:
        return sum(self.stages)

    @property
    def stage_ends(self) -> Tuple[int, ...]:
        acc, out = 0, []
        for s in self.stages:
            acc += s
            out.append(acc - 1)
        return tuple(out)

    @property
    def q_pool_blocks(self) -> Tuple[int, ...]:
        return tuple(x + 1 for x in self.stage_ends[:-1])[: self.q_pool]

    @property
    def channel_list(self) -> Tuple[int, ...]:
        """Per-stage output dims, lowest resolution first."""
        dims = []
        d = self.embed_dim
        for i in range(len(self.stages)):
            if i > 0:
                d = int(d * self.dim_mul)
            dims.append(d)
        return tuple(reversed(dims))


@dataclasses.dataclass(frozen=True)
class FpnNeckConfig:
    """FPN neck (SAM 2 ``backbones/image_encoder.py``)."""

    d_model: int = 256
    backbone_channel_list: Tuple[int, ...] = (768, 384, 192, 96)
    fpn_top_down_levels: Tuple[int, ...] = (2, 3)
    fpn_interp_model: str = "nearest"
    fuse_type: str = "sum"
    pos_num_feats: int = 256


@dataclasses.dataclass(frozen=True)
class MemoryAttentionConfig:
    """4-layer RoPE self + cross transformer (SAM 2 ``memory_attention.py``)."""

    d_model: int = 256
    num_layers: int = 4
    dim_feedforward: int = 2048
    num_heads: int = 1
    rope_theta: float = 10000.0
    rope_feat_sizes: Tuple[int, int] = (64, 64)  # stride-16 map at 1024 input
    kv_in_dim: int = 64
    pos_enc_at_input: bool = True
    pos_enc_at_attn: bool = False
    pos_enc_at_cross_attn_keys: bool = True
    pos_enc_at_cross_attn_queries: bool = False
    activation: str = "relu"
    dropout: float = 0.1  # inference never applies it


@dataclasses.dataclass(frozen=True)
class MemoryEncoderConfig:
    """Mask downsampler + ConvNeXt fuser (SAM 2 ``memory_encoder.py``)."""

    out_dim: int = 64
    in_dim: int = 256
    mask_downsampler_kernel: int = 3
    mask_downsampler_stride: int = 2
    mask_downsampler_padding: int = 1
    mask_downsampler_total_stride: int = 16
    fuser_num_layers: int = 2
    fuser_dim: int = 256
    cx_kernel: int = 7
    cx_padding: int = 3
    layer_scale_init_value: float = 1e-6
    pos_num_feats: int = 64


@dataclasses.dataclass(frozen=True)
class SAM2Config:
    """Full model + behaviour flags (SAM 2.1 YAML values plus the video
    predictor overrides)."""

    hiera: HieraConfig = dataclasses.field(default_factory=HieraConfig)
    neck: FpnNeckConfig = dataclasses.field(default_factory=FpnNeckConfig)
    memory_attention: MemoryAttentionConfig = dataclasses.field(
        default_factory=MemoryAttentionConfig
    )
    memory_encoder: MemoryEncoderConfig = dataclasses.field(
        default_factory=MemoryEncoderConfig
    )

    image_size: int = 1024
    backbone_stride: int = 16
    scalp: int = 1  # drop lowest-res FPN level
    num_maskmem: int = 7
    mem_dim: int = 64
    hidden_dim: int = 256

    sigmoid_scale_for_mem_enc: float = 20.0
    sigmoid_bias_for_mem_enc: float = -10.0
    binarize_mask_from_pts_for_mem_enc: bool = True
    use_mask_input_as_output_without_sam: bool = True
    max_cond_frames_in_attn: int = 20
    directly_add_no_mem_embed: bool = True
    use_high_res_features_in_sam: bool = True
    multimask_output_in_sam: bool = True
    multimask_min_pt_num: int = 0
    multimask_max_pt_num: int = 1
    multimask_output_for_tracking: bool = True
    use_multimask_token_for_obj_ptr: bool = True
    iou_prediction_use_sigmoid: bool = True
    memory_temporal_stride_for_eval: int = 1
    non_overlap_masks_for_mem_enc: bool = False
    use_obj_ptrs_in_encoder: bool = True
    max_obj_ptrs_in_encoder: int = 16
    add_tpos_enc_to_obj_ptrs: bool = True
    proj_tpos_enc_in_obj_ptrs: bool = True
    use_signed_tpos_enc_to_obj_ptrs: bool = True
    only_obj_ptrs_in_the_past_for_eval: bool = True
    pred_obj_scores: bool = True
    pred_obj_scores_mlp: bool = True
    fixed_no_obj_ptr: bool = True
    soft_no_obj_ptr: bool = False
    use_mlp_for_obj_ptr_proj: bool = True
    no_obj_embed_spatial: bool = True

    # SAM decoder extra args (video predictor defaults)
    dynamic_multimask_via_stability: bool = True
    dynamic_multimask_stability_delta: float = 0.05
    dynamic_multimask_stability_thresh: float = 0.98

    # postprocessing
    fill_hole_area: int = 8

    # GELU form in the image encoder. None = auto: exact erf in fp32, tanh
    # in bf16 (the erf/tanh difference, ~1e-3 abs, is below bf16 resolution).
    use_approx_gelu: Optional[bool] = None

    # training: recompute the image encoder's activations in the backward
    # (torch.utils.checkpoint) instead of keeping them for the T*B frames
    remat_image_encoder: bool = False

    # Capacities of the ring-buffer memory bank (see state.py).
    cond_bank_size: int = 32
    cond_attn_size: int = 20  # cond tiles attended per frame
    noncond_bank_size: int = 32
    max_objects: int = 8

    @property
    def image_embedding_size(self) -> int:
        return self.image_size // self.backbone_stride

    @property
    def num_feature_levels(self) -> int:
        return 3 if self.use_high_res_features_in_sam else 1


def _hiera_t() -> HieraConfig:
    return HieraConfig(
        embed_dim=96,
        num_heads=1,
        stages=(1, 2, 7, 2),
        global_att_blocks=(5, 7, 9),
        window_pos_embed_bkg_spatial_size=(7, 7),
    )


def _hiera_s() -> HieraConfig:
    return HieraConfig(
        embed_dim=96,
        num_heads=1,
        stages=(1, 2, 11, 2),
        global_att_blocks=(7, 10, 13),
        window_pos_embed_bkg_spatial_size=(7, 7),
    )


def _hiera_bplus() -> HieraConfig:
    return HieraConfig(embed_dim=112, num_heads=2)


def _hiera_l() -> HieraConfig:
    return HieraConfig(
        embed_dim=144,
        num_heads=2,
        stages=(2, 6, 36, 4),
        global_att_blocks=(23, 33, 43),
        window_pos_embed_bkg_spatial_size=(7, 7),
        window_spec=(8, 4, 16, 8),
    )


def _cfg_from_hiera(h: HieraConfig, **kw) -> SAM2Config:
    dims = list(h.channel_list)  # lowest-res first, e.g. (768, 384, 192, 96)
    return SAM2Config(
        hiera=h, neck=FpnNeckConfig(backbone_channel_list=tuple(dims)), **kw
    )


def sam2_1_hiera_t(**kw) -> SAM2Config:
    return _cfg_from_hiera(_hiera_t(), **kw)


def sam2_1_hiera_s(**kw) -> SAM2Config:
    return _cfg_from_hiera(_hiera_s(), **kw)


def sam2_1_hiera_bplus(**kw) -> SAM2Config:
    return _cfg_from_hiera(_hiera_bplus(), **kw)


def sam2_1_hiera_l(**kw) -> SAM2Config:
    return _cfg_from_hiera(_hiera_l(), **kw)


def with_image_size(cfg: SAM2Config, size: int) -> SAM2Config:
    """The same model at another input resolution: the RoPE grid tracks
    image_size / backbone_stride."""
    s = size // cfg.backbone_stride
    return dataclasses.replace(
        cfg,
        image_size=size,
        memory_attention=dataclasses.replace(
            cfg.memory_attention, rope_feat_sizes=(s, s)
        ),
    )


def tiny_test_config(**kw) -> SAM2Config:
    """A miniature config for fast unit tests (not a reference size)."""
    h = HieraConfig(
        embed_dim=16,
        num_heads=1,
        stages=(1, 1, 2, 1),
        global_att_blocks=(3,),
        window_pos_embed_bkg_spatial_size=(7, 7),
        window_spec=(8, 4, 14, 7),
    )
    defaults = dict(
        image_size=128,
        fill_hole_area=0,
        cond_bank_size=4,
        noncond_bank_size=8,
        max_objects=2,
    )
    defaults.update(kw)
    return with_image_size(_cfg_from_hiera(h, **defaults), defaults["image_size"])
