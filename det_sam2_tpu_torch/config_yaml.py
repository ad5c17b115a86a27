"""Reference Hydra-YAML configs -> the port's ``SAM2Config``.

The port's copy of the JAX package's ``config_yaml.py``. It maps a SAM 2
model YAML (``sam2/configs/{sam2,sam2.1}/*.yaml``) onto a
:class:`~det_sam2_tpu_torch.configs.SAM2Config`, so a reference checkpoint
and its YAML build a predictor. The semantics are the reference builder's:

  * the YAML's ``model:`` tree is Hydra ``instantiate`` input; ``_target_``
    names classes the port does not need (its modules are fixed), every
    other key is a constructor argument;
  * keys MISSING from the YAML take the reference constructor defaults
    (``sam2/modeling/sam2_base.py:24-120``), not this package's dataclass
    defaults, which bake in the SAM 2.1 + video-predictor values;
  * ``++model.x=y`` override strings compose on top (``build_sam.py:92-99``);
  * the ``apply_postprocessing`` / video-predictor injections
    (``build_sam.py:121-136``) are the override strings of
    :func:`video_predictor_overrides` / :func:`image_predictor_overrides`.

The YAML's RoPE ``feat_sizes`` is not read: the reference recomputes the
rotary table whenever the sequence length differs, so the grid is always
image_size / backbone_stride, as ``configs.with_image_size`` sets it.

PyYAML is imported inside the functions that parse, as in the JAX package.
:func:`reference_model_tree` goes the other way: the ``model:`` tree that a
SAM 2.1 YAML holds for a config.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

from det_sam2_tpu_torch.configs import (
    FpnNeckConfig,
    HieraConfig,
    MemoryAttentionConfig,
    MemoryEncoderConfig,
    SAM2Config,
)

# reference constructor defaults of model-level flags missing from a YAML
# (sam2/modeling/sam2_base.py:24-120); SAM 2.1 YAMLs set most of them,
# SAM 2.0 YAMLs rely on several
_SAM2_BASE_DEFAULTS = dict(
    num_maskmem=7,
    image_size=512,
    backbone_stride=16,
    sigmoid_scale_for_mem_enc=1.0,
    sigmoid_bias_for_mem_enc=0.0,
    binarize_mask_from_pts_for_mem_enc=False,
    use_mask_input_as_output_without_sam=False,
    max_cond_frames_in_attn=20,
    directly_add_no_mem_embed=False,
    use_high_res_features_in_sam=False,
    multimask_output_in_sam=False,
    multimask_min_pt_num=1,
    multimask_max_pt_num=1,
    multimask_output_for_tracking=False,
    use_multimask_token_for_obj_ptr=False,
    iou_prediction_use_sigmoid=False,
    memory_temporal_stride_for_eval=1,
    non_overlap_masks_for_mem_enc=False,
    use_obj_ptrs_in_encoder=False,
    max_obj_ptrs_in_encoder=16,
    add_tpos_enc_to_obj_ptrs=True,
    proj_tpos_enc_in_obj_ptrs=False,
    use_signed_tpos_enc_to_obj_ptrs=False,
    only_obj_ptrs_in_the_past_for_eval=False,
    pred_obj_scores=False,
    pred_obj_scores_mlp=False,
    fixed_no_obj_ptr=False,
    soft_no_obj_ptr=False,
    use_mlp_for_obj_ptr_proj=False,
    no_obj_embed_spatial=False,
)

# model-level keys of machinery the port replaces outright
_IGNORED_MODEL_KEYS = {
    "_target_",
    "compile_image_encoder",
    "image_encoder",
    "memory_attention",
    "memory_encoder",
    "sam_mask_decoder_extra_args",
}

# decoder extra-args (sam_mask_decoder_extra_args) that map onto flat
# SAM2Config fields
_DECODER_EXTRA_KEYS = {
    "dynamic_multimask_via_stability",
    "dynamic_multimask_stability_delta",
    "dynamic_multimask_stability_thresh",
}


def video_predictor_overrides() -> list:
    """The ++model overrides build_sam2_video_predictor injects
    (build_sam.py:121-136, apply_postprocessing=True)."""
    return [
        "++model.sam_mask_decoder_extra_args.dynamic_multimask_via_stability=true",
        "++model.sam_mask_decoder_extra_args.dynamic_multimask_stability_delta=0.05",
        "++model.sam_mask_decoder_extra_args.dynamic_multimask_stability_thresh=0.98",
        "++model.binarize_mask_from_pts_for_mem_enc=true",
        "++model.fill_hole_area=8",
    ]


def image_predictor_overrides() -> list:
    """build_sam2's apply_postprocessing overrides (build_sam.py:92-99)."""
    return [
        "++model.sam_mask_decoder_extra_args.dynamic_multimask_via_stability=true",
        "++model.sam_mask_decoder_extra_args.dynamic_multimask_stability_delta=0.05",
        "++model.sam_mask_decoder_extra_args.dynamic_multimask_stability_thresh=0.98",
    ]


def _apply_override(tree: Dict, spec: str) -> None:
    """Apply one Hydra-style ``[++]model.a.b=value`` override in place."""
    key, eq, raw = spec.partition("=")
    if not eq or not key:
        raise ValueError(f"override {spec!r} is not key=value")
    key = key.lstrip("+")
    import yaml

    value = yaml.safe_load(raw)
    parts = key.split(".")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
        if not isinstance(node, dict):
            raise ValueError(f"override {spec!r} descends through a scalar")
    node[parts[-1]] = value


def _tup(x):
    return tuple(x) if isinstance(x, (list, tuple)) else x


def _coerce(value, default):
    """YAML 1.1 reads dot-less scientific notation ('1e-6') as a string;
    coerce scalars to the default's numeric type."""
    if isinstance(default, bool) or value is None:
        return value
    if isinstance(default, float):
        return float(value)
    if isinstance(default, int) and not isinstance(value, (list, tuple)):
        return int(value)
    return value


def _deep_dict(node):
    if isinstance(node, Mapping):
        return {k: _deep_dict(v) for k, v in node.items()}
    if isinstance(node, list):
        return list(node)
    return node


def config_from_model_tree(model: Mapping, overrides: Sequence[str] = ()) -> SAM2Config:
    """Map a parsed reference ``model:`` tree (+ overrides) to SAM2Config."""
    tree: Dict = {"model": _deep_dict(model)}
    for spec in overrides:
        _apply_override(tree, spec)
    m = tree["model"]

    enc = m.get("image_encoder", {})
    trunk = enc.get("trunk", {})
    neck = enc.get("neck", {})
    pos = neck.get("position_encoding", {})

    hiera = HieraConfig(
        embed_dim=trunk.get("embed_dim", 96),
        num_heads=trunk.get("num_heads", 1),
        stages=_tup(trunk.get("stages", (2, 3, 16, 3))),
        dim_mul=trunk.get("dim_mul", 2.0),
        head_mul=trunk.get("head_mul", 2.0),
        q_pool=trunk.get("q_pool", 3),
        q_stride=_tup(trunk.get("q_stride", (2, 2))),
        window_pos_embed_bkg_spatial_size=_tup(
            trunk.get("window_pos_embed_bkg_spatial_size", (14, 14))),
        window_spec=_tup(trunk.get("window_spec", (8, 4, 14, 7))),
        global_att_blocks=_tup(trunk.get("global_att_blocks", (12, 16, 20))),
        drop_path_rate=trunk.get("drop_path_rate", 0.0),
    )
    neck_cfg = FpnNeckConfig(
        d_model=neck.get("d_model", 256),
        backbone_channel_list=_tup(neck.get("backbone_channel_list", hiera.channel_list)),
        fpn_top_down_levels=_tup(neck.get("fpn_top_down_levels", (2, 3))),
        fpn_interp_model=neck.get("fpn_interp_model", "bilinear"),
        fuse_type=neck.get("fuse_type", "sum"),
        pos_num_feats=pos.get("num_pos_feats", 256),
    )

    ma = m.get("memory_attention", {})
    layer = ma.get("layer", {})
    self_att = layer.get("self_attention", {})
    cross_att = layer.get("cross_attention", {})
    image_size = m.get("image_size", _SAM2_BASE_DEFAULTS["image_size"])
    backbone_stride = m.get("backbone_stride", _SAM2_BASE_DEFAULTS["backbone_stride"])
    s = image_size // backbone_stride
    ma_cfg = MemoryAttentionConfig(
        d_model=ma.get("d_model", 256),
        num_layers=ma.get("num_layers", 4),
        dim_feedforward=layer.get("dim_feedforward", 2048),
        num_heads=self_att.get("num_heads", 1),
        rope_theta=self_att.get("rope_theta", 10000.0),
        rope_feat_sizes=(s, s),  # derived, not read (module docstring)
        kv_in_dim=cross_att.get("kv_in_dim", 64),
        pos_enc_at_input=ma.get("pos_enc_at_input", True),
        pos_enc_at_attn=layer.get("pos_enc_at_attn", False),
        pos_enc_at_cross_attn_keys=layer.get("pos_enc_at_cross_attn_keys", True),
        pos_enc_at_cross_attn_queries=layer.get("pos_enc_at_cross_attn_queries", False),
        activation=layer.get("activation", "relu"),
        dropout=layer.get("dropout", 0.1),
    )

    me = m.get("memory_encoder", {})
    me_pos = me.get("position_encoding", {})
    md = me.get("mask_downsampler", {})
    fuser = me.get("fuser", {})
    cx = fuser.get("layer", {})
    me_cfg = MemoryEncoderConfig(
        out_dim=me.get("out_dim", 64),
        in_dim=me.get("in_dim", 256),
        mask_downsampler_kernel=md.get("kernel_size", 3),
        mask_downsampler_stride=md.get("stride", 2),
        mask_downsampler_padding=md.get("padding", 1),
        fuser_num_layers=fuser.get("num_layers", 2),
        fuser_dim=cx.get("dim", 256),
        cx_kernel=cx.get("kernel_size", 7),
        cx_padding=cx.get("padding", 3),
        layer_scale_init_value=_coerce(cx.get("layer_scale_init_value", 1e-6), 1e-6),
        pos_num_feats=me_pos.get("num_pos_feats", 64),
    )

    extra = m.get("sam_mask_decoder_extra_args") or {}
    unknown_extra = set(extra) - _DECODER_EXTRA_KEYS
    if unknown_extra:
        raise ValueError(f"unsupported sam_mask_decoder_extra_args {sorted(unknown_extra)}")

    flags = dict(_SAM2_BASE_DEFAULTS)
    extra_flat = {}
    for k, v in m.items():
        if k in _IGNORED_MODEL_KEYS:
            continue
        if k in flags:
            flags[k] = _coerce(v, _SAM2_BASE_DEFAULTS[k])
        elif k in SAM2Config.__dataclass_fields__:
            extra_flat[k] = v  # e.g. fill_hole_area via an override
        else:
            raise ValueError(f"unknown model config key {k!r}")
    flags.update({k: extra[k] for k in extra})
    # the reference MaskDecoder's default when the extra args are absent
    # (sam2/modeling/sam/mask_decoder.py:15)
    flags.setdefault("dynamic_multimask_via_stability", False)

    return SAM2Config(
        hiera=hiera,
        neck=neck_cfg,
        memory_attention=ma_cfg,
        memory_encoder=me_cfg,
        scalp=enc.get("scalp", 0),
        mem_dim=me_cfg.out_dim,
        hidden_dim=ma_cfg.d_model,
        **flags,
        **extra_flat,
    )


def load_reference_yaml(path: str, overrides: Sequence[str] = ()) -> SAM2Config:
    """Parse a reference model YAML file into a SAM2Config. ``overrides``
    are Hydra-style ``++model.x=y`` strings; :func:`video_predictor_overrides`
    / :func:`image_predictor_overrides` are the reference builders'
    apply_postprocessing injections."""
    import yaml

    with open(path) as f:
        doc = yaml.safe_load(f)
    if not isinstance(doc, Mapping) or "model" not in doc:
        raise ValueError(f"{path} has no top-level 'model:' tree")
    cfg = config_from_model_tree(doc["model"], overrides)
    # SAM2Config's fill_hole_area default is the video predictor's 8; a bare
    # YAML load (build_sam2) has none: the video predictor's override
    # injects it
    if not any("fill_hole_area" in o for o in overrides):
        cfg = dataclasses.replace(cfg, fill_hole_area=0)
    return cfg


# ---------------------------------------------------------------------------
# the other way: a config as the model tree of a SAM 2.1 YAML
# ---------------------------------------------------------------------------

# the reference Hiera constructor's defaults: a SAM 2.1 YAML names a trunk
# argument only where it differs from them (embed_dim and num_heads always)
_HIERA_DEFAULTS = dict(stages=(2, 3, 16, 3), dim_mul=2.0, head_mul=2.0, q_pool=3,
                       q_stride=(2, 2), window_pos_embed_bkg_spatial_size=(14, 14),
                       window_spec=(8, 4, 14, 7), global_att_blocks=(12, 16, 20))
# the model-level flags every SAM 2.1 YAML sets (sam2/configs/sam2.1/*.yaml)
_SAM21_FLAGS = ("num_maskmem", "image_size", "sigmoid_scale_for_mem_enc",
                "sigmoid_bias_for_mem_enc", "use_mask_input_as_output_without_sam",
                "directly_add_no_mem_embed", "no_obj_embed_spatial",
                "use_high_res_features_in_sam", "multimask_output_in_sam",
                "iou_prediction_use_sigmoid", "use_obj_ptrs_in_encoder",
                "add_tpos_enc_to_obj_ptrs", "proj_tpos_enc_in_obj_ptrs",
                "use_signed_tpos_enc_to_obj_ptrs", "only_obj_ptrs_in_the_past_for_eval",
                "pred_obj_scores", "pred_obj_scores_mlp", "fixed_no_obj_ptr",
                "multimask_output_for_tracking", "use_multimask_token_for_obj_ptr",
                "multimask_min_pt_num", "multimask_max_pt_num", "use_mlp_for_obj_ptr_proj")


def _pos_enc(num_pos_feats: int) -> dict:
    return {"_target_": "sam2.modeling.position_encoding.PositionEmbeddingSine",
            "num_pos_feats": num_pos_feats, "normalize": True, "scale": None,
            "temperature": 10000}


def _rope_attention(ma: MemoryAttentionConfig, cross: bool) -> dict:
    d = {"_target_": "sam2.modeling.sam.transformer.RoPEAttention",
         "rope_theta": ma.rope_theta, "feat_sizes": list(ma.rope_feat_sizes)}
    if cross:
        d["rope_k_repeat"] = True
    d.update(embedding_dim=ma.d_model, num_heads=ma.num_heads, downsample_rate=1,
             dropout=ma.dropout)
    if cross:
        d["kv_in_dim"] = ma.kv_in_dim
    return d


def reference_model_tree(cfg: SAM2Config) -> dict:
    """The ``model:`` tree of a SAM 2.1 model YAML for cfg, with the
    reference classes' ``_target_`` keys and the keys those YAMLs set (the
    video-predictor postprocessing is left to the overrides, as there).
    ``load_reference_yaml`` of it with :func:`video_predictor_overrides`
    gives cfg back for the SAM 2.1 presets."""
    h, n, ma, me = cfg.hiera, cfg.neck, cfg.memory_attention, cfg.memory_encoder
    trunk = {"_target_": "sam2.modeling.backbones.hieradet.Hiera",
             "embed_dim": h.embed_dim, "num_heads": h.num_heads}
    for k, default in _HIERA_DEFAULTS.items():
        if getattr(h, k) != default:
            v = getattr(h, k)
            trunk[k] = list(v) if isinstance(v, tuple) else v
    return {
        "_target_": "sam2.modeling.sam2_base.SAM2Base",
        "image_encoder": {
            "_target_": "sam2.modeling.backbones.image_encoder.ImageEncoder",
            "scalp": cfg.scalp,
            "trunk": trunk,
            "neck": {
                "_target_": "sam2.modeling.backbones.image_encoder.FpnNeck",
                "position_encoding": _pos_enc(n.pos_num_feats),
                "d_model": n.d_model,
                "backbone_channel_list": list(n.backbone_channel_list),
                "fpn_top_down_levels": list(n.fpn_top_down_levels),
                "fpn_interp_model": n.fpn_interp_model,
            },
        },
        "memory_attention": {
            "_target_": "sam2.modeling.memory_attention.MemoryAttention",
            "d_model": ma.d_model,
            "pos_enc_at_input": ma.pos_enc_at_input,
            "layer": {
                "_target_": "sam2.modeling.memory_attention.MemoryAttentionLayer",
                "activation": ma.activation,
                "dim_feedforward": ma.dim_feedforward,
                "dropout": ma.dropout,
                "pos_enc_at_attn": ma.pos_enc_at_attn,
                "self_attention": _rope_attention(ma, cross=False),
                "d_model": ma.d_model,
                "pos_enc_at_cross_attn_keys": ma.pos_enc_at_cross_attn_keys,
                "pos_enc_at_cross_attn_queries": ma.pos_enc_at_cross_attn_queries,
                "cross_attention": _rope_attention(ma, cross=True),
            },
            "num_layers": ma.num_layers,
        },
        "memory_encoder": {
            "_target_": "sam2.modeling.memory_encoder.MemoryEncoder",
            "out_dim": me.out_dim,
            "position_encoding": _pos_enc(me.pos_num_feats),
            "mask_downsampler": {
                "_target_": "sam2.modeling.memory_encoder.MaskDownSampler",
                "kernel_size": me.mask_downsampler_kernel,
                "stride": me.mask_downsampler_stride,
                "padding": me.mask_downsampler_padding,
            },
            "fuser": {
                "_target_": "sam2.modeling.memory_encoder.Fuser",
                "layer": {
                    "_target_": "sam2.modeling.memory_encoder.CXBlock",
                    "dim": me.fuser_dim,
                    "kernel_size": me.cx_kernel,
                    "padding": me.cx_padding,
                    "layer_scale_init_value": me.layer_scale_init_value,
                    "use_dwconv": True,
                },
                "num_layers": me.fuser_num_layers,
            },
        },
        **{k: getattr(cfg, k) for k in _SAM21_FLAGS},
        "compile_image_encoder": False,
    }
