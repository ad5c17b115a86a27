"""Weight bridge: the JAX package's flax parameter tree -> the port's
state dict, and the port's seeded random init.

The state dict keeps the SAM 2.1 torch key layout, so a SAM 2.1 checkpoint's
``model`` entry loads into ``SAM2Model`` strictly as well. Layout rules (the
port's own copy of the JAX package's export rules):

  Dense kernel [in, out]              -> Linear weight [out, in]
  int8 kernel_q [in, out], kernel_scale [1, out]
                                       -> weight_q [out, in], weight_scale [out]
  Conv kernel [kh, kw, in, out] (HWIO) -> Conv2d weight [out, in, kh, kw]
  ConvTranspose2x kernel [in, out, 2, 2] (stored torch-style) -> verbatim
  LayerNorm scale / bias               -> weight / bias
  NHWC parameters [1, H, W, C]         -> NCHW [1, C, H, W]
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from det_sam2_tpu_torch.modeling.layers import LayerNorm


def _n(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear(out: Dict, prefix: str, p: Dict) -> None:
    if "kernel_q" in p:  # an int8 layer of the JAX package's quantize_trunk
        out[f"{prefix}.weight_q"] = np.asarray(p["kernel_q"], np.int8).T
        out[f"{prefix}.weight_scale"] = _n(p["kernel_scale"]).reshape(-1)
    else:
        out[f"{prefix}.weight"] = _n(p["kernel"]).T
    if "bias" in p:
        out[f"{prefix}.bias"] = _n(p["bias"])


def _conv2d(out: Dict, prefix: str, p: Dict) -> None:
    out[f"{prefix}.weight"] = _n(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        out[f"{prefix}.bias"] = _n(p["bias"])


def _conv_transpose(out: Dict, prefix: str, p: Dict) -> None:
    out[f"{prefix}.weight"] = _n(p["kernel"])
    out[f"{prefix}.bias"] = _n(p["bias"])


def _layernorm(out: Dict, prefix: str, p: Dict) -> None:
    out[f"{prefix}.weight"] = _n(p["scale"])
    out[f"{prefix}.bias"] = _n(p["bias"])


def _mlp(out: Dict, prefix: str, p: Dict) -> None:
    for name, leaf in p.items():
        _linear(out, f"{prefix}.layers.{int(name.split('_')[1])}", leaf)


def _attention(out: Dict, prefix: str, p: Dict) -> None:
    for k in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(out, f"{prefix}.{k}", p[k])


def _image_encoder(out: Dict, p: Dict, prefix: str = "image_encoder.") -> None:
    t = p["trunk"]
    tp = f"{prefix}trunk."
    out[f"{tp}pos_embed"] = _n(t["pos_embed"]).transpose(0, 3, 1, 2)
    out[f"{tp}pos_embed_window"] = _n(t["pos_embed_window"]).transpose(0, 3, 1, 2)
    _conv2d(out, f"{tp}patch_embed.proj", t["patch_embed"]["proj"])
    for name, blk in t.items():
        if not name.startswith("blocks_"):
            continue
        bp = f"{tp}blocks.{int(name.split('_')[1])}"
        _layernorm(out, f"{bp}.norm1", blk["norm1"])
        _layernorm(out, f"{bp}.norm2", blk["norm2"])
        _linear(out, f"{bp}.attn.qkv", blk["attn"]["qkv"])
        _linear(out, f"{bp}.attn.proj", blk["attn"]["proj"])
        _mlp(out, f"{bp}.mlp", blk["mlp"])
        if "proj" in blk:
            _linear(out, f"{bp}.proj", blk["proj"])
    for name, leaf in p["neck"].items():
        _conv2d(out, f"{prefix}neck.convs.{int(name.split('_')[1])}.conv", leaf)


def _prompt_encoder(out: Dict, p: Dict, prefix: str = "sam_prompt_encoder.") -> None:
    out[f"{prefix}pe_layer.positional_encoding_gaussian_matrix"] = _n(p["pe_gaussian"])
    out[f"{prefix}not_a_point_embed.weight"] = _n(p["not_a_point_embed"])
    out[f"{prefix}no_mask_embed.weight"] = _n(p["no_mask_embed"])
    pts = _n(p["point_embeds"])  # [4, C]
    for i in range(4):
        out[f"{prefix}point_embeddings.{i}.weight"] = pts[i:i + 1]
    _conv2d(out, f"{prefix}mask_downscaling.0", p["mask_downscaling_conv0"])
    _layernorm(out, f"{prefix}mask_downscaling.1", p["mask_downscaling_ln0"])
    _conv2d(out, f"{prefix}mask_downscaling.3", p["mask_downscaling_conv1"])
    _layernorm(out, f"{prefix}mask_downscaling.4", p["mask_downscaling_ln1"])
    _conv2d(out, f"{prefix}mask_downscaling.6", p["mask_downscaling_conv2"])


def _mask_decoder(out: Dict, p: Dict, prefix: str = "sam_mask_decoder.") -> None:
    out[f"{prefix}iou_token.weight"] = _n(p["iou_token"])
    out[f"{prefix}mask_tokens.weight"] = _n(p["mask_tokens"])
    tr, tp = p["transformer"], f"{prefix}transformer."
    for name, layer in tr.items():
        if not name.startswith("layers_"):
            continue
        lp = f"{tp}layers.{int(name.split('_')[1])}"
        for a in ("self_attn", "cross_attn_token_to_image",
                  "cross_attn_image_to_token"):
            _attention(out, f"{lp}.{a}", layer[a])
        for k in ("norm1", "norm2", "norm3", "norm4"):
            _layernorm(out, f"{lp}.{k}", layer[k])
        _mlp(out, f"{lp}.mlp", layer["mlp"])
    _attention(out, f"{tp}final_attn_token_to_image", tr["final_attn_token_to_image"])
    _layernorm(out, f"{tp}norm_final_attn", tr["norm_final_attn"])
    _conv_transpose(out, f"{prefix}output_upscaling.0", p["upscale_conv1"])
    _layernorm(out, f"{prefix}output_upscaling.1", p["upscale_ln"])
    _conv_transpose(out, f"{prefix}output_upscaling.3", p["upscale_conv2"])
    _mlp(out, f"{prefix}iou_prediction_head", p["iou_prediction_head"])
    for name, leaf in p.items():
        if name.startswith("hypernet_"):
            _mlp(out, f"{prefix}output_hypernetworks_mlps.{int(name.split('_')[1])}",
                 leaf)
    if "obj_score_token" in p:
        out[f"{prefix}obj_score_token.weight"] = _n(p["obj_score_token"])
    if "pred_obj_score_head" in p:
        head = p["pred_obj_score_head"]
        if len(head) == 1:  # a single Linear (pred_obj_scores_mlp=False)
            _linear(out, f"{prefix}pred_obj_score_head", head["layers_0"])
        else:
            _mlp(out, f"{prefix}pred_obj_score_head", head)
    if "conv_s0" in p:
        _conv2d(out, f"{prefix}conv_s0", p["conv_s0"])
        _conv2d(out, f"{prefix}conv_s1", p["conv_s1"])


def _memory_attention(out: Dict, p: Dict, prefix: str = "memory_attention.") -> None:
    _layernorm(out, f"{prefix}norm", p["norm"])
    for name, layer in p.items():
        if not name.startswith("layers_"):
            continue
        lp = f"{prefix}layers.{int(name.split('_')[1])}"
        _attention(out, f"{lp}.self_attn", layer["self_attn"])
        _attention(out, f"{lp}.cross_attn_image", layer["cross_attn_image"])
        for k in ("norm1", "norm2", "norm3"):
            _layernorm(out, f"{lp}.{k}", layer[k])
        _linear(out, f"{lp}.linear1", layer["linear1"])
        _linear(out, f"{lp}.linear2", layer["linear2"])


def _memory_encoder(out: Dict, p: Dict, prefix: str = "memory_encoder.") -> None:
    _conv2d(out, f"{prefix}pix_feat_proj", p["pix_feat_proj"])
    ds = p["mask_downsampler"]
    n = sum(1 for k in ds if k.startswith("conv_") and k != "conv_out")
    for i in range(n):
        _conv2d(out, f"{prefix}mask_downsampler.encoder.{3 * i}", ds[f"conv_{i}"])
        _layernorm(out, f"{prefix}mask_downsampler.encoder.{3 * i + 1}", ds[f"ln_{i}"])
    _conv2d(out, f"{prefix}mask_downsampler.encoder.{3 * n}", ds["conv_out"])
    for name, layer in p["fuser"].items():
        lp = f"{prefix}fuser.layers.{int(name.split('_')[1])}"
        _conv2d(out, f"{lp}.dwconv", layer["dwconv"])
        _layernorm(out, f"{lp}.norm", layer["norm"])
        _linear(out, f"{lp}.pwconv1", layer["pwconv1"])
        _linear(out, f"{lp}.pwconv2", layer["pwconv2"])
        out[f"{lp}.gamma"] = _n(layer["gamma"])
    if "out_proj" in p:
        _conv2d(out, f"{prefix}out_proj", p["out_proj"])


def from_jax_params(params: Dict) -> Dict[str, torch.Tensor]:
    """JAX ``SAM2Model`` params (nested dicts of arrays) -> the port's
    ``SAM2Model`` state dict (fp32 tensors, SAM 2.1 keys)."""
    out: Dict[str, np.ndarray] = {}
    _image_encoder(out, params["image_encoder"])
    _prompt_encoder(out, params["sam_prompt_encoder"])
    _mask_decoder(out, params["sam_mask_decoder"])
    _memory_attention(out, params["memory_attention"])
    _memory_encoder(out, params["memory_encoder"])
    for k in ("maskmem_tpos_enc", "no_mem_embed", "no_mem_pos_enc",
              "no_obj_ptr", "no_obj_embed_spatial"):
        if k in params:
            out[k] = _n(params[k])
    if "mask_downsample" in params:
        _conv2d(out, "mask_downsample", params["mask_downsample"])
        proj = params["obj_ptr_proj"]
        if len(proj) > 1:
            _mlp(out, "obj_ptr_proj", proj)
        else:
            _linear(out, "obj_ptr_proj", proj["layers_0"])
    if "obj_ptr_tpos_proj" in params:
        _linear(out, "obj_ptr_tpos_proj", params["obj_ptr_tpos_proj"])
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def init_params(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded random weights for `model`, the rule of the JAX engine's
    ``_init_params``: ones for LayerNorm weights, ``gamma`` and int8 scales,
    zeros for biases and int8 weights, N(0, 0.02) for everything else,
    drawn from ``numpy.random.default_rng(seed)`` in state-dict order."""
    rng = np.random.default_rng(seed)
    ln = {f"{name}.weight" for name, m in model.named_modules()
          if isinstance(m, LayerNorm)}
    out = {}
    for key, t in model.state_dict().items():
        if not t.is_floating_point():
            out[key] = torch.zeros(t.shape, dtype=t.dtype)
            continue
        if key in ln or key.endswith(("gamma", "weight_scale")):
            v = np.ones(t.shape, np.float32)
        elif key.endswith("bias"):
            v = np.zeros(t.shape, np.float32)
        else:
            v = rng.standard_normal(t.shape).astype(np.float32) * 0.02
        out[key] = torch.from_numpy(v)
    return out
