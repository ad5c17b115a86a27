"""Model builders: the public construction API.

Counterpart of the JAX package's ``build.py``: a preset name, SAM 2.1
HF-hub id or ``SAM2Config`` plus a checkpoint -> ``SAM2Engine`` /
``SAM2ImagePredictor`` / ``SAM2VideoPredictor``. Checkpoints: a SAM 2.1
``.pt`` state dict (loaded strictly: the port keeps SAM 2.1's key layout),
the port trainer's checkpoint file or directory, or the JAX package's
``save_params_npz`` file (read with numpy). Options the port does not have
yet raise instead of doing something else: reference YAML configs and the
int8 trunk (each a ROADMAP item). The JAX trainer's orbax directories need
JAX to read and are refused with a pointer to ``save_params_npz``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Optional

import numpy as np
import torch

from det_sam2_tpu_torch import convert
from det_sam2_tpu_torch.configs import MODEL_CONFIGS, SAM2Config, with_image_size
from det_sam2_tpu_torch.image_predictor import SAM2ImagePredictor
from det_sam2_tpu_torch.track import SAM2Engine
from det_sam2_tpu_torch.video_predictor import SAM2VideoPredictor

# SAM 2.1 HF-hub ids -> preset names
HF_MODEL_IDS = {
    "facebook/sam2.1-hiera-tiny": "hiera_t",
    "facebook/sam2.1-hiera-small": "hiera_s",
    "facebook/sam2.1-hiera-base-plus": "hiera_b+",
    "facebook/sam2.1-hiera-large": "hiera_l",
}


def _resolve_cfg(model_cfg, **overrides) -> SAM2Config:
    # image_size goes through with_image_size: the memory-attention RoPE
    # grid tracks image_size / backbone_stride
    image_size = overrides.pop("image_size", None)

    def _sized(cfg: SAM2Config) -> SAM2Config:
        return cfg if image_size is None else with_image_size(cfg, image_size)

    if isinstance(model_cfg, SAM2Config):
        return _sized(dataclasses.replace(model_cfg, **overrides))
    if isinstance(model_cfg, str):
        if model_cfg.endswith((".yaml", ".yml")) and os.path.isfile(model_cfg):
            raise NotImplementedError(
                "reference YAML configs are not read by the port yet (ROADMAP "
                "Queue 1 item 11: config_yaml.py); pass a preset name, an HF id "
                "or a SAM2Config"
            )
        key = HF_MODEL_IDS.get(model_cfg, model_cfg)
        key = (key.replace("sam2.1_", "").replace(".yaml", "")
               .replace("configs/sam2.1/", ""))
        if key in MODEL_CONFIGS:
            return _sized(MODEL_CONFIGS[key](**overrides))
    raise ValueError(
        f"unknown model config {model_cfg!r}; use one of {list(MODEL_CONFIGS)}, "
        f"an HF id of {list(HF_MODEL_IDS)} or a SAM2Config"
    )


def load_params_npz(path: str) -> Dict:
    """A JAX ``save_params_npz`` checkpoint -> the nested parameter tree of
    numpy arrays ('/'-joined keys). Arrays recorded as bf16 were stored
    widened to fp32 and stay fp32 here."""
    params: Dict = {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            if key == "__dtypes__":
                continue
            node = params
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return params


def _load_params(checkpoint: Optional[str]):
    """A state dict in the SAM 2.1 layout, or None (seeded random init).
    checkpoint: a SAM 2.1 ``.pt``, the port trainer's ``ckpt_NNNN.pt`` or
    its checkpoint directory (the newest ``ckpt_*.pt`` there), or a JAX
    ``save_params_npz`` file."""
    if checkpoint is None:
        return None
    if os.path.isdir(checkpoint):
        names = sorted(n for n in os.listdir(checkpoint)
                       if re.fullmatch(r"ckpt_\d+\.pt", n))
        if not names:
            raise NotImplementedError(
                f"{checkpoint} holds no ckpt_NNNN.pt of the port's trainer; an "
                "orbax checkpoint directory of the JAX trainer needs JAX to "
                "read: save its params with the JAX package's save_params_npz "
                "and pass that .npz file")
        checkpoint = os.path.join(checkpoint, names[-1])
    if checkpoint.endswith(".npz"):
        return convert.from_jax_params(load_params_npz(checkpoint))
    sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
    return sd["model"] if "model" in sd else sd


def build_sam2_engine(
    model_cfg="hiera_s",
    checkpoint: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    quantize_int8: bool = False,
    plain_kernels: bool = False,
    **overrides,
) -> SAM2Engine:
    """The engine of a config (overrides: SAM2Config fields, image_size
    included) with the checkpoint's weights loaded strictly. device: None =
    CUDA (raises without a card). plain_kernels: SAM2Engine's."""
    if quantize_int8:
        raise NotImplementedError(
            "the int8 trunk is not ported yet (ROADMAP Queue 1 item 10)")
    cfg = _resolve_cfg(model_cfg, **overrides)
    return SAM2Engine(cfg, params=_load_params(checkpoint), dtype=dtype,
                      device=device, plain_kernels=plain_kernels)


def build_sam2(
    model_cfg="hiera_s",
    checkpoint: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    quantize_int8: bool = False,
    plain_kernels: bool = False,
    **overrides,
) -> SAM2ImagePredictor:
    """Image predictor (SAM 2's build_sam2). device: None = CUDA (raises
    without a card)."""
    return SAM2ImagePredictor(build_sam2_engine(
        model_cfg, checkpoint, dtype, device, quantize_int8, plain_kernels,
        **overrides))


def build_sam2_video_predictor(
    model_cfg="hiera_s",
    checkpoint: Optional[str] = None,
    dtype: torch.dtype = torch.bfloat16,
    device=None,
    quantize_int8: bool = False,
    plain_kernels: bool = False,
    **overrides,
) -> SAM2VideoPredictor:
    """Video predictor; SAM 2's video postprocessing defaults
    (binarize_mask_from_pts, fill_hole_area=8, dynamic multimask stability)
    are SAM2Config's defaults."""
    return SAM2VideoPredictor(build_sam2_engine(
        model_cfg, checkpoint, dtype, device, quantize_int8, plain_kernels,
        **overrides))
