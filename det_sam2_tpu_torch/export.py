"""A port model -> the SAM 2.1 torch ``state_dict`` and checkpoint file.

Counterpart of the JAX package's ``export.py``. The port's ``SAM2Model``
keeps SAM 2.1's key layout, so its export is its state dict with every value
widened to fp32 on the CPU: the entry points build their models in bf16 (the
LayerNorms stay fp32), and the reference's checkpoints, like the JAX
package's export, are fp32. bf16 -> fp32 is exact, so a model built from the
exported file in bf16 holds the same weights bit for bit.
``save_torch_checkpoint`` writes ``{"model": state_dict}``, the layout that
SAM 2's ``build_sam.py`` and the port's ``build`` load strictly.

A model whose trunk ``ops.quant.quantize_trunk`` replaced holds int8 weights
and scales where SAM 2.1 has fp weights; as in the JAX package (whose
exporter finds no ``kernel`` in such a layer), the export raises KeyError
there. Export the model before quantising it.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def _sam2_model(model) -> nn.Module:
    """The ``SAM2Model`` of a model, an engine or a predictor."""
    model = getattr(model, "engine", model)
    return getattr(model, "model", model)


def to_torch_state_dict(model) -> Dict[str, torch.Tensor]:
    """The SAM 2.1 state dict of a ``SAM2Model`` (or of the engine or
    predictor holding one): contiguous fp32 CPU tensors, keys in the model's
    order."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in _sam2_model(model).state_dict().items():
        if key.endswith(("weight_q", "weight_scale")):
            raise KeyError(
                f"{key[:key.rindex('.')]}.weight: an int8 layer of quantize_trunk "
                "has no fp weight to export; export the model before quantising it")
        out[key] = value.detach().to("cpu", torch.float32, copy=True).contiguous()
    return out


def save_torch_checkpoint(model, path: str) -> None:
    """Write a SAM 2.1 checkpoint file, ``{"model": state_dict}`` of
    ``to_torch_state_dict(model)``."""
    torch.save({"model": to_torch_state_dict(model)}, path)
