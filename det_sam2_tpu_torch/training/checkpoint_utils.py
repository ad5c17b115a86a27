"""Checkpoint key filtering and frozen parameters.

Counterpart of the JAX package's ``training/checkpoint_utils.py`` (after the
reference's training/utils/checkpoint_utils.py: CkptInclude / ExcludeKernel,
with_check_parameter_frozen, check_load_state_dict_errors,
load_state_dict_into_model). Names are the port's state-dict names, the SAM
2.1 layout (``image_encoder.trunk.blocks.0.attn.qkv.weight``), which is the
layout the reference's YAML patterns are written against; the JAX package
matches the same patterns against dotted flax paths instead.

Freezing follows the JAX package's ``freeze_wrapper``: a frozen parameter
still has its gradient and still counts in the global-norm clip (the JAX
chain zeroes its update after ``clip_by_global_norm``), but it is left out
of the AdamW groups, so neither Adam nor the weight decay moves it.
"""

from __future__ import annotations

import contextlib
import fnmatch
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn


def param_names(model: nn.Module) -> List[str]:
    """The model's state-dict names, in order."""
    return list(model.state_dict().keys())


def unix_pattern_to_parameter_names(patterns: Sequence[str], names) -> set:
    """Every name that matches one of the unix patterns (reference
    checkpoint_utils.py:63-78)."""
    names = list(names)
    out = set()
    for pat in patterns:
        out |= set(fnmatch.filter(names, pat))
    return out


def filter_params_matching_unix_pattern(patterns: Sequence[str],
                                        state_dict: Mapping) -> Dict:
    """The sub-state-dict of the entries whose name matches a pattern
    (reference :81-100)."""
    keep = unix_pattern_to_parameter_names(patterns, state_dict.keys())
    return {k: v for k, v in state_dict.items() if k in keep}


def exclude_params_matching_unix_pattern(patterns: Sequence[str],
                                         state_dict: Mapping) -> Dict:
    """The state dict without the entries whose name matches a pattern
    (CkptExcludeKernel, reference :162-186)."""
    drop = unix_pattern_to_parameter_names(patterns, state_dict.keys())
    return {k: v for k, v in state_dict.items() if k not in drop}


def check_load_state_dict_errors(
    missing_keys: Sequence[str],
    unexpected_keys: Sequence[str],
    strict: bool = True,
    ignore_missing_keys: Optional[Sequence[str]] = None,
    ignore_unexpected_keys: Optional[Sequence[str]] = None,
) -> None:
    """Raise KeyError on unexpected keys, and on missing keys when strict,
    after dropping the ignored patterns (reference :300-330)."""
    missing = list(missing_keys)
    unexpected = list(unexpected_keys)
    if ignore_missing_keys:
        ignored = unix_pattern_to_parameter_names(ignore_missing_keys, missing)
        missing = [k for k in missing if k not in ignored]
    if ignore_unexpected_keys:
        ignored = unix_pattern_to_parameter_names(ignore_unexpected_keys, unexpected)
        unexpected = [k for k in unexpected if k not in ignored]
    if unexpected or (strict and missing):
        raise KeyError(
            "State key mismatch."
            + (f" Unexpected keys: {sorted(unexpected)}." if unexpected else "")
            + (f" Missing keys: {sorted(missing)}." if missing else "")
        )


def load_state_dict_into_model(
    loaded: Mapping,
    model: nn.Module,
    strict: bool = True,
    ignore_missing_keys: Optional[Sequence[str]] = None,
    ignore_unexpected_keys: Optional[Sequence[str]] = None,
    include_patterns: Optional[Sequence[str]] = None,
    exclude_patterns: Optional[Sequence[str]] = None,
) -> nn.Module:
    """Copy a (possibly partial) {name: array or tensor} dict into the
    model's parameters and buffers, in place (reference
    load_state_dict_into_model :333-361 with the include / exclude kernels).
    Each value keeps the model tensor's dtype and device; a shape that
    differs raises ValueError. Returns the model."""
    own = model.state_dict()
    flat = dict(loaded)
    if include_patterns:
        flat = filter_params_matching_unix_pattern(include_patterns, flat)
    if exclude_patterns:
        flat = exclude_params_matching_unix_pattern(exclude_patterns, flat)
    unexpected = [k for k in flat if k not in own]
    missing = [k for k in own if k not in flat]
    check_load_state_dict_errors(
        missing, unexpected, strict=strict,
        ignore_missing_keys=ignore_missing_keys,
        ignore_unexpected_keys=ignore_unexpected_keys,
    )
    with torch.no_grad():
        for name, value in flat.items():
            dst = own[name]
            v = value if torch.is_tensor(value) else torch.from_numpy(np.asarray(value))
            if tuple(v.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: checkpoint shape {tuple(v.shape)} != "
                                 f"parameter shape {tuple(dst.shape)}")
            dst.copy_(v.to(dtype=dst.dtype))
    return model


def freeze_mask(model: nn.Module, patterns: Sequence[str]) -> Dict[str, bool]:
    """{parameter name: True where it matches a freeze pattern}."""
    frozen = unix_pattern_to_parameter_names(patterns, dict(model.named_parameters()))
    return {name: name in frozen for name, _ in model.named_parameters()}


def freeze_wrapper(optimizer, model: nn.Module, patterns: Sequence[str]):
    """Freeze the parameters matching the patterns in a ``TrainOptimizer``
    made for `model` and not stepped yet: they leave its AdamW groups (no
    Adam update, no weight decay) but keep their place in the global-norm
    clip, as the JAX package's freeze_wrapper zeroes their update after the
    clip. Returns the optimizer."""
    optimizer.freeze(name for name, m in freeze_mask(model, patterns).items() if m)
    return optimizer


def _summary(model: nn.Module, patterns: Sequence[str]) -> np.ndarray:
    named = dict(model.named_parameters())
    keep = unix_pattern_to_parameter_names(patterns, named)
    return np.asarray([float(named[n].detach().double().sum()) for n in sorted(keep)])


@contextlib.contextmanager
def check_parameter_frozen(model: nn.Module, patterns: Sequence[str],
                           disabled: bool = False):
    """Raise ValueError if a parameter matching the patterns changed inside
    the block (reference with_check_parameter_frozen :120-160). The port's
    parameters change in place, so the module itself is observed."""
    if not patterns or disabled:
        yield
        return
    before = _summary(model, patterns)
    yield
    after = _summary(model, patterns)
    if not np.allclose(before, after, atol=1e-6):
        raise ValueError(
            "frozen parameters were updated inside the guarded region "
            f"(patterns: {list(patterns)})"
        )
