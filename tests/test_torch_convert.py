"""Weight bridge of the PyTorch port: JAX params -> SAM 2.1 state dict.

The converted state dict must load strictly into the port's SAM2Model and
equal, key for key and value for value, what the JAX package's own exporter
(det_sam2_tpu.export.to_torch_state_dict) writes for the same params.
"""

import jax
import numpy as np
import pytest
import torch

from det_sam2_tpu.configs import tiny_test_config as jax_tiny_config
from det_sam2_tpu.export import to_torch_state_dict
from det_sam2_tpu.track import SAM2Engine as JaxEngine

from det_sam2_tpu_torch import convert
from det_sam2_tpu_torch.configs import tiny_test_config
from det_sam2_tpu_torch.modeling.layers import LayerNorm
from det_sam2_tpu_torch.modeling.sam2_base import SAM2Model


@pytest.fixture(scope="module")
def jax_params():
    params = JaxEngine(jax_tiny_config(), seed=7).params
    return jax.tree_util.tree_map(np.asarray, params)


def test_from_jax_params_loads_strictly(jax_params):
    model = SAM2Model(tiny_test_config())
    sd = convert.from_jax_params(jax_params)
    model.load_state_dict(sd, strict=True)  # raises on a missing/extra key
    for k, v in model.state_dict().items():
        assert v.shape == sd[k].shape, k


def test_matches_jax_exporter(jax_params):
    ours = convert.from_jax_params(jax_params)
    ref = to_torch_state_dict(jax_params)
    assert set(ours) == set(ref)
    for k in ref:
        # a pure relayout: values must be bit-identical
        assert torch.equal(ours[k], ref[k].float()), k


def test_seeded_init_follows_the_jax_rule():
    model = SAM2Model(tiny_test_config())
    a = convert.init_params(model, seed=3)
    b = convert.init_params(model, seed=3)
    c = convert.init_params(model, seed=4)
    assert set(a) == set(model.state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["no_mem_embed"], c["no_mem_embed"])
    ln = {f"{n}.weight" for n, m in model.named_modules() if isinstance(m, LayerNorm)}
    assert ln
    for k, v in a.items():
        if k in ln or k.endswith("gamma"):
            assert torch.all(v == 1), k
        elif k.endswith("bias"):
            assert torch.all(v == 0), k
    w = a["memory_attention.layers.0.linear1.weight"]
    assert abs(float(w.std()) - 0.02) < 1e-3
    model.load_state_dict(a, strict=True)


@pytest.mark.parametrize("name", ["t", "s", "bplus", "l", "tiny"])
def test_configs_copy_the_jax_presets(name):
    """The port's own configs describe the same models as the JAX ones."""
    import dataclasses

    from det_sam2_tpu import configs as jc
    from det_sam2_tpu_torch import configs as tc

    fn = "tiny_test_config" if name == "tiny" else f"sam2_1_hiera_{name}"
    ours, theirs = getattr(tc, fn)(), getattr(jc, fn)()

    def fields(cfg):
        return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}

    for sub in (None, "hiera", "neck", "memory_attention", "memory_encoder"):
        a = ours if sub is None else getattr(ours, sub)
        b = theirs if sub is None else getattr(theirs, sub)
        for k, v in fields(a).items():
            if not dataclasses.is_dataclass(v):
                assert getattr(b, k) == v, (sub, k)
    s = tc.with_image_size(ours, 768)
    assert s.memory_attention.rope_feat_sizes == (48, 48)
