"""The port's checkpoint export (export.py) against the JAX package's.

The same tiny-config weights go through JAX's ``export_sam2_base`` and, as a
port model built from them, through the port's ``to_torch_state_dict``: the
same keys and bit-equal fp32 arrays. A bf16 model (as the entry points
build it) exports its bf16 weights widened to fp32, and a bf16 model built
from that file holds the same bits. The saved file loads strictly through
the port's ``build`` and, where the reference is mounted, into the
reference's ``SAM2Base``. An int8 trunk has no fp weights to export: both
packages raise KeyError.
"""

import jax
import numpy as np
import pytest
import torch

from det_sam2_tpu.configs import tiny_test_config as jax_tiny_config
from det_sam2_tpu.export import export_sam2_base
from det_sam2_tpu.ops.quant import quantize_trunk as jax_quantize_trunk
from det_sam2_tpu.track import SAM2Engine as JaxEngine

from det_sam2_tpu_torch import convert, export
from det_sam2_tpu_torch.build import build_sam2_engine
from det_sam2_tpu_torch.configs import tiny_test_config
from det_sam2_tpu_torch.track import SAM2Engine
from det_sam2_tpu_torch.video_predictor import SAM2VideoPredictor

from tests.torch_ref import build_reference_sam2, reference_available


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """JAX tiny-config params (numpy), with a non-zero bias and LayerNorm
    scale so that every kind of leaf carries distinct values."""
    p = jax.tree_util.tree_map(np.array, JaxEngine(jax_tiny_config(), seed=5).params)
    rng = np.random.default_rng(5)
    for leaf in (p["sam_mask_decoder"]["pred_obj_score_head"]["layers_2"]["bias"],
                 p["memory_attention"]["norm"]["scale"]):
        leaf[:] = rng.standard_normal(leaf.shape).astype(np.float32)
    return p


def _engine(params, dtype):
    return SAM2Engine(tiny_test_config(), params=convert.from_jax_params(params),
                      dtype=dtype, device="cpu")


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("holder", ["model", "engine", "predictor"])
def test_export_equals_jax_export_bit_for_bit(params, holder):
    want = export_sam2_base(params)
    eng = _engine(params, torch.float32)
    obj = {"model": eng.model, "engine": eng, "predictor": SAM2VideoPredictor(eng)}[holder]
    got = export.to_torch_state_dict(obj)
    assert list(got) == list(eng.model.state_dict())
    assert set(got) == set(want)
    for k, v in want.items():
        t = got[k]
        assert t.dtype == torch.float32 and t.device.type == "cpu" and t.is_contiguous(), k
        np.testing.assert_array_equal(t.numpy(), v, err_msg=k)
    # a copy: writing into the export leaves the model as it was
    key = "no_mem_embed"
    got[key].add_(1.0)
    np.testing.assert_array_equal(eng.model.state_dict()[key].numpy(), want[key])


def test_bf16_model_is_widened_and_round_trips(params, tmp_path):
    want = export_sam2_base(params)
    eng = _engine(params, torch.bfloat16)
    held = [v.dtype for v in eng.model.state_dict().values()]
    assert held.count(torch.bfloat16) > len(held) // 2
    got = export.to_torch_state_dict(eng)
    assert set(got) == set(want)
    for k, v in want.items():
        # every weight was rounded to bf16 when the engine was built (its
        # LayerNorms are widened back to fp32 there): widened, exactly
        assert got[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got[k].numpy(), _bf16(v), err_msg=k)
    path = str(tmp_path / "bf16.pt")
    export.save_torch_checkpoint(eng, path)
    again = build_sam2_engine(tiny_test_config(), path, dtype=torch.bfloat16, device="cpu")
    before, after = eng.model.state_dict(), again.model.state_dict()
    assert list(before) == list(after)
    for k in before:
        assert before[k].dtype == after[k].dtype, k
        assert torch.equal(before[k], after[k]), k


def test_saved_file_loads_strictly_through_build(params, tmp_path):
    path = str(tmp_path / "exported.pt")
    export.save_torch_checkpoint(_engine(params, torch.float32).model, path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert list(ckpt) == ["model"]
    want = export_sam2_base(params)
    assert set(ckpt["model"]) == set(want)
    # SAM2Engine loads its params strictly
    eng = build_sam2_engine(tiny_test_config(), path, dtype=torch.float32, device="cpu")
    for k, v in eng.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


@pytest.mark.skipif(not reference_available(), reason="reference not mounted")
def test_saved_file_loads_into_the_reference_model(params, tmp_path):
    path = str(tmp_path / "exported.pt")
    export.save_torch_checkpoint(_engine(params, torch.float32), path)
    ref = build_reference_sam2(jax_tiny_config())
    res = ref.load_state_dict(torch.load(path, map_location="cpu",
                                         weights_only=True)["model"], strict=True)
    assert not res.missing_keys and not res.unexpected_keys


def test_int8_trunk_raises_keyerror_as_in_jax(params):
    with pytest.raises(KeyError):
        export_sam2_base(jax_quantize_trunk(params))
    eng = build_sam2_engine(tiny_test_config(), None, dtype=torch.float32, device="cpu",
                            quantize_int8=True)
    with pytest.raises(KeyError, match="attn.qkv.weight"):
        export.to_torch_state_dict(eng)
