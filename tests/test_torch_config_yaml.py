"""The port's reference-YAML reader (config_yaml.py) against the JAX package's.

The SAM 2.1 model YAMLs are not in the repository, so each test writes a
reference-shaped document (the ``model:`` tree with the reference classes'
``_target_`` keys, as ``sam2/configs/sam2.1/*.yaml`` hold it) into tmp_path.
JAX's and the port's ``load_reference_yaml`` must give the same config field
by field, and, with the video predictor's overrides, the port's preset. A
bare load keeps SAM2Base's defaults; a SAM 2.0-shaped tree without the 2.1
flags takes the base defaults; ``++model`` overrides compose; unknown keys
raise; YAML 1.1's string '1e-6' is coerced; and a predictor built from a
YAML path gives the preset-built predictor's masks bit for bit.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
import yaml

from det_sam2_tpu import config_yaml as jy

from det_sam2_tpu_torch import config_yaml as ty
from det_sam2_tpu_torch.build import build_sam2_video_predictor
from det_sam2_tpu_torch.configs import MODEL_CONFIGS, tiny_test_config

PRESETS = ("hiera_t", "hiera_s", "hiera_b+", "hiera_l")
# flags SAM 2.0's model YAMLs do not set (sam2/configs/sam2/*.yaml)
SAM21_ONLY = ("no_obj_embed_spatial", "use_signed_tpos_enc_to_obj_ptrs",
              "proj_tpos_enc_in_obj_ptrs", "iou_prediction_use_sigmoid",
              "multimask_min_pt_num", "multimask_max_pt_num")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(tmp_path, tree, name="model.yaml") -> str:
    path = tmp_path / name
    path.write_text("# @package _global_\n\n" + yaml.safe_dump({"model": tree},
                                                              sort_keys=False))
    return str(path)


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _same(a, b):
    da, db = _fields(a), _fields(b)
    diff = {k: (da[k], db.get(k)) for k in da if da[k] != db.get(k)}
    assert not diff and set(da) == set(db), diff


@pytest.mark.parametrize("preset", PRESETS)
def test_reference_yaml_equals_jax_and_the_preset(tmp_path, preset):
    want = MODEL_CONFIGS[preset]()
    path = _write(tmp_path, ty.reference_model_tree(want))
    doc = yaml.safe_load(open(path))["model"]
    assert doc["_target_"] == "sam2.modeling.sam2_base.SAM2Base"
    assert "binarize_mask_from_pts_for_mem_enc" not in doc  # an override's
    got = ty.load_reference_yaml(path, ty.video_predictor_overrides())
    jax_cfg = jy.load_reference_yaml(path, jy.video_predictor_overrides())
    _same(got, jax_cfg)
    assert got == want
    assert ty.video_predictor_overrides() == jy.video_predictor_overrides()
    assert ty.image_predictor_overrides() == jy.image_predictor_overrides()


def test_bare_load_keeps_the_base_defaults(tmp_path):
    path = _write(tmp_path, ty.reference_model_tree(MODEL_CONFIGS["hiera_l"]()))
    cfg = ty.load_reference_yaml(path)
    _same(cfg, jy.load_reference_yaml(path))
    assert cfg.fill_hole_area == 0
    assert not cfg.binarize_mask_from_pts_for_mem_enc
    assert not cfg.dynamic_multimask_via_stability
    img = ty.load_reference_yaml(path, ty.image_predictor_overrides())
    _same(img, jy.load_reference_yaml(path, jy.image_predictor_overrides()))
    assert img.dynamic_multimask_via_stability and img.fill_hole_area == 0


def test_sam20_tree_takes_the_base_defaults(tmp_path):
    tree = ty.reference_model_tree(MODEL_CONFIGS["hiera_l"]())
    for k in SAM21_ONLY:
        del tree[k]
    path = _write(tmp_path, tree)
    cfg = ty.load_reference_yaml(path)
    _same(cfg, jy.load_reference_yaml(path))
    assert cfg.hiera.embed_dim == 144 and cfg.hiera.stages == (2, 6, 36, 4)
    for k in SAM21_ONLY:
        assert getattr(cfg, k) == ty._SAM2_BASE_DEFAULTS[k], k
    assert not cfg.no_obj_embed_spatial and not cfg.proj_tpos_enc_in_obj_ptrs


def test_overrides_compose(tmp_path):
    path = _write(tmp_path, ty.reference_model_tree(MODEL_CONFIGS["hiera_s"]()))
    ov = ["++model.image_size=512", "++model.num_maskmem=5", "++model.fill_hole_area=4",
          "model.image_encoder.trunk.drop_path_rate=0.1"]
    cfg = ty.load_reference_yaml(path, ov)
    _same(cfg, jy.load_reference_yaml(path, ov))
    assert (cfg.image_size, cfg.num_maskmem, cfg.fill_hole_area) == (512, 5, 4)
    assert cfg.hiera.drop_path_rate == 0.1
    assert cfg.memory_attention.rope_feat_sizes == (32, 32)
    with pytest.raises(ValueError, match="key=value"):
        ty.load_reference_yaml(path, ["++model.image_size"])
    with pytest.raises(ValueError, match="scalar"):
        ty.load_reference_yaml(path, ["++model.image_size.x=1"])


@pytest.mark.parametrize("case", ["model key", "decoder extra-arg", "no model tree"])
def test_unknown_keys_raise_as_in_jax(tmp_path, case):
    tree = ty.reference_model_tree(MODEL_CONFIGS["hiera_t"]())
    doc = {"model": tree}
    if case == "model key":
        tree["bogus"] = 1
        match = "bogus"
    elif case == "decoder extra-arg":
        tree["sam_mask_decoder_extra_args"] = {"dynamic_multimask_via_stability": True,
                                               "pred_iou_bogus": 1}
        match = "pred_iou_bogus"
    else:
        doc = {"trainer": {}}
        match = "model"
    path = tmp_path / "bad.yaml"
    path.write_text(yaml.safe_dump(doc))
    for mod in (ty, jy):
        with pytest.raises(ValueError, match=match):
            mod.load_reference_yaml(str(path))


def test_string_scientific_notation_is_coerced(tmp_path):
    """PyYAML (YAML 1.1) reads a dot-less '1e-6' as a string, as the SAM
    2.1 files write layer_scale_init_value."""
    tree = ty.reference_model_tree(MODEL_CONFIGS["hiera_b+"]())
    text = yaml.safe_dump({"model": tree}, sort_keys=False)
    text = text.replace("layer_scale_init_value: 1.0e-06", "layer_scale_init_value: 1e-6")
    text = text.replace("sigmoid_scale_for_mem_enc: 20.0", "sigmoid_scale_for_mem_enc: 2e1")
    path = tmp_path / "sci.yaml"
    path.write_text(text)
    raw = yaml.safe_load(text)["model"]
    assert raw["memory_encoder"]["fuser"]["layer"]["layer_scale_init_value"] == "1e-6"
    assert raw["sigmoid_scale_for_mem_enc"] == "2e1"
    cfg = ty.load_reference_yaml(str(path), ty.video_predictor_overrides())
    _same(cfg, jy.load_reference_yaml(str(path), jy.video_predictor_overrides()))
    assert cfg.memory_encoder.layer_scale_init_value == 1e-6
    assert cfg.sigmoid_scale_for_mem_enc == 20.0
    assert cfg == MODEL_CONFIGS["hiera_b+"]()


def _masks(vp, frames):
    """Box prompts on two objects at frame 0, then propagation."""
    state = vp.init_state(frames)
    vp.add_new_points_or_box(state, 0, 1, box=np.asarray([8.0, 10.0, 60.0, 70.0]))
    vp.add_new_points_or_box(state, 0, 2, box=np.asarray([64.0, 40.0, 120.0, 110.0]))
    return [(f, np.asarray(m)) for f, _, m in vp.propagate_in_video(state)]


def test_predictor_built_from_yaml_equals_the_preset(tmp_path):
    """A tiny-shaped YAML through build_sam2_video_predictor (with the
    bank capacities of tiny_test_config as keyword arguments) gives the
    config and the masks of the predictor built from the preset."""
    preset = tiny_test_config(fill_hole_area=8)
    tree = ty.reference_model_tree(preset)
    path = _write(tmp_path, copy.deepcopy(tree), "tiny.yaml")
    kw = dict(cond_bank_size=preset.cond_bank_size,
              noncond_bank_size=preset.noncond_bank_size, max_objects=preset.max_objects)
    from_yaml = build_sam2_video_predictor(path, dtype=torch.float32, device="cpu", **kw)
    ref = build_sam2_video_predictor(preset, dtype=torch.float32, device="cpu")
    assert from_yaml.engine.cfg == ref.engine.cfg
    frames = np.random.default_rng(0).integers(0, 255, (4, 128, 128, 3), np.uint8)
    got, want = _masks(from_yaml, frames), _masks(ref, frames)
    assert [f for f, _ in got] == [f for f, _ in want] == [0, 1, 2, 3]
    for (_, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)
