"""The port's W8A8 int8 trunk (ops/quant.py) against the JAX package's.

The primitives (weight and row quantisation, the int8 products and the fp32
epilogue) and QuantLinear give JAX's bits on the same inputs; the port's
quantize_trunk of the converted state dict equals the conversion of JAX's
quantize_trunk tree; the tiny int8 encode is held against JAX's int8 engine
and against the port's own fp engine at the JAX package's fidelity bars
(tests/test_quant.py); build_sam2_video_predictor makes an int8 predictor.
fp32 on the CPU with TF32 off and one torch thread.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from det_sam2_tpu.configs import tiny_test_config as jax_tiny_config
from det_sam2_tpu.ops import quant as jq
from det_sam2_tpu.track import SAM2Engine as JaxEngine

from det_sam2_tpu_torch import convert
from det_sam2_tpu_torch.build import build_sam2_video_predictor
from det_sam2_tpu_torch.configs import tiny_test_config
from det_sam2_tpu_torch.ops import quant
from det_sam2_tpu_torch.state import init_bank
from det_sam2_tpu_torch.track import SAM2Engine

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The tiny int8 encode against JAX's int8 engine. Both quantise the same
# activations, but the fp32 work before each quantisation (LayerNorm,
# attention, GELU) rounds in another order in XLA and in torch (the fp
# engines differ by <= 1.6e-7 here), so an activation within that distance
# of a rounding tie lands on the other int8 level in one of the two, and a
# global block carries that one level to every token after it. Measured
# over four seeded images: the two high-resolution levels (std 0.0035-
# 0.0085) within 1.1e-5, <= 0.01 % of their elements off by more than 1e-5;
# the top level (std 0.048) within 7.5e-4, 21-95 % of its elements off by
# more than 1e-5 (one flipped level before the global block).
INT8_ATOL = 2e-3
DIFF_FLOOR = 1e-5
HIGH_RES_DIFFERENT_SHARE = 1e-3
# the JAX package's fidelity bars of the int8 trunk against the fp trunk
REL_ERR, COSINE, IOU = 0.12, 0.99, 0.99


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(dtype, seed=0):
    """x [3, 20, 96] with outlier rows, w [96, 128] (JAX layout) with an
    outlier output channel and an all-zero one."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 20, 96)).astype(np.float32)
    x[1, 4] *= 300.0
    x[2, 7] = 0.0
    w = (rng.standard_normal((96, 128)) * 0.05).astype(np.float32)
    w[:, 7] *= 100.0
    w[:, 9] = 0.0
    b = rng.standard_normal(128).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return xt, xj, w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_int8_primitives_equal_jax_bit_for_bit(dtype):
    xt, xj, w, _ = _inputs(dtype)
    jw_q, jw_s = jq.quantize_weight(jnp.asarray(w))
    w_q, w_s = quant.quantize_weight(torch.from_numpy(w.T.copy()))
    assert w_q.dtype == torch.int8 and w_s.dtype == torch.float32
    np.testing.assert_array_equal(w_q.numpy().T, np.asarray(jw_q))
    np.testing.assert_array_equal(w_s.numpy(), np.asarray(jw_s)[0])

    jx_q, js = jq.quantize_rows(xj)
    x_q, s = quant.quantize_rows(xt)
    np.testing.assert_array_equal(x_q.numpy(), np.asarray(jx_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert int(x_q.abs().max()) == 127 and int(x_q[2, 7].abs().max()) == 0

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    got = quant.int8_matmul(xt, w_q, w_s, dtype)
    want = jq.int8_matmul(xj, jw_q, jw_s, jdt)
    assert got.dtype == dtype and got.shape == (3, 20, 128)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    got = quant.int8_matmul_prequant(x_q, s, w_q, w_s, dtype)
    want = jq.int8_matmul_prequant(jx_q, js, jw_q, jw_s, jdt)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_int8_product_is_exact():
    """The int32 sums are exact: the product equals int64 arithmetic, at
    the largest magnitudes int8 can give."""
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-127, 128, (40, 3072), generator=g, dtype=torch.int8)
    a[0] = 127
    w = torch.randint(-127, 128, (24, 3072), generator=g, dtype=torch.int8)
    w[0] = 127
    got = quant.int8_mm(a, w)
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), a.long() @ w.long().T)
    assert int(got[0, 0]) == 127 * 127 * 3072


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_quant_linear_equals_jax_quant_dense(dtype):
    """QuantLinear cast to the model's type keeps its scales fp32, as
    QuantDense's epilogue does, and adds the bias in the output type."""
    xt, xj, w, b = _inputs(dtype, seed=1)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jw_q, jw_s = jq.quantize_weight(jnp.asarray(w))
    params = {"params": {"kernel_q": jw_q, "kernel_scale": jw_s, "bias": jnp.asarray(b)}}
    want = jq.QuantDense(128, dtype=jdt).apply(params, xj)
    out = {}  # the layout rule of convert.from_jax_params
    convert._linear(out, "l", {"kernel_q": np.asarray(jw_q),
                               "kernel_scale": np.asarray(jw_s), "bias": b})
    layer = quant.QuantLinear(96, 128)
    layer.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in out.items()})
    layer = layer.to(dtype)
    assert layer.weight_scale.dtype == torch.float32 and layer.weight_q.dtype == torch.int8
    assert layer.bias.dtype == dtype
    got = layer(xt)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


@pytest.fixture(scope="module")
def fp_setup():
    cfg = jax_tiny_config()
    jeng = JaxEngine(cfg, seed=3)
    params = jax.tree_util.tree_map(np.array, jeng.params)
    params["sam_mask_decoder"]["pred_obj_score_head"]["layers_2"]["bias"][:] = 1.0
    return cfg, params


@pytest.mark.parametrize("skip", [("proj",), (), ("qkv", "mlp")],
                         ids=["default", "none", "qkv-mlp"])
def test_quantize_trunk_equals_jax(fp_setup, skip):
    _, params = fp_setup
    want = convert.from_jax_params(jq.quantize_trunk(params, skip=skip))
    sd = convert.from_jax_params(params)
    got = quant.quantize_trunk(sd, skip=skip)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k
    kinds = {quant.block_dense_kind(k) for k in sd}
    assert kinds == {"", "qkv", "attn_out", "mlp", "proj"}
    for k in sd:
        kind = quant.block_dense_kind(k)
        if kind and kind not in skip:
            assert k not in got and k[:-len("weight")] + "weight_q" in got, k
        else:
            assert torch.equal(got[k], sd[k]), k
    assert "image_encoder.trunk.patch_embed.proj.weight" in got
    assert quant.block_dense_kind("image_encoder.trunk.patch_embed.proj.weight") == ""


@pytest.fixture(scope="module")
def int8_engines(fp_setup):
    """JAX's int8 engine, the port's int8 engine on the same int8 weights
    and the port's fp engine, all fp32 at the tiny config."""
    cfg, params = fp_setup
    qcfg = dataclasses.replace(cfg, hiera=dataclasses.replace(cfg.hiera, quantize_int8=True))
    jq_eng = JaxEngine(qcfg, params=jax.tree_util.tree_map(
        jnp.asarray, jq.quantize_trunk(params, skip=qcfg.hiera.quant_skip)))
    tcfg = tiny_test_config()
    tq = dataclasses.replace(tcfg, hiera=dataclasses.replace(tcfg.hiera, quantize_int8=True))
    sd = convert.from_jax_params(params)
    q = SAM2Engine(tq, params=quant.quantize_trunk(sd, skip=tq.hiera.quant_skip),
                   device="cpu", banked=False)
    fp = SAM2Engine(tcfg, params=sd, device="cpu", banked=False)
    return jq_eng, q, fp


def _image(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 255, (1, 128, 128, 3)).astype(np.uint8)


def test_int8_encode_matches_jax_int8_engine(int8_engines):
    jq_eng, q, _ = int8_engines
    img = _image(2)
    want = jq_eng.encode_image(jnp.asarray(img))
    quant.reset_counts()
    got = q.encode_image(img)
    # 5 blocks: qkv, attn out, 2 MLP layers each; the 3 dim-change projs fp
    assert quant.INT8_PRODUCTS["int8_mm"] == 5 * 4
    for level, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape and np.isfinite(g).all()
        diff = np.abs(g - w)
        assert float(diff.max()) <= INT8_ATOL, float(diff.max())
        if level < 2:  # the top level's share is not bounded (see INT8_ATOL)
            share = float((diff > DIFF_FLOOR).mean())
            assert share <= HIGH_RES_DIFFERENT_SHARE, (level, share)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def test_int8_encode_and_masks_close_to_fp(int8_engines):
    _, q, fp = int8_engines
    img = _image(2)
    for a, b in zip(fp.encode_image(img), q.encode_image(img)):
        a, b = a.numpy().ravel(), b.numpy().ravel()
        assert _rel_err(b, a) < REL_ERR
        cos = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
        assert cos > COSINE, cos
    rng = np.random.default_rng(3)
    img = (rng.standard_normal((1, 128, 128, 3)) * 40 + 90).clip(0, 255).astype(np.uint8)
    boxes = np.asarray([[[20.0, 25.0], [90.0, 100.0]]], np.float32)
    labels = np.asarray([[2, 3]], np.int32)
    masks = []
    for eng in (fp, q):
        bank = init_bank(eng.cfg, num_objects=1, attend_cond_tiles=1, device="cpu")
        out = eng.prompt_step(eng.encode_image(img), bank, 0, 100, boxes, labels,
                              is_init=True)
        masks.append(out["pred_masks"].numpy() > 0)
    union = np.logical_or(*masks).sum()
    assert union > 0
    assert np.logical_and(*masks).sum() / union > IOU


def test_build_int8_video_predictor():
    vp = build_sam2_video_predictor(tiny_test_config(), quantize_int8=True,
                                    dtype=torch.float32, device="cpu")
    cfg = vp.engine.cfg
    assert cfg.hiera.quantize_int8 and cfg.hiera.quant_skip == ("proj",)
    sd = vp.engine.model.state_dict()
    qkv = "image_encoder.trunk.blocks.0.attn.qkv"
    assert f"{qkv}.weight_q" in sd and f"{qkv}.weight" not in sd
    assert sd[f"{qkv}.weight_q"].dtype == torch.int8 and sd[f"{qkv}.weight_q"].any()
    assert "image_encoder.trunk.blocks.1.proj.weight" in sd  # kept fp
    # the int8 weights are no parameters: an optimizer never sees them
    names = {n for n, _ in vp.engine.model.named_parameters()}
    assert not any("weight_q" in n or "weight_scale" in n for n in names)
    # the same as quantising the seeded fp init by hand
    fp = SAM2Engine(tiny_test_config(), device="cpu").model.state_dict()
    want = quant.quantize_trunk(fp, skip=("proj",))
    assert torch.equal(sd[f"{qkv}.weight_q"], want[f"{qkv}.weight_q"])
    feats = vp.engine.encode_image(_image(4))
    assert all(bool(torch.isfinite(f).all()) for f in feats)
