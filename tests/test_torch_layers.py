"""PyTorch port building blocks vs their JAX counterparts (fp32, CPU).

Same numpy inputs (seeded) through det_sam2_tpu.modeling.{layers,
position_encoding} and det_sam2_tpu_torch.modeling.{layers,
position_encoding}. Tolerance 1e-5 unless stated: fp32 everywhere, only
summation order and transcendental implementations differ.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from det_sam2_tpu.modeling import layers as jl
from det_sam2_tpu.modeling import position_encoding as jpe

from det_sam2_tpu_torch.modeling import layers as tl
from det_sam2_tpu_torch.modeling import position_encoding as tpe

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ATOL = 1e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("case", ["random", "large_mean"])
def test_layernorm(case):
    if case == "random":
        x = _rand((4, 32, 64), 0)
    else:  # |mean| >> std: the shifted one-pass variance must not cancel
        x = (1500.0 + 0.1 * _rand((4, 32, 64), 0)).astype(np.float32)
    w, b = _rand((64,), 1), _rand((64,), 2)
    ln = jl.LayerNorm(eps=1e-6)
    want = ln.apply({"params": {"scale": w, "bias": b}}, jnp.asarray(x))
    mod = tl.LayerNorm(64, eps=1e-6)
    with torch.no_grad():
        mod.weight.copy_(_t(w))
        mod.bias.copy_(_t(b))
        got = mod(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if case == "large_mean":
        xf = x.astype(np.float64)
        mean = xf.mean(-1, keepdims=True)
        ref = (xf - mean) / np.sqrt(((xf - mean) ** 2).mean(-1, keepdims=True) + 1e-6)
        # the unshifted form is off by ~4e2 here; the shifted one by <1e-4
        np.testing.assert_allclose(got.numpy(), ref * w + b, atol=1e-3)


def test_gelu_both_forms():
    x = _rand((1000,), 0, 3.0)
    np.testing.assert_allclose(tl.exact_gelu(_t(x)).numpy(),
                               np.asarray(jl.exact_gelu(jnp.asarray(x))), atol=ATOL)
    np.testing.assert_allclose(tl.approx_gelu(_t(x)).numpy(),
                               np.asarray(jl.approx_gelu(jnp.asarray(x))), atol=ATOL)


def test_mlp_with_sigmoid():
    x = _rand((3, 5, 16), 0)
    jm = jl.MLP(hidden_dim=32, output_dim=8, num_layers=3, sigmoid_output=True)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x))
    tm = tl.MLP(16, 32, 8, 3, sigmoid_output=True)
    with torch.no_grad():
        for i, lin in enumerate(tm.layers):
            lin.weight.copy_(_t(params[f"layers_{i}"]["kernel"]).T)
            lin.bias.copy_(_t(params[f"layers_{i}"]["bias"]))
        got = tm(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("dead_rows", [False, True])
def test_sdpa(dead_rows):
    b, h, nq, nk, d, dv = 2, 3, 17, 40, 16, 8
    q, k, v = _rand((b, h, nq, d), 0), _rand((b, h, nk, d), 1), _rand((b, h, nk, dv), 2)
    valid = np.random.default_rng(3).random((b, 1, 1, nk)) > 0.3
    if dead_rows:
        valid[1] = False  # every key of batch 1 masked: P = 0, output 0
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    want = jl.sdpa(*(jnp.asarray(a) for a in (q, k, v, bias)))
    got = tl.sdpa(_t(q), _t(k), _t(v), _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if dead_rows:
        assert np.all(got[1].numpy() == 0)


def test_sine_and_1d_pe():
    np.testing.assert_array_equal(tpe.sine_pos_embed_2d(8, 8, 64),
                                  jpe.sine_pos_embed_2d(8, 8, 64))
    pos = np.arange(-5, 11, dtype=np.float32) / 7.0
    np.testing.assert_allclose(tpe.get_1d_sine_pe(_t(pos), 256).numpy(),
                               np.asarray(jpe.get_1d_sine_pe(jnp.asarray(pos), 256)),
                               atol=ATOL)


def test_random_pe():
    g = _rand((2, 64), 0)
    np.testing.assert_allclose(tpe.random_pe_grid(8, 8, _t(g)).numpy(),
                               np.asarray(jpe.random_pe_grid(8, 8, jnp.asarray(g))),
                               atol=1e-4)  # sin/cos of |arg| up to ~50 rad
    pts = _rand((3, 4, 2), 1, 50.0) + 60.0
    np.testing.assert_allclose(
        tpe.random_pe_points(_t(pts), (128, 128), _t(g)).numpy(),
        np.asarray(jpe.random_pe_points(jnp.asarray(pts), (128, 128), jnp.asarray(g))),
        atol=1e-4)


def test_axial_rope_halves():
    cos, sin = tpe.axial_rope_cos_sin(64, 8, 8)
    jcos, jsin = jpe.axial_rope_cos_sin(64, 8, 8)
    np.testing.assert_array_equal(cos, jcos)
    np.testing.assert_array_equal(sin, jsin)
    np.testing.assert_array_equal(tpe.rope_channel_perm(64), jpe.rope_channel_perm(64))
    x = _rand((2, 1, 64, 64), 0)
    want = jpe.apply_rope_halves(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    got = tpe.apply_rope_halves(_t(x), _t(cos), _t(sin))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # halves layout == interleaved rotation after the channel permutation
    perm = tpe.rope_channel_perm(64)
    inter = jpe.apply_rope(jnp.asarray(x[..., np.argsort(perm)]), jnp.asarray(cos),
                           jnp.asarray(sin))
    np.testing.assert_allclose(got.numpy(), np.asarray(inter)[..., perm], atol=ATOL)


def test_conv_nhwc_is_the_nchw_conv():
    conv = torch.nn.Conv2d(4, 6, 3, 2, 1)
    x = torch.from_numpy(_rand((2, 9, 9, 4), 0))
    want = conv(x.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)
    torch.testing.assert_close(tl.conv_nhwc(conv, x), want, atol=ATOL, rtol=0)
    assert F.gelu(torch.ones(1)).item() == pytest.approx(tl.exact_gelu(torch.ones(1)).item())
