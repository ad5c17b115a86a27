"""K1 / K2 of the PyTorch port vs the JAX package's Pallas kernels.

On the CPU the port's wrappers compute their kernels' plain versions; the
JAX side runs its Pallas kernels in interpret mode (what the JAX package
does off-TPU), with small blocks so that tile skipping and padding happen.
Inputs are seeded numpy arrays given to both. fp32; tolerance 2e-5 (the
JAX package's own kernel-vs-dense tolerance): only summation order differs.

The kernel-vs-plain tests need a CUDA card and no JAX:
tests/test_torch_kernels_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from det_sam2_tpu.ops import attention as jatt

from det_sam2_tpu_torch.ops import attention as att

torch.backends.cuda.matmul.allow_tf32 = False
ATOL = 2e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _k1_case(name):
    # (b, h, nq, nk, d, dv, bias pattern)
    return {
        "no_bias": (1, 2, 130, 300, 32, 32, None),
        "dead_tile": (2, 1, 128, 384, 32, 32, "dead_tile"),
        "dead_row": (2, 1, 64, 256, 32, 32, "dead_row"),
        "dv_ne_d": (2, 1, 96, 200, 64, 16, "dead_tile"),
    }[name]


@pytest.mark.parametrize("name", ["no_bias", "dead_tile", "dead_row", "dv_ne_d"])
def test_k1_plain_matches_pallas(name):
    b, h, nq, nk, d, dv, pattern = _k1_case(name)
    q, k, v = _rand((b, h, nq, d), 0), _rand((b, h, nk, d), 1), _rand((b, h, nk, dv), 2)
    bias = None
    if pattern is not None:
        valid = np.random.default_rng(3).random((b, 1, 1, nk)) > 0.3
        valid[..., 128:256] = False  # one whole 128-key tile dead (skipped)
        if pattern == "dead_row":
            valid[1] = False  # no live key at all: zeros, not NaN
        bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    want = jatt.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias),
        block_q=128, block_k=128, min_flops=0,
    )
    got = att.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              None if bias is None else torch.from_numpy(bias),
                              min_flops=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if pattern == "dead_row":
        assert np.all(got[1].numpy() == 0)

    # the [BH, N, D] level, with the logsumexp the TPU kernel also returns
    bf = None if bias is None else np.broadcast_to(bias[:, :, 0], (b, h, nk)).reshape(b * h, nk)
    jout, jlse = jatt._flash_call(
        jnp.asarray(q.reshape(b * h, nq, d)), jnp.asarray(k.reshape(b * h, nk, d)),
        jnp.asarray(v.reshape(b * h, nk, dv)), None if bf is None else jnp.asarray(bf),
        block_q=128, block_k=128, interpret=True,
    )
    out, lse = att.flash_attention_ref(
        torch.from_numpy(q.reshape(b * h, nq, d)), torch.from_numpy(k.reshape(b * h, nk, d)),
        torch.from_numpy(v.reshape(b * h, nk, dv)),
        None if bf is None else torch.from_numpy(np.array(bf)),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    live = np.ones(b * h, bool) if bf is None else (bf > -1e29).any(-1)
    np.testing.assert_allclose(lse.numpy()[live], np.asarray(jlse)[live], atol=1e-4)


def test_k1_dispatch_rule(monkeypatch):
    """Nq*Nk < min_flops, or a bias not of the form [B,1,1,Nk], goes to the
    plain sdpa on every device; the kernel's wrapper is not reached."""
    def _no_kernel(*a, **k):
        raise AssertionError("K1 reached")

    monkeypatch.setattr(att, "flash_attention_fwd", _no_kernel)
    q = torch.from_numpy(_rand((1, 8, 8, 32), 0))
    k = torch.from_numpy(_rand((1, 8, 4096, 32), 1))
    out = att.flash_attention(q, k, k)  # 8 * 4096 < 2^22
    torch.testing.assert_close(out, att.sdpa(q, k, k))
    q = torch.from_numpy(_rand((1, 1, 2048, 32), 0))
    k = torch.from_numpy(_rand((1, 1, 2048, 32), 1))
    full_bias = torch.zeros(1, 1, 2048, 2048)
    out = att.flash_attention(q, k, k, full_bias)  # [B,H,Nq,Nk] bias
    torch.testing.assert_close(out, att.sdpa(q, k, k, full_bias))


def _k2_inputs(seed=0):
    # the shapes of tests/test_banked_attention.py (JAX kernel vs dense)
    rng = np.random.default_rng(seed)
    B, Nq, D, Cm, S, Ktot, T, L, layer = 2, 256, 128, 32, 128, 6, 4, 3, 1
    q = rng.standard_normal((B, 1, Nq, D)).astype(np.float32)
    mem_k = rng.standard_normal((Ktot, B, L, S, D)).astype(np.float32)
    mem_v = rng.standard_normal((Ktot, B, S, Cm)).astype(np.float32)
    slots = np.asarray([3, 0, 5, 2], np.int32)
    w = rng.standard_normal((T, D)).astype(np.float32)
    w[-1] = 0.0  # staging tile: unroped, no correction
    cos = rng.standard_normal((S, D // 2)).astype(np.float32)
    sin = rng.standard_normal((S, D // 2)).astype(np.float32)
    valid = rng.random((B, T, S)) > 0.2
    valid[:, 1] = False  # a fully dead tile
    valid[1] = False  # an object with no live key
    bias = np.where(valid, 0.0, -1e30).reshape(B, T * S).astype(np.float32)
    return q, mem_k, mem_v, slots, w, bias, cos, sin, layer


def test_k2_plain_matches_pallas():
    args = _k2_inputs()
    want = jatt.flash_attention_banked(*(jnp.asarray(a) for a in args[:-1]), args[-1],
                                       block_q=128, block_k=64)
    got = att.flash_attention_banked(*(torch.from_numpy(a) for a in args[:-1]), args[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    assert np.all(got[1].numpy() == 0)


def test_k2_keys_are_the_corrected_bank_rows():
    q, mem_k, mem_v, slots, w, bias, cos, sin, layer = _k2_inputs(1)
    k = att.banked_keys(torch.from_numpy(mem_k), torch.from_numpy(slots),
                        torch.from_numpy(w), torch.from_numpy(cos),
                        torch.from_numpy(sin), layer, torch.float32)
    half = w.shape[1] // 2
    s = cos.shape[0]
    # the staging tile (w = 0) is the cached rows unchanged
    np.testing.assert_array_equal(k[:, 3 * s:].numpy(), mem_k[slots[3], :, layer])
    corr = np.concatenate([cos * w[0, :half] - sin * w[0, half:],
                           sin * w[0, :half] + cos * w[0, half:]], -1)
    np.testing.assert_allclose(k[:, :s].numpy(), mem_k[slots[0], :, layer] + corr,
                               atol=1e-6)
    # the pre-pass's layout: each tile padded to S_pad rows of zeros, and a
    # slot outside [0, Ktot) gives a zero tile
    bad = slots.copy()
    bad[2] = mem_k.shape[0] + 7
    s_pad = s + 64
    kp = att.flash_banked_keys(torch.from_numpy(mem_k), torch.from_numpy(bad),
                               torch.from_numpy(w), torch.from_numpy(cos),
                               torch.from_numpy(sin), layer, s_pad)
    kp = kp.reshape(k.shape[0], len(slots), s_pad, -1).numpy()
    assert np.all(kp[:, :, s:] == 0) and np.all(kp[:, 2] == 0)
    np.testing.assert_array_equal(kp[:, 0, :s], k[:, :s].numpy())
    np.testing.assert_array_equal(kp[:, 3, :s], k[:, 3 * s:].numpy())


def _tpu_keys(mem_k, slots, w, cos, sin, layer, dtype):
    """The keys the TPU kernel builds in-kernel (_flash_banked_kernel,
    attention.py:477-488), with its own jnp expression: per tile t,
    (k0 + [cos*w1 - sin*w2, sin*w1 + cos*w2]).astype(dtype)."""
    half = w.shape[1] // 2
    out = []
    for t, slot in enumerate(slots):
        k0 = jnp.asarray(mem_k[slot, :, layer]).astype(jnp.float32)  # [B, S, D]
        w1, w2 = jnp.asarray(w[t:t + 1, :half]), jnp.asarray(w[t:t + 1, half:])
        c, sn = jnp.asarray(cos), jnp.asarray(sin)
        corr = jnp.concatenate([c * w1 - sn * w2, sn * w1 + c * w2], axis=-1)
        out.append((k0 + corr[None]).astype(dtype))
    return np.asarray(jnp.concatenate(out, axis=1).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_prepass_plain_matches_tpu_kernel_keys(dtype):
    """K2's pre-pass (plain version) builds the keys the TPU kernel builds
    in-kernel: fp32 to the rounding of the correction, bf16 to one ulp."""
    q, mem_k, mem_v, slots, w, bias, cos, sin, layer = _k2_inputs(2)
    mk = torch.from_numpy(mem_k).to(getattr(torch, dtype))
    want = _tpu_keys(np.asarray(mk.float()), slots, w, cos, sin, layer,
                     getattr(jnp, dtype))
    got = att.flash_banked_keys(mk, torch.from_numpy(slots), torch.from_numpy(w),
                                torch.from_numpy(cos), torch.from_numpy(sin), layer)
    assert got.dtype == mk.dtype
    rtol = 1e-6 if dtype == "float32" else 2.0 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("pad", [0, 64])
def test_k2_main_plain_matches_pallas_with_a_slot_out_of_range(pad):
    """K2's main kernel (plain version) over the pre-pass's keys, padded to
    S_pad, with slot 1 outside [0, Ktot): equal to the JAX kernel given a
    valid slot and that tile's keys dead."""
    q, mem_k, mem_v, slots, w, bias, cos, sin, layer = _k2_inputs(3)
    s = cos.shape[0]
    bad = slots.copy()
    bad[1] = -1
    dead = bias.copy()
    dead[:, s:2 * s] = -1e30
    want = jatt.flash_attention_banked(
        *(jnp.asarray(a) for a in (q, mem_k, mem_v, slots, w, dead, cos, sin)),
        layer, block_q=128, block_k=64)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    keys = att.flash_banked_keys(t(mem_k), t(bad), t(w), t(cos), t(sin), layer, s + pad)
    got = att.flash_banked_attend(t(q[:, 0]), keys, t(mem_v), t(bad), t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0], atol=ATOL)
    whole = att.flash_attention_banked(*(t(a) for a in (q, mem_k, mem_v, bad, w, bias,
                                                        cos, sin)), layer)
    np.testing.assert_allclose(whole.numpy(), np.asarray(want), atol=ATOL)
