"""K1 / K2 / K3a / K3b CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch with CUDA:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX). Without a card every
test here skips: the kernels have no CPU mode.

Tolerances are chip_smoke.py's, in units of the output type's own rounding
step: max-abs error <= MAX_ULPS ulps of max|ref| and mean-abs error <=
MEAN_EPS * eps * mean|ref|. bf16: both sides round an fp32 result to bf16
and the kernel also rounds the unnormalised P per key tile; fp32: another
summation order and expf.
"""

import math

import numpy as np
import pytest
import torch

from det_sam2_tpu_torch.ops import attention as att

MAX_ULPS = {torch.bfloat16: 4, torch.float32: 1024}
MEAN_EPS = {torch.bfloat16: 0.4, torch.float32: 64}


def _assert_held(out, ref):
    """out within chip_smoke.py's tolerance of ref (the rule above)."""
    eps = torch.finfo(out.dtype).eps
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    ulp = 2.0 ** math.floor(math.log2(float(mag.max()))) * eps
    max_ulps = float(diff.max()) / ulp
    mean_eps = float(diff.mean()) / (eps * float(mag.mean()))
    assert max_ulps <= MAX_ULPS[out.dtype], f"max error {max_ulps:.3g} ulps"
    assert mean_eps <= MEAN_EPS[out.dtype], f"mean error {mean_eps:.3g} eps"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def _k2_inputs(seed=0):
    rng = np.random.default_rng(seed)
    b, nq, d, cm, s, ktot, t, nl, layer = 2, 256, 128, 32, 100, 6, 4, 3, 1
    w = rng.standard_normal((t, d)).astype(np.float32)
    w[-1] = 0.0  # staging tile: unroped, no correction
    valid = rng.random((b, t, s)) > 0.2
    valid[:, 1] = False  # a fully dead tile
    valid[1] = False  # an object with no live key
    arrays = [
        rng.standard_normal((b, nq, d)), rng.standard_normal((ktot, b, nl, s, d)),
        rng.standard_normal((ktot, b, s, cm)), np.asarray([3, 0, 5, 2], np.int32), w,
        np.where(valid, 0.0, -1e30).reshape(b, t * s),
        rng.standard_normal((s, d // 2)), rng.standard_normal((s, d // 2)),
    ]
    out = [torch.from_numpy(np.asarray(a)) for a in arrays]
    return [x if x.dtype == torch.int32 else x.float() for x in out] + [layer]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernels_match_plain_on_cuda(dev, dtype):
    """K1 with Dv != D, ragged Nq / Nk, a dead key range and a dead row; K2
    with S off the key tile, a dead tile, a dead object and the unroped
    staging tile. Each wrapper launches its kernel once per call."""
    dt = getattr(torch, dtype)
    bh, nq, nk, d, dv = 3, 100, 200, 64, 24
    q, k, v = (_rand(s, i).to(dev, dt) for i, s in enumerate(
        [(bh, nq, d), (bh, nk, d), (bh, nk, dv)]))
    bias = torch.zeros(bh, nk, device=dev)
    bias[:, 64:128] = -1e30
    bias[2] = -1e30
    before = att.LAUNCHES["flash_fwd"]
    out, lse = att.flash_attention_fwd(q, k, v, bias)
    assert att.LAUNCHES["flash_fwd"] == before + 1
    ref, ref_lse = att.flash_attention_ref(q, k, v, bias)
    _assert_held(out, ref)
    assert bool((out[2] == 0).all())
    assert float((lse[:2] - ref_lse[:2]).abs().max()) <= 1e-3

    args = _k2_inputs()
    args = [x.to(dev) for x in args[:-1]] + [args[-1]]
    args[:3] = [x.to(dt) for x in args[:3]]
    before = att.LAUNCHES["flash_banked_fwd"]
    out = att.flash_attention_banked_fwd(*args)
    assert att.LAUNCHES["flash_banked_fwd"] == before + 1
    ref = att.flash_attention_banked_ref(*args)
    _assert_held(out, ref)
    assert bool((out[1] == 0).all())


@pytest.mark.cuda
def test_dispatch_rule_launches_k1_on_cuda(dev):
    """Above the dispatch threshold a CUDA problem reaches the kernel; below
    it, the plain sdpa (on every device)."""
    q = _rand((1, 2, 2048, 64), 0).to(dev, torch.bfloat16)
    k = _rand((1, 2, 2048, 64), 1).to(dev, torch.bfloat16)
    before = att.LAUNCHES["flash_fwd"]
    out = att.flash_attention(q, k, k)
    assert att.LAUNCHES["flash_fwd"] == before + 1
    ref = att.sdpa(q, k, k)
    _assert_held(out, ref)
    att.flash_attention(q[:, :, :8], k, k)  # 8 * 2048 < 2^22
    assert att.LAUNCHES["flash_fwd"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_backward_kernels_match_plain_on_cuda(dev, dtype):
    """K3a / K3b against flash_attention_bwd_ref on the same inputs: Dv != D,
    ragged Nq / Nk, a dead key range and a dead row (D = 40), and D = 56."""
    dt = getattr(torch, dtype)
    for bh, nq, nk, d, dv, dead in ((3, 100, 200, 40, 24, True), (2, 130, 90, 56, 56, False)):
        q, k, v, do = (_rand(s, i).to(dev, dt) for i, s in enumerate(
            [(bh, nq, d), (bh, nk, d), (bh, nk, dv), (bh, nq, dv)]))
        bias = None
        if dead:
            bias = torch.zeros(bh, nk, device=dev)
            bias[:, 64:128] = -1e30
            bias[2] = -1e30
        out, lse = att.flash_attention_ref(q, k, v, bias)
        delta = (do.float() * out.float()).sum(-1)
        before = dict(att.LAUNCHES)
        dq = att.flash_bwd_dq(q, k, v, bias, do, lse, delta)
        dk, dv_ = att.flash_bwd_dkv(q, k, v, bias, do, lse, delta)
        assert att.LAUNCHES["flash_bwd_dq"] == before["flash_bwd_dq"] + 1
        assert att.LAUNCHES["flash_bwd_dkv"] == before["flash_bwd_dkv"] + 1
        refs = att.flash_attention_bwd_ref(q, k, v, bias, out, lse, do)
        for got, ref in zip((dq, dk, dv_), refs):
            assert bool(torch.isfinite(got).all())
            _assert_held(got, ref)
        if dead:
            assert all(bool((g[2] == 0).all()) for g in (dq, dk, dv_))


@pytest.mark.cuda
def test_flash_function_backward_launches_k3_on_cuda(dev):
    """Differentiating flash_attention on CUDA tensors goes through K1, K3a
    and K3b (one launch each) and matches the plain route."""
    q, k, v = (_rand((1, 2, 2048, 64), i).to(dev).requires_grad_() for i in range(3))
    before = dict(att.LAUNCHES)
    out = att.flash_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert att.LAUNCHES[name] == before[name] + 1, name
    ref = att.flash_attention(q, k, v, plain=True)
    for got, want in zip(grads, torch.autograd.grad(ref, (q, k, v), torch.ones_like(ref))):
        _assert_held(got, want)
