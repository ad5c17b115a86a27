"""The 3xTF32 arithmetic of the backward kernels K3a / K3b, sized on the CPU.

The kernels (csrc/flash_common.cuh) split every fp32 operand x into hi = x
rounded to TF32 and lo = (x - hi) rounded to TF32, and take each product as
lo*hi + hi*lo + hi*hi on the tensor cores. ``ops.attention.split_tf32`` is
that split in plain PyTorch. Here it is checked bit by bit against a rounding
computed independently in float64, and the plain backward (``_bwd_ref``) is
run with every matrix product emulated in that scheme: it must stay within
the fp32 gate that chip_smoke.py holds the kernels to (max-abs error <= 1024
ulps of max|ref|, mean-abs error <= 64 eps * mean|ref|) of the plain fp32
backward, and the same emulation with one TF32 pass (hi*hi alone) must not.
No card is needed.
"""

import math

import numpy as np
import pytest
import torch

from det_sam2_tpu_torch.ops import attention as att

MAX_ULPS, MEAN_EPS = 1024, 64  # chip_smoke.py's fp32 gate
EPS = float(np.finfo(np.float32).eps)


def _inputs(kind: str) -> np.ndarray:
    rng = np.random.default_rng({"binades": 0, "ties": 1, "subnormals": 2}[kind])
    if kind == "binades":  # random signs and mantissas over most of the fp32 range
        x = rng.standard_normal(4096) * np.exp2(rng.integers(-100, 100, 4096))
    elif kind == "ties":  # the 13 dropped bits exactly half an ulp of TF32
        bits = (rng.integers(0, 1 << 19, 4096, dtype=np.uint32) << 13) | 0x1000
        bits &= 0x7F7FFFFF  # finite
        bits[rng.random(4096) < 0.5] |= 0x80000000
        x = bits.view(np.float32)
    else:  # subnormals and the smallest normals
        bits = rng.integers(1, 1 << 24, 4096, dtype=np.uint32)
        bits[rng.random(4096) < 0.5] |= 0x80000000
        x = bits.view(np.float32)
    return np.asarray(x, np.float32)


def _rna_tf32(x: np.ndarray) -> np.ndarray:
    """x rounded to 10 mantissa bits, ties away from zero, in float64 (an
    independent spelling of TF32's round to nearest): the step is 2^(e-10)
    for 2^e <= |x| < 2^(e+1), and 2^-136 below the normal range."""
    x = x.astype(np.float64)
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    step = np.exp2(np.maximum(e, -126) - 10)
    return np.sign(x) * np.floor(np.abs(x) / step + 0.5) * step


@pytest.mark.parametrize("kind", ["binades", "ties", "subnormals"])
def test_split_tf32_rounds_to_nearest_and_reconstructs(kind):
    """hi has its 13 low mantissa bits zero and is x rounded to nearest TF32
    (ties away from zero); lo is x - hi rounded the same way; hi + lo is x to
    within 2^-21 relative, or 2^-137 (half TF32's smallest step) where x or
    x - hi is below the normal range."""
    x = _inputs(kind)
    hi, lo = att.split_tf32(torch.from_numpy(x))
    hi_np, lo_np = hi.numpy(), lo.numpy()
    assert not (hi_np.view(np.uint32) & 0x1FFF).any()
    assert not (lo_np.view(np.uint32) & 0x1FFF).any()
    np.testing.assert_array_equal(hi_np.astype(np.float64), _rna_tf32(x))
    rest = x.astype(np.float64) - hi_np  # exact in fp32 (Sterbenz)
    assert np.array_equal(rest, (x - hi_np).astype(np.float64))
    np.testing.assert_array_equal(lo_np.astype(np.float64), _rna_tf32(rest.astype(np.float32)))
    err = np.abs(hi_np.astype(np.float64) + lo_np - x)
    bound = np.maximum(2.0 ** -21 * np.abs(x.astype(np.float64)), 2.0 ** -137)
    assert (err <= bound).all(), float((err / bound).max())
    if kind == "ties":  # every tie went away from zero
        assert (np.abs(hi_np) > np.abs(x)).all()


def test_split_tf32_keeps_zeros_and_non_finite_values():
    x = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, 1.0])
    hi, lo = att.split_tf32(x)
    assert torch.equal(hi[:4], x[:4]) and bool(torch.isnan(hi[4])) and float(hi[5]) == 1.0
    assert torch.equal(lo, torch.zeros(6))


def _mm_tf32(passes: int):
    """A matrix product in TF32 passes, summed in fp32: 3 = the kernels'
    (lo*hi + hi*lo) + hi*hi, 1 = hi*hi alone."""
    def mm(a, b):
        ah, al = att.split_tf32(a)
        bh, bl = att.split_tf32(b)
        if passes == 1:
            return ah @ bh
        return (al @ bh + ah @ bl) + ah @ bh
    return mm


CASES = {
    # (bh, nq, nk, d, dv, dead key ranges [(row, lo, hi)] or None for no bias)
    "hiera_like": (2, 96, 128, 56, 56, None),
    "cross_like": (2, 80, 300, 256, 64, [(0, 40, 104)]),
    "ragged": (3, 100, 200, 40, 24, [(0, 64, 128), (2, 0, 200)]),
}


def _case(name):
    bh, nq, nk, d, dv, dead = CASES[name]
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                   for s in [(bh, nq, d), (bh, nk, d), (bh, nk, dv), (bh, nq, dv)])
    bias = None
    if dead is not None:
        bias = torch.zeros(bh, nk)
        for row, lo, hi in dead:
            bias[row, lo:hi] = -1e30
    out, lse = att.flash_attention_ref(q, k, v, bias)
    delta = (do * out).sum(-1)
    return (q, k, v, bias, lse, do, delta)


def _gate(out, ref):
    """(max error in units of the max gate, mean error in units of the mean gate)."""
    diff = (out.double() - ref.double()).abs()
    mag = ref.double().abs()
    ulp = 2.0 ** math.floor(math.log2(float(mag.max()))) * EPS
    return (float(diff.max()) / (MAX_ULPS * ulp),
            float(diff.mean()) / (MEAN_EPS * EPS * float(mag.mean())))


@pytest.mark.parametrize("name", list(CASES))
def test_3xtf32_backward_is_within_the_fp32_gate(name):
    """The plain backward with every product in the kernels' 3xTF32 scheme
    against the plain fp32 backward: dq, dk and dv within the fp32 gate,
    and within a quarter of it (the split loses ~2^-22 relative a product,
    the gate allows ~2^-17 on average; these cases read <= 0.11 of the mean
    gate, most of it the emulation's own fp32 sums of three products)."""
    args = _case(name)
    want = att._bwd_ref(*args)
    got = att._bwd_ref(*args, mm=_mm_tf32(3))
    for g, w in zip(got, want):
        max_x, mean_x = _gate(g, w)
        assert max_x <= 0.25 and mean_x <= 0.25, (max_x, mean_x)


@pytest.mark.parametrize("name", list(CASES))
def test_one_tf32_pass_fails_the_fp32_gate(name):
    """The same with one TF32 pass (hi*hi alone, the planted fault of the
    kernels): at least one of dq, dk, dv lands outside the fp32 gate by 7x
    or more, so the gate tells fp32-grade products from TF32."""
    args = _case(name)
    want = att._bwd_ref(*args)
    got = att._bwd_ref(*args, mm=_mm_tf32(1))
    worst = max(max(_gate(g, w)) for g, w in zip(got, want))
    assert worst >= 7, worst
