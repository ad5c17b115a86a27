"""The LayerNorm module's choice between the one-pass kernel and the plain
version, and the kernel wrapper's refusals and launch plan, on the CPU.

The kernel itself (csrc/layer_norm.cu) runs only on a card:
tests/test_torch_kernels_cuda.py holds it against the plain version there.
Here: a CPU call, a call under autograd and every LayerNorm of an engine
built with plain_kernels=True compute the plain version; a call that builds
no graph on a card goes to the kernel's wrapper; the wrapper refuses a type
other than bf16 / fp32 and an empty row on any device; the plan that sizes
the kernel's launch covers every width the port normalises, and names only
instances that the CUDA source compiles.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from det_sam2_tpu_torch.configs import tiny_test_config
from det_sam2_tpu_torch.modeling import layers
from det_sam2_tpu_torch.modeling.layers import LayerNorm, layer_norm_ref
from det_sam2_tpu_torch.ops import attention as att
from det_sam2_tpu_torch.ops import layer_norm as ln
from det_sam2_tpu_torch.track import SAM2Engine

SOURCE = Path(ln.__file__).resolve().parents[1] / "csrc" / "layer_norm.cu"
# every width the port normalises: the downsampler's 4 and 16, the heads'
# 64 and 256, Hiera-S's and Hiera-L's stages, Hiera-B+'s
WIDTHS = (4, 16, 64, 96, 112, 144, 192, 224, 256, 288, 384, 448, 576, 768, 896, 1152)


def _module(c=48, seed=0):
    g = torch.Generator().manual_seed(seed)
    mod = LayerNorm(c, eps=1e-6)
    with torch.no_grad():
        mod.weight.copy_(torch.randn(c, generator=g))
        mod.bias.copy_(torch.randn(c, generator=g))
    return mod


def _x(shape, seed=1, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return (3.0 + torch.randn(shape, generator=g)).to(dtype)


@pytest.fixture
def spy(monkeypatch):
    """The kernel's wrapper as the module finds it, replaced by a recorder."""
    calls = []

    def kernel(x, weight, bias, eps):
        calls.append((x, weight, bias, eps))
        return torch.zeros_like(x)

    monkeypatch.setattr(layers, "_KERNEL", [kernel])
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_cpu_call_computes_the_plain_version(spy, dtype):
    mod, x = _module(), _x((2, 5, 48), dtype=dtype)
    with torch.no_grad():
        got = mod(x)
    assert not spy
    want = layer_norm_ref(x, mod.weight, mod.bias, mod.eps)
    assert got.dtype == dtype and torch.equal(got, want)


def test_the_plain_version_is_the_shifted_formula():
    """layer_norm_ref, written out once more in float64 with the shift: it
    does not cancel at |mean| >> std, where E[x^2] - E[x]^2 in fp32 would."""
    x = 1500.0 + 0.1 * _x((3, 64), seed=2)
    w, b = _module(64).weight.detach(), _module(64).bias.detach()
    got = layer_norm_ref(x, w, b, 1e-6).double()
    xd = x.double()
    mean = xd.mean(-1, keepdim=True)
    want = (xd - mean) / torch.sqrt(((xd - mean) ** 2).mean(-1, keepdim=True) + 1e-6)
    torch.testing.assert_close(got, want * w.double() + b.double(), atol=1e-3, rtol=0)


@pytest.mark.parametrize("case, kernel", [
    ("no_grad", True),
    ("grad_mode_frozen_weights", True),
    ("grad_mode_trainable_weights", False),
    ("input_requires_grad", False),
    ("marked_plain", False),
    ("cpu", False),
])
def test_the_dispatch_rule(case, kernel):
    """The kernel exactly where no autograd graph is built on a card; a
    stand-in for a CUDA tensor, since this machine has no card."""
    mod = _module()
    x = SimpleNamespace(is_cuda=case != "cpu", requires_grad=case == "input_requires_grad")
    if case == "grad_mode_frozen_weights":
        mod.requires_grad_(False)
    if case == "marked_plain":
        mod.plain = True
    with torch.set_grad_enabled(case != "no_grad"):
        assert mod.uses_kernel(x) is kernel


def test_a_kernel_call_goes_to_the_wrapper_with_the_modules_parameters(spy, monkeypatch):
    monkeypatch.setattr(LayerNorm, "uses_kernel", lambda self, x: True)
    mod, x = _module(), _x((4, 48))
    out = mod(x)
    assert len(spy) == 1 and torch.equal(out, torch.zeros_like(x))
    got_x, w, b, eps = spy[0]
    assert got_x is x and w is mod.weight and b is mod.bias and eps == mod.eps


def test_under_autograd_the_plain_version_carries_the_gradient(spy):
    mod = _module()
    x = _x((3, 48)).requires_grad_()
    mod(x).square().sum().backward()
    assert not spy
    assert x.grad is not None and mod.weight.grad is not None and mod.bias.grad is not None


@pytest.mark.parametrize("plain", [True, False])
def test_an_engine_marks_its_layernorms_with_plain_kernels(plain):
    eng = SAM2Engine(tiny_test_config(), device="cpu", plain_kernels=plain)
    norms = [m for m in eng.model.modules() if isinstance(m, LayerNorm)]
    assert norms and all(m.plain is plain for m in norms)
    assert all(m.weight.dtype == torch.float32 for m in norms)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32, torch.uint8])
def test_the_wrapper_refuses_other_types(dtype):
    x = torch.ones(2, 8, dtype=dtype)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        ln.layer_norm(x, torch.ones(8), torch.zeros(8), 1e-6)


@pytest.mark.parametrize("shape", [(3, 0), (0,), (), (2, ln.MAX_C + 1)])
def test_the_wrapper_refuses_empty_or_too_long_rows(shape):
    x = torch.ones(shape)
    c = shape[-1] if shape else 0
    with pytest.raises(ValueError, match="rows of 1 to"):
        ln.layer_norm(x, torch.ones(c), torch.zeros(c), 1e-6)


def test_the_wrapper_refuses_parameters_of_another_width_and_cpu_faults():
    x = _x((2, 8))
    with pytest.raises(ValueError, match="weight"):
        ln.layer_norm(x, torch.ones(7), torch.zeros(8), 1e-6)
    with pytest.raises(ValueError, match="planted faults"):
        ln.layer_norm(x, torch.ones(8), torch.zeros(8), 1e-6, fault=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_wrapper_on_the_cpu_is_the_plain_version(dtype):
    before = att.LAUNCHES["layer_norm"]
    mod, x = _module(), _x((2, 3, 48), dtype=dtype)
    got = ln.layer_norm(x, mod.weight, mod.bias, 1e-5)
    assert torch.equal(got, layer_norm_ref(x, mod.weight, mod.bias, 1e-5))
    assert att.LAUNCHES["layer_norm"] == before


def _instances_in_source():
    """(element bytes, vector elements) -> slot counts, as csrc/layer_norm.cu
    instantiates them (``run_n<S, VEC, N...>`` under each dtype's branch)."""
    text = SOURCE.read_text()
    body = text[text.index("int run_vec("):]
    bf16, fp32 = body.split("} else {", 1)
    found = {}
    for size, part in ((2, bf16), (4, fp32)):
        for vec, ns in re.findall(r"run_n<S, (\d+), ([\d, ]+)>", part):
            found[(size, int(vec))] = tuple(int(n) for n in ns.split(","))
    return found


def test_the_plans_instances_are_the_sources():
    assert _instances_in_source() == ln.INSTANCES
    lane = re.search(r"kLaneElems = (\d+);", SOURCE.read_text())
    assert int(lane.group(1)) == ln.LANE_ELEMS


def test_the_c_entry_takes_the_registered_arguments():
    text = SOURCE.read_text()
    entry = text[text.index('extern "C" int layer_norm('):]
    params = entry[entry.index("(") + 1:entry.index(")")]
    assert len(params.split(",")) == len(att._ARGTYPES["layer_norm"]) == 14


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("c", WIDTHS + (1, 3, 7, 12, 100, 1000, ln.MAX_C))
def test_the_plan_covers_every_row(c, elem):
    """16-byte vectors wherever C allows; every element of a row in some
    lane's slot; no lane past its register budget; an instance that
    exists; at the port's widths at most an eighth of the slots idle (at
    C = 144 in bf16, four lanes a row with five vectors each, not a warp
    with 14 of 32 lanes idle); the narrow rows packed several to a warp."""
    vec, g, n = ln.plan(c, elem)
    assert c % vec == 0 and vec * elem <= 16
    if c % (16 // elem) == 0:
        assert vec * elem == 16
    assert g in (1, 2, 4, 8, 16, 32) and n in ln.INSTANCES[(elem, vec)]
    nv = c // vec
    need = -(-nv // g)
    assert need <= n and need * vec <= ln.LANE_ELEMS
    if c in WIDTHS:
        assert (g * need - nv) / (g * need) <= 0.125
    if c <= 16:
        assert g <= 4
    if (c, elem) == (144, 2):
        assert (vec, g, n) == (8, 4, 5)


def _unshifted(x, w, b, eps):
    """The planted fault's formula: fp32 statistics of x itself."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
    return ((xf - mean) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_gate_takes_rounding_and_refuses_errors(dtype):
    """ops.layer_norm.gate_ratio, the rule the card's checks hold the
    kernel to: one ulp of the output type plus a few fp32 ulps of the row's
    largest normalised output times its conditioning, passes; more does
    not, and the
    unshifted variance at |mean| >> std fails by far more than 7x."""
    mod, x = _module(144), _x((64, 144), seed=7, dtype=dtype)
    w, b, eps = mod.weight.detach(), mod.bias.detach(), 1e-6
    ref = layer_norm_ref(x, w, b, eps)
    assert ln.gate_ratio(ref, ref, x, b, eps) == 0
    step = torch.finfo(dtype).eps
    i = int(ref[5].float().abs().argmax())
    one = ref.clone()
    one[5, i] = (ref[5, i].float() * (1 + step)).to(dtype)  # one ulp up
    assert 0 < ln.gate_ratio(one, ref, x, b, eps) <= 1
    far = ref.clone()
    far[5, i] = (ref[5, i].float() * (1 + 64 * step)).to(dtype)
    assert ln.gate_ratio(far, ref, x, b, eps) > 1
    if dtype == torch.float32:
        big = 1e4 + _x((64, 144), seed=8) - 3.0
        bad = ln.gate_ratio(_unshifted(big, w, b, eps), layer_norm_ref(big, w, b, eps), big, b,
                            eps)
        assert bad >= 7
