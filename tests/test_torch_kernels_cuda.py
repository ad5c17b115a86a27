"""K1 / K2 (pre-pass and main) / K3a / K3b CUDA kernels against their plain
PyTorch versions, on the card.

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


def _errors(out, ref):
    """(max error in ulps of max|ref|, mean error in eps * mean|ref|)."""
    eps = torch.finfo(out.dtype).eps
    diff = (out.float() - ref.float()).abs()
    mag = ref.float().abs()
    ulp = 2.0 ** math.floor(math.log2(float(mag.max()))) * eps
    return float(diff.max()) / ulp, float(diff.mean()) / (eps * float(mag.mean()))


def _assert_held(out, ref):
    """out within chip_smoke.py's tolerance of ref (the rule above)."""
    max_ulps, mean_eps = _errors(out, ref)
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
    before = dict(att.LAUNCHES)
    out = att.flash_attention_banked_fwd(*args)
    for name in ("flash_banked_keys", "flash_banked_fwd"):  # pre-pass, then main
        assert att.LAUNCHES[name] == before[name] + 1, name
    ref = att.flash_attention_banked_ref(*args)
    _assert_held(out, ref)
    assert bool((out[1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_k2_prepass_is_exact_on_cuda(dev, dtype):
    """K2's pre-pass equals its plain version bit for bit: padded tiles, a
    slot out of range (a zero tile) and the unroped staging tile included."""
    dt = getattr(torch, dtype)
    mem_k, slots, w, cos, sin, layer = (_k2_inputs()[i] for i in (1, 3, 4, 6, 7, 8))
    slots = torch.tensor([3, 9, 5, 2], dtype=torch.int32)
    mem_k = mem_k.to(dev, dt)
    args = [x.to(dev) for x in (slots, w, cos, sin)]
    before = att.LAUNCHES["flash_banked_keys"]
    got = att.flash_banked_keys(mem_k, *args, layer, 128)
    assert att.LAUNCHES["flash_banked_keys"] == before + 1
    want = att.banked_keys(mem_k, *args, layer, dt, 128)
    assert torch.equal(got, want)
    assert bool((got.reshape(2, 4, 128, -1)[:, 1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b, cond_tiles", [(4, 2), (4, 1), (2, 1), (4, 4)],
                         ids=lambda x: str(x))
def test_k2_at_video_predictor_shapes_on_cuda(dev, dtype, b, cond_tiles):
    """K2 at the video predictor's shapes: 2 or 4 object slots, 1, 2 or 4
    attended cond tiles (slots = cond tiles + 6 non-cond + the staging row),
    at the serving widths (S = 4096, D = 256, Cm = 64, 4 layers), with an
    object slot no object holds (every key dead), a dead non-cond tile and
    64 live pointer tokens in the staging tile. The pre-pass equals its
    plain version bit for bit; the whole K2 holds against its plain
    version."""
    from det_sam2_tpu_torch.modeling.position_encoding import axial_rope_cos_sin

    dt = getattr(torch, dtype)
    nq, s, d, cm, nl, ktot, layer = 1024, 4096, 256, 64, 4, 12, 3
    t = cond_tiles + 6 + 1
    g = torch.Generator(device=dev).manual_seed(7 + b + t)
    q = torch.randn(b, nq, d, generator=g, device=dev).to(dt)
    mem_k = torch.randn(ktot, b, nl, s, d, generator=g, device=dev).to(dt)
    mem_v = torch.randn(ktot, b, s, cm, generator=g, device=dev).to(dt)
    slots = torch.tensor(list(range(cond_tiles)) + [4, 5, 6, 7, 8, 9, ktot - 1],
                         dtype=torch.int32, device=dev)
    w = torch.randn(t, d, generator=g, device=dev)
    w[-1] = 0.0  # the staging tile is not rotated
    cos, sin = (torch.as_tensor(x, device=dev) for x in axial_rope_cos_sin(d, 64, 64))
    live = torch.ones(b, t, s, dtype=torch.bool, device=dev)
    live[:, -1, 64:] = False  # 64 pointer tokens in the staging tile
    live[0, cond_tiles + 2] = False  # a non-cond tile object 0 misses
    live[b - 1] = False  # a slot no object holds
    bias = torch.where(live, 0.0, -1e30).reshape(b, t * s)
    before = dict(att.LAUNCHES)
    out = att.flash_attention_banked_fwd(q, mem_k, mem_v, slots, w, bias, cos, sin, layer)
    for name in ("flash_banked_keys", "flash_banked_fwd"):
        assert att.LAUNCHES[name] == before[name] + 1, name
    ref = att.flash_attention_banked_ref(q, mem_k, mem_v, slots, w, bias, cos, sin, layer)
    _assert_held(out, ref)
    assert bool((out[b - 1] == 0).all())
    keys = att.flash_banked_keys(mem_k, slots, w, cos, sin, layer, s)
    assert torch.equal(keys, att.banked_keys(mem_k, slots, w, cos, sin, layer, dt, s))


# K1 shapes that take the forward's other compile-time paths: (bh, nq, nk,
# D, Dv) with one consumer warpgroup and more blocks than SMs, four V panels
# (Dv = 256), six depth steps (D = 96), and fp32's 32-key tiles (D = 256)
K1_PATHS = [(3, 3200, 300, 64, 64), (2, 256, 300, 256, 256), (2, 256, 300, 96, 96),
            (2, 130, 200, 56, 56)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", K1_PATHS, ids=lambda s: "x".join(map(str, s)))
def test_k1_paths_match_plain_on_cuda(dev, dtype, shape):
    """K1 against flash_attention_ref on each path, with a dead key range;
    in bf16 the planted wrong-ring-stage fault must fail the tolerance."""
    dt = getattr(torch, dtype)
    bh, nq, nk, d, dv = shape
    q, k, v = (_rand(s, 10 + i).to(dev, dt) for i, s in enumerate(
        [(bh, nq, d), (bh, nk, d), (bh, nk, dv)]))
    bias = torch.zeros(bh, nk, device=dev)
    bias[:, 128:192] = -1e30
    out, _ = att.flash_attention_fwd(q, k, v, bias)
    ref, _ = att.flash_attention_ref(q, k, v, bias)
    _assert_held(out, ref)
    if dt == torch.bfloat16:
        bad, _ = att.flash_attention_fwd(
            q, k, v, bias, fault=att.FWD_FAULTS["consumer reads the wrong ring stage"])
        with pytest.raises(AssertionError):
            _assert_held(bad, ref)


@pytest.mark.cuda
def test_k1_at_the_batched_image_encode_shape_on_cuda(dev):
    """K1 at a Hiera global block of the image predictor's batched encode
    (hiera-S, 4 images: [4 heads x 4, 4096, 96] bf16, no bias) against
    flash_attention_ref; the planted wrong-ring-stage fault must fail."""
    q, k, v = (_rand((16, 4096, 96), 20 + i).to(dev, torch.bfloat16) for i in range(3))
    before = att.LAUNCHES["flash_fwd"]
    out, _ = att.flash_attention_fwd(q, k, v)
    assert att.LAUNCHES["flash_fwd"] == before + 1
    ref, _ = att.flash_attention_ref(q, k, v)
    _assert_held(out, ref)
    bad, _ = att.flash_attention_fwd(
        q, k, v, fault=att.FWD_FAULTS["consumer reads the wrong ring stage"])
    with pytest.raises(AssertionError):
        _assert_held(bad, ref)


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


def _bwd_case(dt, dev, bh, nq, nk, d, dv, dead_rows=(), dead_keys=None, seed=20):
    q, k, v, do = (_rand(s, seed + i).to(dev, dt) for i, s in enumerate(
        [(bh, nq, d), (bh, nk, d), (bh, nk, dv), (bh, nq, dv)]))
    bias = None
    if dead_keys is not None or dead_rows:
        bias = torch.zeros(bh, nk, device=dev)
        if dead_keys is not None:
            bias[:, dead_keys[0]:dead_keys[1]] = -1e30
        for r in dead_rows:
            bias[r] = -1e30
    out, lse = att.flash_attention_ref(q, k, v, bias)
    delta = (do.float() * out.float()).sum(-1)
    return (q, k, v, bias, do, lse, delta), out


# K3 shapes of the memory attention widths with ragged edges: (bh, nq, nk, D,
# Dv, dead key range, dead rows): D = 256 with Dv = 64 (cross-attention) and
# D = Dv = 256 (self-attention), Nq and Nk off every tile
K3_WIDE = [(2, 200, 300, 256, 64, (100, 164), (1,)), (2, 150, 170, 256, 256, None, ())]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", K3_WIDE, ids=lambda s: "x".join(map(str, s[:5])))
def test_backward_kernels_wide_match_plain_on_cuda(dev, dtype, shape):
    """K3a / K3b at D = 256 against flash_attention_bwd_ref; in fp32 the
    planted one-TF32-pass fault (hi * hi alone) must fail the tolerance by
    at least 7x, as in chip_smoke.py."""
    dt = getattr(torch, dtype)
    bh, nq, nk, d, dv, dead, rows = shape
    args, out = _bwd_case(dt, dev, bh, nq, nk, d, dv, rows, dead)
    refs = att.flash_attention_bwd_ref(*args[:4], out, args[5], args[4])
    got = (att.flash_bwd_dq(*args),) + att.flash_bwd_dkv(*args)
    for g, r in zip(got, refs):
        assert bool(torch.isfinite(g).all())
        _assert_held(g, r)
    for r in rows:
        assert all(bool((g[r] == 0).all()) for g in got)
    if dt == torch.float32:
        code = att.BWD_FAULTS["one TF32 pass"]
        bad = (att.flash_bwd_dq(*args, fault=code),) + att.flash_bwd_dkv(*args, fault=code)
        worst = max(max(e / gate for e, gate in zip(_errors(b, r), (MAX_ULPS[dt], MEAN_EPS[dt])))
                    for b, r in zip(bad, refs))
        assert worst >= 7, f"one TF32 pass reads {worst:.3g}x the tolerance"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_backward_kernels_are_deterministic_on_cuda(dev, dtype):
    """Two launches of K3a and of K3b on the same inputs give the same bits
    (no atomics: every block owns its output rows)."""
    dt = getattr(torch, dtype)
    args, _ = _bwd_case(dt, dev, 2, 300, 700, 256, 64, dead_keys=(64, 96))
    first = (att.flash_bwd_dq(*args),) + att.flash_bwd_dkv(*args)
    second = (att.flash_bwd_dq(*args),) + att.flash_bwd_dkv(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_k2_at_the_batched_streamers_8_object_rows_on_cuda(dev):
    """K2 at the batched streamer's shape (4 videos x 2 objects = 8 object
    rows, 2 cond tiles attended: 9 slots) in bf16 at the serving widths, each
    video's rows live only in its own cond tile (the other video's cond
    frame masked, as the merged bank's per-object validity does). The
    pre-pass equals its plain version bit for bit; the whole K2 holds
    against its plain version; K2 reading the slots rolled by one (a
    planted fault) must fail the tolerance."""
    from det_sam2_tpu_torch.modeling.position_encoding import axial_rope_cos_sin

    dt = torch.bfloat16
    b, nq, s, d, cm, nl, ktot, layer = 8, 1024, 4096, 256, 64, 4, 12, 2
    t = 2 + 6 + 1
    g = torch.Generator(device=dev).manual_seed(80)
    q = torch.randn(b, nq, d, generator=g, device=dev).to(dt)
    mem_k = torch.randn(ktot, b, nl, s, d, generator=g, device=dev).to(dt)
    mem_v = torch.randn(ktot, b, s, cm, generator=g, device=dev).to(dt)
    slots = torch.tensor([0, 1, 4, 5, 6, 7, 8, 9, ktot - 1], dtype=torch.int32, device=dev)
    w = torch.randn(t, d, generator=g, device=dev)
    w[-1] = 0.0  # the staging tile is not rotated
    cos, sin = (torch.as_tensor(x, device=dev) for x in axial_rope_cos_sin(d, 64, 64))
    live = torch.ones(b, t, s, dtype=torch.bool, device=dev)
    live[:4, 1] = False  # videos 0-1: prompted at the first cond frame only
    live[4:, 0] = False  # videos 2-3: at the second
    live[:, -1, 16:] = False  # 16 pointer tokens in the staging tile
    bias = torch.where(live, 0.0, -1e30).reshape(b, t * s)
    args = (q, mem_k, mem_v, slots, w, bias, cos, sin, layer)
    before = dict(att.LAUNCHES)
    out = att.flash_attention_banked_fwd(*args)
    for name in ("flash_banked_keys", "flash_banked_fwd"):
        assert att.LAUNCHES[name] == before[name] + 1, name
    ref = att.flash_attention_banked_ref(*args)
    _assert_held(out, ref)
    keys = att.flash_banked_keys(mem_k, slots, w, cos, sin, layer, s)
    assert torch.equal(keys, att.banked_keys(mem_k, slots, w, cos, sin, layer, dt, s))
    bad = att.flash_attention_banked_fwd(q, mem_k, mem_v, torch.roll(slots, 1), *args[4:])
    with pytest.raises(AssertionError):
        _assert_held(bad, ref)


@pytest.mark.cuda
def test_k1_at_the_batched_streamers_memory_self_attention_on_cuda(dev):
    """K1 at the batched streamer's memory self-attention ([8 object rows,
    4096, 256] bf16, no bias) against flash_attention_ref; the planted
    wrong-ring-stage fault must fail."""
    q, k, v = (_rand((8, 4096, 256), 30 + i).to(dev, torch.bfloat16) for i in range(3))
    before = att.LAUNCHES["flash_fwd"]
    out, _ = att.flash_attention_fwd(q, k, v)
    assert att.LAUNCHES["flash_fwd"] == before + 1
    ref, _ = att.flash_attention_ref(q, k, v)
    _assert_held(out, ref)
    bad, _ = att.flash_attention_fwd(
        q, k, v, fault=att.FWD_FAULTS["consumer reads the wrong ring stage"])
    with pytest.raises(AssertionError):
        _assert_held(bad, ref)


@pytest.mark.cuda
def test_engine_encodes_the_same_bits_on_any_thread_on_cuda(dev):
    """A CUDA engine turns torch's cuDNN attention backend off: at Hiera-S's
    windowed-attention shapes it is torch's first pick on an H100 and its
    bits depend on the calling thread, so a session served on the server's
    handler threads would differ from the same session on another thread."""
    import threading

    from det_sam2_tpu_torch.configs import sam2_1_hiera_s
    from det_sam2_tpu_torch.track import SAM2Engine

    eng = SAM2Engine(sam2_1_hiera_s(), dtype=torch.bfloat16, device=dev, seed=0)
    assert not torch.backends.cuda.cudnn_sdp_enabled()
    frame = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (1, 1024, 1024, 3), dtype=np.uint8)).to(dev)
    here = eng.encode_image(frame)
    for _ in range(3):
        box = {}
        t = threading.Thread(target=lambda: box.update(f=eng.encode_image(frame)))
        t.start()
        t.join()
        assert all(torch.equal(a, b) for a, b in zip(here, box["f"]))


@pytest.mark.cuda
def test_trainer_checkpoint_round_trip_on_cuda(dev, tmp_path):
    """A trainer on the card (tiny config, fp32, the kernels on its path)
    saves ckpt_0000.pt; a fresh trainer loaded from it holds the parameters
    and the optimizer state bit for bit, and its next step equals the live
    trainer's on the same batch and step seed."""
    from det_sam2_tpu_torch.configs import tiny_test_config
    from det_sam2_tpu_torch.track import SAM2Engine
    from det_sam2_tpu_torch.training import dataset as pd
    from det_sam2_tpu_torch.training.train_step import OptimConf
    from det_sam2_tpu_torch.training.trainer import Trainer, TrainerConf, kind_schedule

    def trainer(seed, ckdir):
        eng = SAM2Engine(tiny_test_config(), device=dev, seed=seed)
        return Trainer(eng.cfg, eng, OptimConf(base_lr=1e-4, total_steps=4),
                       TrainerConf(num_epochs=1, steps_per_epoch=2, log_every=1,
                                   checkpoint_dir=str(ckdir),
                                   prompt_kind_probs={"box": 1.0}, num_correction_steps=1))

    def loader(seed):
        return pd.VOSDataLoader(pd.SyntheticRawDataset(num_videos=2, num_frames=4),
                                pd.RandomUniformSampler(num_frames=3), image_size=128,
                                batch_size=2, seed=seed)

    live = trainer(0, tmp_path / "a")
    live.run(loader(0))
    fresh = trainer(7, tmp_path / "b")
    fresh.load_checkpoint(str(tmp_path / "a" / "ckpt_0000.pt"))
    for (n, a), b in zip(live.model.state_dict().items(), fresh.model.state_dict().values()):
        assert a.is_cuda and torch.equal(a, b), n
    sa, sb = live.optimizer.adamw.state_dict(), fresh.optimizer.adamw.state_dict()
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    images, gt = next(iter(loader(3).batches(1)))
    sch = kind_schedule("box", 1)
    got = [t._step(images, gt, t._generator(), schedule=sch) for t in (live, fresh)]
    for k in got[0]:
        torch.testing.assert_close(got[1][k], got[0][k], rtol=1e-5, atol=0, msg=k)
    for (n, a), b in zip(live.model.state_dict().items(), fresh.model.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-7, msg=n)
