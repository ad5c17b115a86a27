"""The training slice's pieces vs the JAX package, on the CPU.

K3's plain backward against the JAX Pallas backward kernels (interpret mode,
128 blocks, so tile skipping and padding happen); K1's autograd Function
against jax.vjp; K2 refusing a gradient; the samplers given the same noise;
the prompt schedule given the same numpy rng; the multi-step loss; drop-path
and rematerialisation. Inputs are seeded numpy arrays given to both sides.
fp32 with TF32 off; each tolerance is stated where it is used.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from det_sam2_tpu.ops import attention as jatt
from det_sam2_tpu.training import loss_fns as jloss
from det_sam2_tpu.training import samplers as jsamplers
from det_sam2_tpu.training import train_step as jstep
from det_sam2_tpu.training.sam2_train import PromptSimConf as JaxPromptSimConf
from det_sam2_tpu.training.sam2_train import mask_to_box as jax_mask_to_box
from det_sam2_tpu.training.sam2_train import (
    sample_prompt_schedule as jax_sample_prompt_schedule,
)

from det_sam2_tpu_torch import convert
from det_sam2_tpu_torch.configs import tiny_test_config
from det_sam2_tpu_torch.modeling.layers import drop_path, sdpa_lse
from det_sam2_tpu_torch.modeling.sam2_base import SAM2Model
from det_sam2_tpu_torch.ops import attention as att
from det_sam2_tpu_torch.training import samplers
from det_sam2_tpu_torch.training.loss_fns import MultiStepMultiMasksAndIous
from det_sam2_tpu_torch.training.sam2_train import (
    PromptSimConf,
    forward_training,
    sample_prompt_schedule,
)
from det_sam2_tpu_torch.training.train_step import (
    OptimConf,
    make_optimizer,
    make_train_step,
)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


# (bh, nq, nk, d, dv, bias pattern)
K3_CASES = {
    "no_bias_ragged": (2, 130, 300, 32, 32, None),
    "dead_tile": (2, 128, 384, 32, 32, "dead_tile"),
    "dead_row": (3, 64, 256, 32, 32, "dead_row"),
    "dv_ne_d": (2, 96, 200, 64, 16, "dead_tile"),
    "d56": (2, 100, 140, 56, 56, None),
}


def _k3_inputs(name):
    bh, nq, nk, d, dv, pattern = K3_CASES[name]
    q, k, v = _rand((bh, nq, d), 0), _rand((bh, nk, d), 1), _rand((bh, nk, dv), 2)
    do = _rand((bh, nq, dv), 3)
    bias = None
    if pattern is not None:
        valid = np.random.default_rng(4).random((bh, nk)) > 0.3
        valid[:, 128:256] = False  # one whole 128-key tile dead (skipped)
        if pattern == "dead_row":
            valid[1] = False  # no live key at all
        bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    return q, k, v, bias, do


@pytest.mark.parametrize("name", list(K3_CASES))
def test_k3_plain_matches_pallas(name):
    """flash_attention_bwd_ref against _flash_bwd_call (K3a + K3b in
    interpret mode) on the same out / lse. Tolerance 1e-4 absolute on
    gradients of magnitude ~1-10: fp32, summation order only."""
    q, k, v, bias, do = _k3_inputs(name)
    jb = None if bias is None else jnp.asarray(bias)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    out, lse = jatt._flash_call(jq, jk, jv, jb, block_q=128, block_k=128, interpret=True)
    want = jatt._flash_bwd_call(jq, jk, jv, jb, out, lse, jnp.asarray(do), block_q=128,
                                block_k=128, interpret=True)
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    got = att.flash_attention_bwd_ref(t(q), t(k), t(v), t(bias), t(out), t(lse), t(do))
    for n, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, err_msg=n)
    if name == "dead_row":
        assert all(float(g[1].abs().max()) == 0 for g in got)


@pytest.mark.parametrize("name", ["no_bias_ragged", "dead_tile", "dv_ne_d", "d56"])
def test_flash_function_grads_match_jax_vjp(name, monkeypatch):
    """The port's flash_attention (FlashAttention on CPU: plain forward and
    backward) against jax.vjp of the JAX flash_attention (Pallas forward and
    backward, interpret mode). The bias gets no gradient on either side.
    Tolerance 1e-4 absolute (fp32, summation order)."""
    q, k, v, bias, do = _k3_inputs(name)
    q, k, v, do = (x[:, None] for x in (q, k, v, do))  # [B, H=1, N, D]
    b4 = None if bias is None else bias[:, None, None, :]
    fn = functools.partial(jatt.flash_attention, block_q=128, block_k=128, min_flops=0)
    out, vjp = jax.vjp(lambda a, b_, c: fn(a, b_, c, None if b4 is None else jnp.asarray(b4)),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tb = None if b4 is None else torch.from_numpy(b4).requires_grad_()
    got = att.flash_attention(tq, tk, tv, tb, min_flops=0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=2e-5)
    calls = []
    bwd = att.flash_attention_bwd_ref

    def counted(*a):
        calls.append(1)
        return bwd(*a)

    monkeypatch.setattr(att, "flash_attention_bwd_ref", counted)
    got.backward(torch.from_numpy(do))
    assert calls == [1]  # the CPU route is the card's: FlashAttention.backward
    for n, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, err_msg=n)
    if tb is not None:
        assert tb.grad is None  # as JAX: no gradient for the mask


@pytest.mark.parametrize("with_bias", [False, True])
def test_plain_backward_is_autograd_of_plain_forward(with_bias):
    """In fp32 (no rounding of dS) the plain backward equals torch autograd
    through sdpa_lse; 1e-5 absolute."""
    q, k, v, bias, do = _k3_inputs("dead_tile" if with_bias else "no_bias_ragged")
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tb = None if bias is None else torch.from_numpy(bias)[:, None, :]
    out, lse = sdpa_lse(tq, tk, tv, tb)
    out.backward(torch.from_numpy(do))
    got = att.flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                      None if bias is None else torch.from_numpy(bias),
                                      out.detach(), lse.detach(), torch.from_numpy(do))
    for g, w in zip(got, (tq.grad, tk.grad, tv.grad)):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("plain", [False, True])
def test_banked_attention_refuses_a_gradient(plain):
    """K2 is inference only on every device: differentiating its output
    raises with the JAX message (CPU tensors here; the card takes the same
    gate)."""
    b, nq, d, cm, s, ktot, t = 2, 64, 32, 16, 32, 4, 3
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(rng.standard_normal(sh).astype(np.float32)) for sh in (
        (b, 1, nq, d), (ktot, b, 2, s, d), (ktot, b, s, cm))]
    args += [torch.tensor([2, 0, 3], dtype=torch.int32),
             torch.from_numpy(_rand((t, d), 1)), torch.zeros(b, t * s),
             torch.from_numpy(_rand((s, d // 2), 2)), torch.from_numpy(_rand((s, d // 2), 3))]
    args[0].requires_grad_()
    out = att.flash_attention_banked(*args, 1, plain=plain)
    with pytest.raises(NotImplementedError, match="inference-only"):
        out.sum().backward()
    with torch.no_grad():  # inference is untouched
        att.flash_attention_banked(*args, 1, plain=plain)


def test_mask_to_box_matches_jax():
    m = np.zeros((3, 40, 50), np.float32)
    m[0, 5:20, 7:31] = 1.0
    m[2, 39, 0] = 1.0  # one pixel at the corner; row 1 is empty
    np.testing.assert_array_equal(samplers.mask_to_box(torch.from_numpy(m)).numpy(),
                                  np.asarray(jax_mask_to_box(jnp.asarray(m))))


def _gt(seed, b=3, h=48, w=64):
    rng = np.random.default_rng(seed)
    m = np.zeros((b, h, w), np.float32)
    for i in range(b):
        y, x = rng.integers(0, h // 2), rng.integers(0, w // 2)
        m[i, y:y + rng.integers(4, h // 2), x:x + rng.integers(4, w // 2)] = 1.0
    return m


@pytest.mark.parametrize("noise", [0.0, 0.1])
def test_sample_box_points_given_the_same_noise(noise):
    gt = _gt(0)
    key = jax.random.PRNGKey(3)
    want_c, want_l = jsamplers.sample_box_points(key, jnp.asarray(gt), noise=noise)
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (gt.shape[0], 4))))
    got_c, got_l = samplers.box_points_from_uniform(u, torch.from_numpy(gt), noise=noise)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), atol=1e-5)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


@pytest.mark.parametrize("with_pred", [False, True])
def test_sample_points_from_errors_given_the_same_noise(with_pred):
    gt = _gt(1)
    pred = _gt(2) if with_pred else None
    if with_pred:
        pred[1] = gt[1]  # an all-correct row: a background click
    key = jax.random.PRNGKey(5)
    b, h, w = gt.shape
    want_c, want_l = jsamplers.sample_random_points_from_errors(
        key, jnp.asarray(gt), None if pred is None else jnp.asarray(pred), num_pt=2)
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (b, 2, h, w, 2))))
    got_c, got_l = samplers.error_points_from_uniform(
        u, torch.from_numpy(gt), None if pred is None else torch.from_numpy(pred))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_prompt_schedule_matches_jax_over_seeds():
    conf, jconf = PromptSimConf(), JaxPromptSimConf()
    seen = set()
    for seed in range(200):
        for frames in (1, 3, 8):
            got = sample_prompt_schedule(np.random.default_rng(seed), frames, conf)
            want = jax_sample_prompt_schedule(np.random.default_rng(seed), frames, jconf)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (seed, frames)
            seen.add((got.use_pt_input, got.use_box_per_frame[0],
                      len(got.init_cond_frames)))
    assert len(seen) >= 5  # box, click and mask schedules, 1 and 2 cond frames


@pytest.mark.parametrize("pred_obj_scores,supervise_all_iou", [(True, True), (False, False)])
def test_multistep_loss_matches_jax(pred_obj_scores, supervise_all_iou):
    """Two frames, multi-step (1 and 3 steps) and multimask (M = 3 and 1),
    with an object row that is empty in every frame (padding). 1e-5
    relative."""
    t, n, h, w = 2, 3, 24, 20
    gt = np.zeros((t, n, h, w), np.float32)
    gt[0, 0, 3:15, 2:12] = 1.0
    gt[1, 0, 5:17, 4:14] = 1.0
    gt[0, 1, 10:20, 10:18] = 1.0  # row 1 absent in frame 1; row 2 is padding
    outs = []
    for f, steps in enumerate((1, 3)):
        m = [3 if s == 0 else 1 for s in range(steps)]
        outs.append({
            "multistep_pred_multimasks_high_res": [_rand((n, mm, h, w), 10 * f + s, 4.0)
                                                   for s, mm in enumerate(m)],
            "multistep_pred_ious": [np.abs(_rand((n, mm), 20 + 10 * f + s))
                                    for s, mm in enumerate(m)],
            "multistep_object_score_logits": [_rand((n, 1), 40 + 10 * f + s)
                                              for s, mm in enumerate(m)],
        })
    kw = dict(supervise_all_iou=supervise_all_iou, iou_use_l1_loss=True,
              pred_obj_scores=pred_obj_scores)
    want = jloss.MultiStepMultiMasksAndIous(jloss.DEFAULT_WEIGHTS, **kw)(
        [{k: [jnp.asarray(a) for a in v] for k, v in o.items()} for o in outs],
        jnp.asarray(gt))
    got = MultiStepMultiMasksAndIous(None, **kw)(
        [{k: [torch.from_numpy(a) for a in v] for k, v in o.items()} for o in outs],
        torch.from_numpy(gt))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# drop-path and rematerialisation
# ---------------------------------------------------------------------------


def test_drop_path_rate_zero_and_inference_are_the_identity():
    x = torch.from_numpy(_rand((6, 4, 4, 8), 0))
    g = torch.Generator().manual_seed(0)
    state = g.get_state()
    assert drop_path(x, 0.0, g) is x
    assert drop_path(x, 0.5) is x  # no generator: inference never draws
    assert torch.equal(g.get_state(), state)


def test_drop_path_keep_share_and_scale():
    x = torch.ones(20000, 3)
    y = drop_path(x, 0.5, torch.Generator().manual_seed(1))
    kept = y[:, 0] != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.02  # 20000 draws: sd 0.0035
    assert torch.all(y[kept] == 2.0) and torch.all(y[~kept] == 0.0)
    assert torch.all((y == 0).all(1) | (y != 0).all(1))  # one mask per sample


def _dp_model(rate=0.3):
    base = tiny_test_config()
    cfg = dataclasses.replace(base, hiera=dataclasses.replace(base.hiera,
                                                               drop_path_rate=rate))
    m = SAM2Model(cfg, attention_fn=functools.partial(att.flash_attention, min_flops=0))
    sd = convert.init_params(m, 0)
    # objects present (score > 0), so that the masks, and the loss, depend
    # on the image features: with the random init every mask would be the
    # NO_OBJ_SCORE constant
    sd["sam_mask_decoder.pred_obj_score_head.layers.2.bias"].fill_(1.0)
    m.load_state_dict(sd)
    return cfg, m


def _clip(t=3):
    rng = np.random.default_rng(0)
    s = 128
    images = torch.from_numpy(rng.standard_normal((t, 1, s, s, 3)).astype(np.float32) * 0.2)
    gt = np.zeros((t, 1, s, s), np.float32)
    for i in range(t):
        gt[i, 0, 30 + 4 * i:70 + 4 * i, 40:90] = 1.0
    return images, torch.from_numpy(gt)


def test_inference_forward_never_draws():
    cfg, m = _dp_model()
    img = torch.from_numpy(_rand((2, 128, 128, 3), 0))
    with torch.no_grad():
        a = m.forward_image(img)
        keep = m.image_encoder.trunk.draw_drop_path(2, torch.Generator().manual_seed(0),
                                                    img.device)
        c = m.forward_image(img, generator=torch.Generator().manual_seed(0))
    assert keep is not None and not bool(keep.all())  # the seed drops something
    assert not torch.equal(a[2], c[2])  # drop-path is live with a generator
    with torch.no_grad():
        a2 = m.forward_image(img)
    assert all(torch.equal(x, y) for x, y in zip(a, a2))


def test_remat_on_and_off_give_the_same_loss_and_gradients():
    """The trap of rematerialisation with drop-path: the masks are drawn
    once, outside the checkpointed encoder, so the recomputation replays
    them. Same generator seed -> the same loss and the same gradient of
    every parameter with remat on and off (1e-6 absolute: the same ops)."""
    images, gt = _clip()
    loss_fn = MultiStepMultiMasksAndIous(None, supervise_all_iou=True, iou_use_l1_loss=True,
                                         pred_obj_scores=True)
    results = []
    for remat in (False, True):
        cfg, m = _dp_model()
        cfg = dataclasses.replace(cfg, remat_image_encoder=remat)
        outs = forward_training(m, cfg, images, gt,
                                generator=torch.Generator().manual_seed(7))
        loss = loss_fn(outs, gt)["core_loss"]
        loss.backward()
        results.append((float(loss.detach()), {n: p.grad.clone() for n, p in m.named_parameters()
                                      if p.grad is not None}))
    (l0, g0), (l1, g1) = results
    assert l0 == pytest.approx(l1, abs=1e-6)
    assert set(g0) == set(g1) and any(k.startswith("image_encoder.trunk") for k in g0)
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], atol=1e-6, rtol=0, msg=n)
    # and the masks were live: rate 0 gives another loss
    cfg0, m0 = _dp_model(rate=0.0)
    outs = forward_training(m0, cfg0, images, gt, generator=torch.Generator().manual_seed(7))
    assert float(loss_fn(outs, gt)["core_loss"]) != pytest.approx(l0, abs=1e-4)


def test_make_train_step_does_not_fall_back_to_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg, m = _dp_model()
    opt = make_optimizer(OptimConf(), m)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg, m, opt)
    with pytest.raises(ValueError, match="groups"):
        make_optimizer(OptimConf(layer_decay=0.9), m)
    step = make_train_step(cfg, m, opt, device="cpu")
    images, gt = _clip(2)
    metrics = step(images, gt, torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert float(metrics["grad_norm"]) > 0


@pytest.mark.parametrize("weight_decay_end", [None, 0.01])
def test_optimizer_schedules_match_optax(weight_decay_end):
    """Four steps of TrainOptimizer against the JAX package's optax chain on
    the same gradients: linear warmup then cosine lr, clipping at 0.1
    (active), decay on the 2-D weight only, and the scheduled weight decay
    when weight_decay_end is set. 1e-7 absolute plus 1e-5 relative."""
    kw = dict(base_lr=1e-2, weight_decay=0.1, weight_decay_end=weight_decay_end,
              warmup_steps=2, total_steps=6, cosine_end_ratio=0.1, grad_clip_norm=0.1)
    rng = np.random.default_rng(0)
    w0, b0 = _rand((4, 3), 1), _rand((3,), 2)
    jopt = jstep.make_optimizer(jstep.OptimConf(**kw))
    jp = {"dense": {"kernel": jnp.asarray(w0.T), "bias": jnp.asarray(b0)}}
    state = jopt.init(jp)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    b = torch.nn.Parameter(torch.from_numpy(b0.copy()))
    topt = make_optimizer(OptimConf(**kw), [("dense.weight", w), ("dense.bias", b)])
    for _ in range(4):
        gw, gb = rng.standard_normal((4, 3)).astype(np.float32), _rand((3,), 3)
        grads = {"dense": {"kernel": jnp.asarray(gw.T), "bias": jnp.asarray(gb)}}
        updates, state = jopt.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        w.grad, b.grad = torch.from_numpy(gw.copy()), torch.from_numpy(gb.copy())
        norm = topt.step()
        np.testing.assert_allclose(float(norm), np.sqrt((gw ** 2).sum() + (gb ** 2).sum()),
                                   rtol=1e-6)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jp["dense"]["kernel"]).T,
                                   atol=1e-7, rtol=1e-5)
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(jp["dense"]["bias"]),
                                   atol=1e-7, rtol=1e-5)
