"""The training slice as a whole vs the JAX package: forward_training, the
multi-step loss, the backward and one step of the MOSE optimizer.

A JAX SAM2Model at tiny_test_config (random weights, the object-score
head's output bias raised to +1 so that objects count as present and the
masks depend on the features) is converted with convert.from_jax_params and
loaded into the port's SAM2Model. Both take their attention through the
flash route at this tiny size (min_flops=0; JAX with 128 blocks, Pallas in
interpret mode, forward and backward; the port's FlashAttention with its
plain forward and backward). Schedules without random draws (boxes with
box_noise=0, GT-mask prompts, no correction clicks) make the two forwards
the same function. fp32, TF32 off.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from det_sam2_tpu.configs import tiny_test_config as jax_tiny_config
from det_sam2_tpu.modeling.sam2_base import SAM2Model as JaxModel
from det_sam2_tpu.ops import attention as jatt
from det_sam2_tpu.track import SAM2Engine as JaxEngine
from det_sam2_tpu.training import loss_fns as jloss
from det_sam2_tpu.training import sam2_train as jtrain
from det_sam2_tpu.training import train_step as jstep

from det_sam2_tpu_torch import convert
from det_sam2_tpu_torch.configs import tiny_test_config
from det_sam2_tpu_torch.modeling.sam2_base import SAM2Model
from det_sam2_tpu_torch.ops import attention as att
from det_sam2_tpu_torch.training.loss_fns import DEFAULT_WEIGHTS, MultiStepMultiMasksAndIous
from det_sam2_tpu_torch.training.sam2_train import PromptSchedule, forward_training
from det_sam2_tpu_torch.training.train_step import OptimConf, make_optimizer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# mask logits (|x| up to ~1e3 with NO_OBJ_SCORE) and losses: fp32 through
# the trunk, memory attention and decoder, summation order only
ATOL, RTOL = 2e-3, 1e-4
S = 128

# name -> (schedule fields, objects (None = 4-D GT), T, mask-as-output flag)
CASES = {
    "box_two_objects": (dict(init_cond_frames=(0,), use_box_per_frame=(True,)), 2, 3, True),
    "box_two_cond_frames": (dict(init_cond_frames=(0, 2), use_box_per_frame=(True, True)),
                            None, 3, True),
    "mask_as_output": (dict(init_cond_frames=(0,), use_pt_input=False,
                            use_box_per_frame=(False,)), 2, 3, True),
    "mask_prompt_through_sam": (dict(init_cond_frames=(0,), use_pt_input=False,
                                     use_box_per_frame=(False,)), 2, 3, False),
}


@pytest.fixture(scope="module")
def weights():
    params = jax.tree_util.tree_map(np.array, JaxEngine(jax_tiny_config(), seed=5).params)
    params["sam_mask_decoder"]["pred_obj_score_head"]["layers_2"]["bias"][:] = 1.0
    return params


def _clip(objects, t):
    rng = np.random.default_rng(0)
    images = rng.standard_normal((t, 1, S, S, 3)).astype(np.float32) * 0.2
    k = objects or 1
    gt = np.zeros((t, 1, k, S, S), np.float32)
    for i in range(t):
        gt[i, 0, 0, 30 + 4 * i:70 + 4 * i, 40:90] = 1.0
        if k > 1:
            gt[i, 0, 1, 70:110, 10:40 + 5 * i] = 1.0
    return images, (gt if objects else gt[:, :, 0])


def _jax_loss_fn():
    return jloss.MultiStepMultiMasksAndIous(jloss.DEFAULT_WEIGHTS, supervise_all_iou=True,
                                            iou_use_l1_loss=True, pred_obj_scores=True)


def _port_loss_fn():
    return MultiStepMultiMasksAndIous(DEFAULT_WEIGHTS, supervise_all_iou=True,
                                      iou_use_l1_loss=True, pred_obj_scores=True)


def _rows(gt):
    return gt.reshape(gt.shape[0], -1, S, S)


def _jax_run(params, name, grads=False):
    fields, objects, t, flag = CASES[name]
    cfg = jax_tiny_config(use_mask_input_as_output_without_sam=flag)
    sched = jtrain.PromptSchedule(**fields)
    model = JaxModel(cfg, attention_fn=functools.partial(
        jatt.flash_attention, block_q=128, block_k=128, min_flops=0))
    images, gt = _clip(objects, t)

    def loss_of(p):
        outs = model.apply({"params": p}, method=lambda m: jtrain.forward_training(
            m, cfg, jnp.asarray(images), jnp.asarray(gt), rng=jax.random.PRNGKey(0),
            schedule=sched, box_noise=0.0))
        losses = _jax_loss_fn()(outs, jnp.asarray(_rows(gt)))
        return losses["core_loss"], (outs, losses)

    if grads:
        return jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params)
    return jax.jit(loss_of)(params)


def _port_model(params, name):
    flag = CASES[name][3]
    cfg = tiny_test_config(use_mask_input_as_output_without_sam=flag)
    m = SAM2Model(cfg, attention_fn=functools.partial(att.flash_attention, min_flops=0))
    m.load_state_dict(convert.from_jax_params(params))
    return cfg, m


def _port_run(params, name):
    fields, objects, t, _ = CASES[name]
    cfg, m = _port_model(params, name)
    images, gt = _clip(objects, t)
    outs = forward_training(m, cfg, torch.from_numpy(images), torch.from_numpy(gt),
                            generator=torch.Generator().manual_seed(0),
                            schedule=PromptSchedule(**fields), box_noise=0.0)
    losses = _port_loss_fn()(outs, torch.from_numpy(_rows(gt)))
    return m, outs, losses


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL, err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_forward_training_matches_jax(weights, name):
    """Every frame's multistep masks, ious and object scores, the selected
    high-res mask, and every loss term."""
    _, (jouts, jlosses) = _jax_run(weights, name)
    _, touts, tlosses = _port_run(weights, name)
    assert len(touts) == len(jouts) == CASES[name][2]
    for f, (g, w) in enumerate(zip(touts, jouts)):
        for key in ("multistep_pred_multimasks_high_res", "multistep_pred_ious",
                    "multistep_object_score_logits"):
            assert len(g[key]) == len(w[key])
            for s, (a, b) in enumerate(zip(g[key], w[key])):
                _close(a, b, f"frame {f} {key} step {s}")
        _close(g["pred_masks_high_res"], w["pred_masks_high_res"], f"frame {f} mask")
    assert float(touts[1]["multistep_object_score_logits"][0].min()) > 0, "objects absent"
    for key, w in jlosses.items():
        _close(tlosses[key], w, key)


def test_mose_optimizer_step_matches_jax_and_optax(weights):
    """One step of the MOSE optimizer (vision_lr, layer_decay 0.9, clip 0.1,
    weight-decay mask) at tiny size. The gradients of the port's backward
    must equal JAX's value_and_grad ones, converted with from_jax_params
    (the gradient tree has the parameters' structure and the layout maps
    are linear): per parameter, within 2e-3 of its largest JAX entry plus
    1e-6. Then both optimizers step from the SAME gradients (JAX's, so a
    near-zero gradient whose sign differs by rounding cannot move Adam's
    first update), and the parameters must equal optax's to 1e-7 plus 1e-6
    of their size."""
    name = "box_two_objects"
    (jl, (_, jlosses)), jgrads = _jax_run(weights, name, grads=True)
    cfg, m = _port_model(weights, name)
    fields, objects, t, _ = CASES[name]
    images, gt = _clip(objects, t)
    outs = forward_training(m, cfg, torch.from_numpy(images), torch.from_numpy(gt),
                            schedule=PromptSchedule(**fields), box_noise=0.0)
    tlosses = _port_loss_fn()(outs, torch.from_numpy(_rows(gt)))
    tlosses["core_loss"].backward()
    _close(tlosses["core_loss"], jl, "core_loss")

    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    named = dict(m.named_parameters())
    # every JAX parameter is one of the port's, the prompt encoder's random
    # Fourier matrix (pe_gaussian) included: its gradient and its update are
    # held against JAX's and optax's below like any other
    assert set(want) == set(named)
    assert named["sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"].grad is not None
    for n, p in named.items():
        w = want[n]
        tol = 2e-3 * float(w.abs().max()) + 1e-6
        if p.grad is None:  # not on the path (no_mem_pos_enc): JAX's is 0
            assert float(w.abs().max()) == 0, n
            continue
        err = float((p.grad - w).abs().max())
        assert err <= tol, f"{n}: grad error {err:.3g} > {tol:.3g}"

    conf = OptimConf(base_lr=1e-4, vision_lr=6e-5, weight_decay=0.1, grad_clip_norm=0.1,
                     warmup_steps=0, total_steps=10, layer_decay=0.9)
    jconf = jstep.OptimConf(**dataclasses.asdict(conf))
    jopt = jstep.make_optimizer(jconf, params=weights, cfg=jax_tiny_config())
    jp = jax.tree_util.tree_map(jnp.asarray, weights)
    updates, _ = jopt.update(jgrads, jopt.init(jp), jp)
    jnew = convert.from_jax_params(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(jp, updates)))

    topt = make_optimizer(conf, m, cfg)
    for n, p in named.items():
        p.grad = want[n].clone()
    norm = topt.step()
    np.testing.assert_allclose(float(norm), float(optax.global_norm(jgrads)), rtol=1e-5)
    assert float(norm) > conf.grad_clip_norm  # clipping was active
    before = convert.from_jax_params(weights)
    for n, p in named.items():
        torch.testing.assert_close(p.detach(), jnew[n], atol=1e-7, rtol=1e-6, msg=n)
    for n in ("image_encoder.trunk.blocks.0.attn.qkv.weight",
              "sam_prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"):
        assert not torch.equal(named[n].detach(), before[n]), n


def _heads_inputs():
    rng = np.random.default_rng(0)
    pix = rng.standard_normal((2, 8, 8, 256)).astype(np.float32)
    s0 = rng.standard_normal((2, 32, 32, 32)).astype(np.float32)
    s1 = rng.standard_normal((2, 16, 16, 64)).astype(np.float32)
    return pix, s0, s1


def test_sam_heads_training_flag_matches_jax(weights):
    """Box prompts, single-mask output: out of training the decoder swaps in
    the best multimask output when token 0's mask is unstable (it is, with
    random weights); training=True never swaps. Both flags against JAX."""
    pix, s0, s1 = _heads_inputs()
    boxes = np.asarray([[[5.0, 10.0], [40.0, 52.0]], [[60.0, 30.0], [100.0, 90.0]]],
                       np.float32)
    labels = np.asarray([[2, 3], [2, 3]], np.int32)
    jmodel = JaxModel(jax_tiny_config())
    _, m = _port_model(weights, "box_two_objects")
    got = {}
    for training in (False, True):
        want = jmodel.apply({"params": weights}, jnp.asarray(pix), jnp.asarray(boxes),
                            jnp.asarray(labels), high_res_features=[jnp.asarray(s0),
                                                                    jnp.asarray(s1)],
                            training=training, method=JaxModel.forward_sam_heads)
        with torch.no_grad():
            got[training] = m.forward_sam_heads(
                torch.from_numpy(pix), torch.from_numpy(boxes), torch.from_numpy(labels),
                high_res_features=[torch.from_numpy(s0), torch.from_numpy(s1)],
                training=training)
        for i, (g, w) in enumerate(zip(got[training], want)):
            _close(g, w, f"training={training} output {i}")
    assert not torch.equal(got[False][3], got[True][3])  # the swap happened


def test_use_mask_as_output_matches_jax(weights):
    """GT masks as the output: +-10 logits, the antialiased 1/4 copy, the
    object pointer from the SAM heads on the downsampled mask, the
    occupancy object score (one mask empty)."""
    pix, s0, s1 = _heads_inputs()
    mask = np.zeros((2, S, S, 1), np.float32)
    mask[0, 20:70, 30:90] = 1.0
    want = JaxModel(jax_tiny_config()).apply(
        {"params": weights}, jnp.asarray(pix), [jnp.asarray(s0), jnp.asarray(s1)],
        jnp.asarray(mask), method=JaxModel.use_mask_as_output)
    _, m = _port_model(weights, "mask_as_output")
    with torch.no_grad():
        got = m.use_mask_as_output(torch.from_numpy(pix),
                                   [torch.from_numpy(s0), torch.from_numpy(s1)],
                                   torch.from_numpy(mask))
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"output {i}")
    assert got[6].flatten().tolist() == [10.0, -10.0]
