"""The port's checkpoint utilities vs the JAX package's, through the name map.

The JAX package names parameters by dotted flax paths
(``image_encoder.trunk.blocks_0.attn.qkv.kernel``); the port by the SAM 2.1
state-dict names that ``convert.from_jax_params`` gives
(``image_encoder.trunk.blocks.0.attn.qkv.weight``). The map between them is
read off ``convert`` itself: every JAX leaf is filled with its own index and
converted. A logical pattern written in each package's names must select
the same parameters; partial loads, strictness and freezing through one
optimizer step must agree with JAX's. Tiny config, fp32, seeded weights.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from det_sam2_tpu.configs import tiny_test_config as jax_tiny_config
from det_sam2_tpu.track import SAM2Engine as JaxEngine
from det_sam2_tpu.training import checkpoint_utils as jcu
from det_sam2_tpu.training import train_step as jstep

from det_sam2_tpu_torch import convert
from det_sam2_tpu_torch.configs import tiny_test_config
from det_sam2_tpu_torch.modeling.sam2_base import SAM2Model
from det_sam2_tpu_torch.training import checkpoint_utils as cu
from det_sam2_tpu_torch.training.train_step import OptimConf, make_optimizer

torch.backends.cuda.matmul.allow_tf32 = False

# logical pattern -> (JAX names, port names)
PATTERNS = {
    "image encoder": ("image_encoder.*", "image_encoder.*"),
    "trunk block 0": ("image_encoder.trunk.blocks_0.*", "image_encoder.trunk.blocks.0.*"),
    "memory modules": ("memory_*", "memory_*"),
    "point embeddings": ("sam_prompt_encoder.point_embeds",
                         "sam_prompt_encoder.point_embeddings.*"),
    "decoder norms": ("sam_mask_decoder.transformer.layers_*.norm?.*",
                      "sam_mask_decoder.transformer.layers.*.norm?.*"),
    "every bias": ("*.bias", "*.bias"),
}


@pytest.fixture(scope="module")
def setup():
    params = jax.tree_util.tree_map(np.array, JaxEngine(jax_tiny_config(), seed=5).params)
    jax_names = jcu.param_names(params)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    ids = jax.tree_util.tree_unflatten(
        treedef, [np.full(x.shape, i, np.float32) for i, x in enumerate(leaves)])
    name_map = {n: set() for n in jax_names}
    for key, v in convert.from_jax_params(ids).items():
        i = int(v.reshape(-1)[0])
        assert bool((v == i).all()), key
        name_map[jax_names[i]].add(key)
    return params, name_map


def _port_model(params):
    m = SAM2Model(tiny_test_config())
    m.load_state_dict(convert.from_jax_params(params))
    return m


def _mapped(names, name_map):
    return set().union(*(name_map[n] for n in names)) if names else set()


def test_name_map_covers_every_parameter(setup):
    params, name_map = setup
    m = _port_model(params)
    got = set().union(*name_map.values())
    assert got == set(cu.param_names(m)) == set(dict(m.named_parameters()))
    assert all(name_map.values()), [n for n, v in name_map.items() if not v]


@pytest.mark.parametrize("name", list(PATTERNS))
def test_pattern_selection_matches_jax(setup, name):
    """unix_pattern_to_parameter_names, filter_ and exclude_ over the state
    dict, against JAX's over the flax tree."""
    params, name_map = setup
    jpat, ppat = PATTERNS[name]
    sd = _port_model(params).state_dict()
    jsel = jcu.unix_pattern_to_parameter_names([jpat], jcu.param_names(params))
    psel = cu.unix_pattern_to_parameter_names([ppat], sd.keys())
    assert psel and psel == _mapped(jsel, name_map)
    kept = jcu.filter_params_matching_unix_pattern([jpat], params)
    kept_names = {n for n, x in zip(jcu.param_names(params),
                                    jax.tree_util.tree_leaves(kept, is_leaf=lambda x: x is None))
                  if x is not None}
    assert set(cu.filter_params_matching_unix_pattern([ppat], sd)) == _mapped(kept_names, name_map)
    dropped = jcu.exclude_params_matching_unix_pattern([jpat], params)
    left = {n for n, x in zip(jcu.param_names(params),
                              jax.tree_util.tree_leaves(dropped, is_leaf=lambda x: x is None))
            if x is not None}
    assert set(cu.exclude_params_matching_unix_pattern([ppat], sd)) == _mapped(left, name_map)


@pytest.mark.parametrize("strict, ignore_missing, ignore_unexpected", [
    (True, None, None), (False, None, None), (True, ["a.*"], None),
    (True, ["*"], ["x*"]), (False, None, ["x"]),
])
def test_check_load_state_dict_errors_matches_jax(strict, ignore_missing, ignore_unexpected):
    for missing, unexpected in ((["a.w", "b.w"], []), ([], ["x"]), (["a.w"], ["x", "y"]),
                                ([], [])):
        kw = dict(strict=strict, ignore_missing_keys=ignore_missing,
                  ignore_unexpected_keys=ignore_unexpected)
        outcome = []
        for fn in (jcu.check_load_state_dict_errors, cu.check_load_state_dict_errors):
            try:
                fn(missing, unexpected, **kw)
                outcome.append(None)
            except KeyError as e:
                outcome.append(str(e))
        assert outcome[0] == outcome[1]


def test_partial_load_matches_jax(setup):
    """Memory attention from another seed's weights into the model, with
    include / exclude patterns: non-strict loads, the strict refusal, a
    shape check, and the loaded model equal to JAX's loaded tree."""
    params, name_map = setup
    other = jax.tree_util.tree_map(np.array, JaxEngine(jax_tiny_config(), seed=9).params)
    jflat = jcu.params_to_state_dict(other)
    pflat = {k: v.numpy() for k, v in convert.from_jax_params(other).items()}
    for inc, exc in ((["memory_attention.*"], None),
                     (["memory_attention.*"], ["memory_attention.layers.0.*"])):
        m = _port_model(params)
        jexc = None if exc is None else ["memory_attention.layers_0.*"]
        got = jcu.load_state_dict_into_params(jflat, params, strict=False,
                                              include_patterns=inc, exclude_patterns=jexc)
        cu.load_state_dict_into_model(pflat, m, strict=False, include_patterns=inc,
                                      exclude_patterns=exc)
        want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, got))
        for k, v in m.state_dict().items():
            torch.testing.assert_close(v, want[k], atol=0, rtol=0, msg=k)
        changed = {k for k in want if not np.array_equal(want[k].numpy(),
                                                         convert.from_jax_params(params)[k].numpy())}
        assert changed and all(k.startswith("memory_attention.") for k in changed)
        if exc:
            assert not any(k.startswith("memory_attention.layers.0.") for k in changed)
    sub = {k: v for k, v in pflat.items() if k.startswith("memory_attention.")}
    with pytest.raises(KeyError, match="Missing keys"):
        cu.load_state_dict_into_model(sub, m, strict=True)
    with pytest.raises(KeyError, match="Missing keys"):
        jcu.load_state_dict_into_params(jflat | {}, params, strict=True,
                                        include_patterns=["memory_attention.*"])
    cu.load_state_dict_into_model(sub, m, strict=True, ignore_missing_keys=["*"])
    with pytest.raises(KeyError, match="Unexpected"):
        cu.load_state_dict_into_model({"nope.weight": np.zeros(1)}, m, strict=False)
    bad = dict(sub)
    bad["memory_attention.norm.weight"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        cu.load_state_dict_into_model(bad, m, strict=False)


@pytest.mark.parametrize("name", ["image encoder", "point embeddings"])
def test_freezing_through_an_optimizer_step_matches_jax(setup, name):
    """freeze_wrapper on the MOSE optimizer (vision lr, layer decay 0.9,
    clip 0.1, weight decay 0.1), one step from the same seeded gradients:
    the frozen parameters stay bit for bit (weight decay does not move
    them), the rest equal optax's update to 1e-7 + 1e-6 relative, the clip
    counting the frozen gradients as JAX's does; check_parameter_frozen
    holds for the frozen set and raises for a trained one."""
    params, name_map = setup
    jpat, ppat = PATTERNS[name]
    rng = np.random.default_rng(3)
    jgrads = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.01).astype(np.float32), params)
    conf = OptimConf(base_lr=1e-4, vision_lr=6e-5, weight_decay=0.1, grad_clip_norm=0.1,
                     warmup_steps=0, total_steps=10, layer_decay=0.9)
    jopt = jcu.freeze_wrapper(
        jstep.make_optimizer(jstep.OptimConf(**dataclasses.asdict(conf)), params=params,
                             cfg=jax_tiny_config()), params, [jpat])
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    new = jax.jit(lambda g, p: optax.apply_updates(p, jopt.update(g, jopt.init(p), p)[0]))(
        jax.tree_util.tree_map(jnp.asarray, jgrads), jp)
    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, new))

    m = _port_model(params)
    before = {k: v.detach().clone() for k, v in m.named_parameters()}
    opt = cu.freeze_wrapper(make_optimizer(conf, m, tiny_test_config()), m, [ppat])
    grads = convert.from_jax_params(jgrads)
    named = dict(m.named_parameters())
    for n, p in named.items():
        p.grad = grads[n].clone()
    frozen = cu.unix_pattern_to_parameter_names([ppat], named)
    assert frozen == {n for n, f in cu.freeze_mask(m, [ppat]).items() if f}
    with cu.check_parameter_frozen(m, [ppat]):
        norm = opt.step()
    np.testing.assert_allclose(float(norm), float(optax.global_norm(jgrads)), rtol=1e-5)
    for n, p in named.items():
        if n in frozen:
            assert torch.equal(p.detach(), before[n]), n
        else:
            torch.testing.assert_close(p.detach(), want[n], atol=1e-7, rtol=1e-6, msg=n)
    for n in frozen:  # JAX's frozen leaves did not move either
        assert torch.equal(want[n], before[n]), n
    trained = "sam_mask_decoder.iou_token.weight"
    with pytest.raises(ValueError, match="frozen parameters were updated"):
        with cu.check_parameter_frozen(m, [trained]):
            opt.step()


def test_parameters_without_a_gradient_step_as_in_optax(setup):
    """Two MOSE-optimizer steps; in the second the prompt encoder's point
    embeddings and the mask decoder's IoU head have no gradient (a schedule
    that does not reach them): JAX's gradient there is zero, so their
    weight still decays, their Adam moments still move them, and their
    bias correction counts both steps. The port's step must equal optax's
    two updates, those parameters included."""
    params, name_map = setup
    rng = np.random.default_rng(5)
    untouched = ("sam_prompt_encoder.point_embeds", "sam_mask_decoder.iou_prediction_head.*")
    jsel = jcu.unix_pattern_to_parameter_names(list(untouched), jcu.param_names(params))
    g1, g2 = (jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.01).astype(np.float32), params)
        for _ in range(2))
    g2 = jcu.load_state_dict_into_params(
        {n: np.zeros_like(v) for n, v in jcu.params_to_state_dict(g2).items() if n in jsel},
        g2, strict=False)
    conf = OptimConf(base_lr=1e-4, vision_lr=6e-5, weight_decay=0.1, grad_clip_norm=0.1,
                     warmup_steps=0, total_steps=10, layer_decay=0.9)
    jopt = jstep.make_optimizer(jstep.OptimConf(**dataclasses.asdict(conf)), params=params,
                                cfg=jax_tiny_config())

    @jax.jit
    def two_steps(p, a, b):
        st = jopt.init(p)
        u, st = jopt.update(a, st, p)
        p = optax.apply_updates(p, u)
        u, st = jopt.update(b, st, p)
        return optax.apply_updates(p, u)

    want = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, two_steps(
        *(jax.tree_util.tree_map(jnp.asarray, t) for t in (params, g1, g2)))))
    m = _port_model(params)
    opt = make_optimizer(conf, m, tiny_test_config())
    named = dict(m.named_parameters())
    none = _mapped(jsel, name_map)
    assert none
    for grads in (convert.from_jax_params(g1), convert.from_jax_params(g2)):
        for n, p in named.items():
            p.grad = None if (opt.count == 1 and n in none) else grads[n].clone()
        opt.step()
    for n, p in named.items():
        torch.testing.assert_close(p.detach(), want[n], atol=1e-7, rtol=1e-6, msg=n)
