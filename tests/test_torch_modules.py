"""Each ported module vs its JAX counterpart on shared weights.

A JAX SAM2Model at tiny_test_config (random weights) is converted with
convert.from_jax_params and loaded into the port's SAM2Model; the same
seeded numpy inputs go through the same SAM2Model methods on both sides.
fp32 on the CPU; JAX uses its plain sdpa and, for the banked path, its
Pallas kernel in interpret mode; the port uses its kernels' plain versions.
Tolerance 1e-4 (the target for single modules): the two sides differ only
in summation order and op implementations.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from det_sam2_tpu.configs import tiny_test_config as jax_tiny_config
from det_sam2_tpu.modeling.layers import sdpa as jax_sdpa
from det_sam2_tpu.modeling.sam2_base import SAM2Model as JaxModel
from det_sam2_tpu.ops.connected_components import fill_holes_in_mask_scores_jax
from det_sam2_tpu.track import SAM2Engine as JaxEngine

from det_sam2_tpu_torch import convert
from det_sam2_tpu_torch.configs import tiny_test_config
from det_sam2_tpu_torch.modeling.sam2_base import SAM2Model
from det_sam2_tpu_torch.ops.attention import flash_attention, flash_attention_banked
from det_sam2_tpu_torch.ops.connected_components import fill_holes_in_mask_scores

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ATOL = 1e-4


class Pair:
    def __init__(self):
        self.jcfg = jax_tiny_config()
        self.params = jax.tree_util.tree_map(
            np.asarray, JaxEngine(self.jcfg, seed=5).params)
        self.jmodel = JaxModel(self.jcfg, attention_fn=jax_sdpa)
        self.tmodel = SAM2Model(tiny_test_config(), attention_fn=flash_attention,
                                banked_attention_fn=flash_attention_banked)
        self.tmodel.load_state_dict(convert.from_jax_params(self.params))
        self.tmodel.eval()

    def jax(self, method, *args, **kw):
        args = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
        fn = jax.jit(lambda p, *a: self.jmodel.apply(
            {"params": p}, *a, method=getattr(JaxModel, method), **kw))
        return fn(self.params, *args)

    def torch(self, method, *args, **kw):
        args = [torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args]
        with torch.no_grad():
            return getattr(self.tmodel, method)(*args, **kw)


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL, what=""):
    if got is None or want is None:
        assert got is None and want is None, what
        return
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_forward_image(pair, kind):
    rng = np.random.default_rng(0)
    if kind == "uint8":
        img = rng.integers(0, 255, (1, 128, 128, 3), np.uint8)
    else:
        img = _rand((1, 128, 128, 3), 1)
    for i, (g, w) in enumerate(zip(pair.torch("forward_image", img),
                                   pair.jax("forward_image", img))):
        _close(g, w, what=f"level {i}")


def test_memory_attention_attend(pair):
    cfg = pair.jcfg
    nq = cfg.image_embedding_size ** 2
    frames, ptr = 2, 8
    nk = frames * nq + ptr
    feat = _rand((2, 8, 8, 256), 0)
    memory, pos = _rand((2, nk, 64), 1), _rand((2, nk, 64), 2)
    mask = np.random.default_rng(3).random((2, nk)) > 0.3
    mask[1] = False  # an object with no valid memory: dead rows
    args = (feat, memory, pos, mask)
    kw = dict(num_mem_frames=frames, num_obj_ptr_tokens=ptr)
    _close(pair.torch("attend_memory", *args, **kw),
           pair.jax("attend_memory", *args, **kw))


def test_memory_attention_banked_and_project_k(pair):
    cfg = pair.jcfg
    s = cfg.image_embedding_size ** 2
    b, ktot, t = 2, 5, 3
    mem = _rand((b, s, 64), 0)
    for spatial in (True, False):
        _close(pair.torch("project_memory_k", mem, spatial=spatial),
               pair.jax("project_memory_k", jnp.asarray(mem), spatial=spatial),
               what=f"project_k spatial={spatial}")
    mem_k = _rand((ktot, b, 4, s, 256), 1)
    mem_v = _rand((ktot, b, s, 64), 2)
    slots = np.asarray([2, 0, 4], np.int32)
    tpos = _rand((t, 64), 3)
    tpos[-1] = 0.0  # the staging tile
    mask = np.random.default_rng(4).random((b, t * s)) > 0.2
    mask[0, s:2 * s] = False  # a dead tile
    mask[1] = False  # a dead object
    args = (_rand((b, 8, 8, 256), 5), mem_k, mem_v, slots, tpos, mask)
    _close(pair.torch("attend_memory_banked", *args),
           pair.jax("attend_memory_banked", *args))


@pytest.mark.parametrize("multimask", [True, False])
def test_sam_heads_with_box(pair, multimask):
    pix = _rand((2, 8, 8, 256), 0)
    s0, s1 = _rand((2, 32, 32, 32), 1), _rand((2, 16, 16, 64), 2)
    boxes = np.asarray([[[5.0, 10.0], [40.0, 52.0]], [[60.0, 30.0], [100.0, 90.0]]],
                       np.float32)
    labels = np.asarray([[2, 3], [2, 3]], np.int32)
    got = pair.torch("forward_sam_heads", pix, torch.from_numpy(boxes),
                     torch.from_numpy(labels),
                     high_res_features=[torch.from_numpy(s0), torch.from_numpy(s1)],
                     multimask_output=multimask)
    want = pair.jax("forward_sam_heads", pix, jnp.asarray(boxes), jnp.asarray(labels),
                    high_res_features=[jnp.asarray(s0), jnp.asarray(s1)],
                    multimask_output=multimask)
    names = ("low_res_multimasks", "high_res_multimasks", "ious", "low_res_masks",
             "high_res_masks", "obj_ptr", "object_score_logits")
    for name, g, w in zip(names, got, want):
        _close(g, w, what=name)


@pytest.mark.parametrize("binarize", [False, True])
def test_encode_memory(pair, binarize):
    feat = _rand((2, 8, 8, 256), 0)
    high_res = _rand((2, 1, 128, 128), 1, 3.0)
    obj = np.asarray([[0.5], [-0.5]], np.float32)  # one present, one absent
    _close(pair.torch("encode_memory", feat, high_res, obj, binarize=binarize),
           pair.jax("encode_memory", feat, high_res, obj, binarize=binarize))


def test_fill_holes_matches_jax():
    logits = _rand((3, 1, 48, 40), 0)
    logits[0] = np.abs(logits[0])  # all foreground: untouched
    logits[1, 0, 10:14, 10:13] = -1.0  # a 12-pixel hole: too big at 8
    got = fill_holes_in_mask_scores(torch.from_numpy(logits), 8.0)
    want = fill_holes_in_mask_scores_jax(jnp.asarray(logits), 8.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != logits).any()  # some holes were filled
