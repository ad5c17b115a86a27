"""The port's bank operations (state.py) vs the JAX package's, field by field.

Each operation runs on the same seeded bank in both packages: cond and
non-cond writes with seeded numpy contents, one cond slot pinned, some object
rows invalid, in gather mode and with the banked-attention caches. The JAX
operations return a new bank; the port's update the bank in place (and
return it), except grow_objects, which returns a new one. They only move,
pad and invalidate values, so every field must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from det_sam2_tpu import state as jstate
from det_sam2_tpu.configs import tiny_test_config as jax_tiny_config

from det_sam2_tpu_torch import state
from det_sam2_tpu_torch.configs import tiny_test_config

O, L = 2, 2
KW = dict(memory_temporal_stride_for_eval=2, cond_attn_size=3)
# (bank, frame, pinned, obj_valid)
WRITES = (
    [("cond", 0, True, (1, 1)), ("cond", 30, False, (1, 0)), ("cond", 4, False, (0, 1))]
    + [("noncond", t, False, (1, t % 5 != 0)) for t in range(1, 10)]
)
FIELDS = [f.name for f in dataclasses.fields(state.MemoryBank)]


def _banks(banked_layers: int):
    cfg, jcfg = tiny_test_config(**KW), jax_tiny_config(**KW)
    jbank = jstate.init_bank(jcfg, O, attend_cond_tiles=2, banked_layers=banked_layers)
    tbank = state.init_bank(cfg, O, attend_cond_tiles=2, banked_layers=banked_layers,
                            device="cpu")
    s, cm, c = cfg.image_embedding_size ** 2, cfg.mem_dim, cfg.hidden_dim
    d = cfg.memory_attention.d_model
    rng = np.random.default_rng(1)
    for kind, t, pinned, valid in WRITES:
        mem = rng.standard_normal((O, s, cm)).astype(np.float32)
        ptr = rng.standard_normal((O, c)).astype(np.float32)
        mem_k = (rng.standard_normal((O, banked_layers, s, d)).astype(np.float32)
                 if banked_layers else None)
        valid = np.asarray(valid, bool)
        jk = None if mem_k is None else jnp.asarray(mem_k)
        tk = None if mem_k is None else torch.from_numpy(mem_k)
        if kind == "cond":
            jbank = jstate.write_cond(jbank, t, jnp.asarray(mem), jnp.asarray(ptr),
                                      jnp.asarray(valid), pinned=pinned, mem_k=jk)
            state.write_cond(tbank, t, torch.from_numpy(mem), torch.from_numpy(ptr),
                             torch.from_numpy(valid), pinned=pinned, mem_k=tk)
        else:
            jbank = jstate.write_noncond(jbank, t, jnp.asarray(mem), jnp.asarray(ptr),
                                         jnp.asarray(valid), mem_k=jk)
            state.write_noncond(tbank, t, torch.from_numpy(mem), torch.from_numpy(ptr),
                                torch.from_numpy(valid), mem_k=tk)
    return jbank, tbank


def _assert_equal(jbank, tbank, what):
    for f in FIELDS:
        want, got = getattr(jbank, f), getattr(tbank, f)
        if f == "attend_cond_tiles" or want is None:
            assert got == want, f"{what}: {f}"
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"{what}: {f}")


BANK_MODES = pytest.mark.parametrize("banked_layers", [0, L], ids=["gather", "banked"])


@BANK_MODES
def test_seeded_banks_match(banked_layers):
    _assert_equal(*_banks(banked_layers), "after the writes")


@BANK_MODES
@pytest.mark.parametrize("new_o", [2, 3, 4])
def test_grow_objects(banked_layers, new_o):
    jbank, tbank = _banks(banked_layers)
    grown = state.grow_objects(tbank, new_o)
    _assert_equal(jstate.grow_objects(jbank, new_o), grown, f"grow to {new_o}")
    assert grown.num_objects == new_o
    assert (grown is tbank) == (new_o == O)  # a new bank unless nothing grows


@BANK_MODES
@pytest.mark.parametrize("min_keep, max_keep", [(5, None), (3, 7), (31, None), (0, 2)])
def test_release_frames(banked_layers, min_keep, max_keep):
    jbank, tbank = _banks(banked_layers)
    jmax = None if max_keep is None else jnp.int32(max_keep)
    want = jstate.release_frames(jbank, jnp.int32(min_keep), jmax)
    assert state.release_frames(tbank, min_keep, max_keep) is tbank
    _assert_equal(want, tbank, f"release [{min_keep}, {max_keep}]")
    # the pinned preload frame 0 survives every release
    assert 0 in tbank.cond_frame_idx.tolist()


@BANK_MODES
@pytest.mark.parametrize("frame_idx", [4, 30, 0, 17], ids=["cond", "cond-one-row-valid",
                                                          "cond-pinned", "absent"])
def test_demote_cond_frame(banked_layers, frame_idx):
    jbank, tbank = _banks(banked_layers)
    want = jstate.demote_cond_frame(jbank, jnp.int32(frame_idx))
    assert state.demote_cond_frame(tbank, frame_idx) is tbank
    _assert_equal(want, tbank, f"demote {frame_idx}")
    present = frame_idx in (0, 4, 30)
    assert (frame_idx in tbank.noncond_frame_idx.tolist()) == present
    assert frame_idx not in tbank.cond_frame_idx.tolist()


@pytest.mark.parametrize("frame_idx, radius", [(5, 2), (1, 0), (20, 3), (9, 30)])
def test_clear_noncond_around(frame_idx, radius):
    jbank, tbank = _banks(L)
    want = jstate.clear_noncond_around(jbank, jnp.int32(frame_idx), jnp.int32(radius))
    _assert_equal(want, state.clear_noncond_around(tbank, frame_idx, radius),
                  f"clear around {frame_idx} +- {radius}")


@pytest.mark.parametrize("frame_idx", [3, 9, 30])
def test_invalidate_noncond(frame_idx):
    jbank, tbank = _banks(0)
    want = jstate.invalidate_noncond(jbank, jnp.int32(frame_idx))
    _assert_equal(want, state.invalidate_noncond(tbank, frame_idx),
                  f"invalidate {frame_idx}")


@pytest.mark.parametrize("frame_idx", [0, 4, 8])
def test_remove_cond_frame(frame_idx):
    jbank, tbank = _banks(0)
    want = jstate.remove_cond_frame(jbank, jnp.int32(frame_idx))
    _assert_equal(want, state.remove_cond_frame(tbank, frame_idx),
                  f"remove cond {frame_idx}")


@BANK_MODES
@pytest.mark.parametrize("obj_idx", [0, 1])
def test_clear_object_rows(banked_layers, obj_idx):
    jbank, tbank = _banks(banked_layers)
    want = jstate.clear_object_rows(jbank, obj_idx)
    _assert_equal(want, state.clear_object_rows(tbank, obj_idx), f"clear {obj_idx}")
    assert not tbank.cond_obj_valid[:, obj_idx].any()


@pytest.mark.parametrize("cond_attn_size, cond_bank_size",
                         [(20, 32), (3, 4), (20, 4), (1, 8), (6, 32)])
def test_cond_tile_bucket(cond_attn_size, cond_bank_size):
    kw = dict(cond_attn_size=cond_attn_size, cond_bank_size=cond_bank_size)
    cfg, jcfg = tiny_test_config(**kw), jax_tiny_config(**kw)
    for live in range(0, 40):
        assert state.cond_tile_bucket(cfg, live) == jstate.cond_tile_bucket(jcfg, live)
