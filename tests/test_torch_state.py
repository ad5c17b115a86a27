"""The port's memory bank (state.py) vs the JAX package's, write for write.

The same sequence of cond and non-cond writes, with seeded numpy contents,
goes into a JAX bank and a port bank: more cond frames than cond slots (one
pinned, so eviction must pass it over), more non-cond frames than non-cond
slots (eviction by temporal distance), a rewrite of a stored frame, and
object rows marked invalid. Both banks carry the banked-attention caches.
Then select_memory runs on both at several frames, in both directions, with
and without the tile gather and the attended-cond-tile cap. Writes and
selection only copy and compare values, so everything must be equal.
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
    [("cond", 0, True, (1, 1)), ("cond", 30, False, (1, 0)), ("cond", 4, False, (1, 1))]
    + [("noncond", t, False, (1, t % 5 != 0)) for t in range(1, 13)]
    + [("cond", 12, False, (0, 1)), ("cond", 18, False, (1, 1)),
       ("noncond", 8, False, (0, 0)), ("noncond", 14, False, (1, 1))]
)
FIELDS = [f.name for f in dataclasses.fields(state.MemoryBank)
          if f.name != "attend_cond_tiles"]


def _banks(attend_cond_tiles=0):
    cfg, jcfg = tiny_test_config(**KW), jax_tiny_config(**KW)
    jbank = jstate.init_bank(jcfg, O, attend_cond_tiles=attend_cond_tiles,
                             banked_layers=L)
    tbank = state.init_bank(cfg, O, attend_cond_tiles=attend_cond_tiles,
                            banked_layers=L, device="cpu")
    s, cm, c = cfg.image_embedding_size ** 2, cfg.mem_dim, cfg.hidden_dim
    d = cfg.memory_attention.d_model
    rng = np.random.default_rng(0)
    for kind, t, pinned, valid in WRITES:
        mem = rng.standard_normal((O, s, cm)).astype(np.float32)
        ptr = rng.standard_normal((O, c)).astype(np.float32)
        mem_k = rng.standard_normal((O, L, s, d)).astype(np.float32)
        valid = np.asarray(valid, bool)
        if kind == "cond":
            jbank = jstate.write_cond(jbank, t, jnp.asarray(mem), jnp.asarray(ptr),
                                      jnp.asarray(valid), pinned=pinned,
                                      mem_k=jnp.asarray(mem_k))
            state.write_cond(tbank, t, torch.from_numpy(mem), torch.from_numpy(ptr),
                             torch.from_numpy(valid), pinned=pinned,
                             mem_k=torch.from_numpy(mem_k))
        else:
            jbank = jstate.write_noncond(jbank, t, jnp.asarray(mem), jnp.asarray(ptr),
                                         jnp.asarray(valid), mem_k=jnp.asarray(mem_k))
            state.write_noncond(tbank, t, torch.from_numpy(mem), torch.from_numpy(ptr),
                                torch.from_numpy(valid), mem_k=torch.from_numpy(mem_k))
    return cfg, jcfg, jbank, tbank


def test_writes_match_jax():
    _, _, jbank, tbank = _banks()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tbank, f).numpy(),
                                      np.asarray(getattr(jbank, f)), err_msg=f)
    # both banks overflowed: writing frame 18 evicted the unpinned cond frame
    # furthest from it (4; the pinned 0 is further still); the non-cond
    # writes evicted the frames furthest from each written frame
    assert sorted(tbank.cond_frame_idx.tolist()) == [0, 12, 18, 30]
    assert sorted(tbank.noncond_frame_idx.tolist()) == [6, 7, 8, 9, 10, 11, 12, 14]


@pytest.mark.parametrize("attend_cond_tiles", [0, 2])
@pytest.mark.parametrize("reverse", [False, True])
def test_select_memory_matches_jax(attend_cond_tiles, reverse):
    cfg, jcfg, jbank, tbank = _banks(attend_cond_tiles)
    for frame_idx, num_frames in ((15, 40), (9, 12), (3, 100)):
        for gather in (True, False):
            want = jstate.select_memory(jcfg, jbank, frame_idx, num_frames,
                                        reverse, gather_spatial=gather)
            got = state.select_memory(cfg, tbank, frame_idx, num_frames, reverse,
                                      gather_spatial=gather)
            assert got["layout"] == state.memory_layout(cfg, attend_cond_tiles)
            assert dataclasses.astuple(got["layout"]) == dataclasses.astuple(
                want["layout"])
            for k, v in want.items():
                if k == "layout" or v is None:
                    continue
                np.testing.assert_array_equal(
                    got[k].numpy(), np.asarray(v),
                    err_msg=f"{k} frame {frame_idx} reverse {reverse}")


def test_next_pow2_matches_jax():
    assert [state.next_pow2(n) for n in range(1, 70)] == [
        jstate.next_pow2(n) for n in range(1, 70)]
