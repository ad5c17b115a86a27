"""Static-shape inference state: the ring-buffer memory bank.

Counterpart of the JAX package's ``state.py``. The bank holds fixed-capacity
tensors and integer bookkeeping, so every step has the same shapes:

  * cond bank [Kc slots]: prompted (conditioning) frames; pinned slots are
    never evicted while an unpinned one exists;
  * non-cond bank [Kn slots]: tracked frames, eviction = temporally furthest;
  * object axis O: padded object slots.

Slot choice and memory selection are tensor arithmetic on the bank's device
(no host round trip). Unlike the JAX package, whose jitted steps donate the
bank and return a new one, the writers and bank operations here update the
bank's tensors IN PLACE (``index_copy_``, ``masked_fill_``) and return the
same object; only ``grow_objects``, which changes the object axis, returns a
new bank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from det_sam2_tpu_torch.configs import SAM2Config
from det_sam2_tpu_torch.utils.profiling import spanned

INVALID = -1
_FAR = 2 ** 30


@dataclasses.dataclass
class MemoryBank:
    """Per-video tracking memory. Leading axis = slots, second = objects."""

    cond_mem: torch.Tensor  # [Kc, O, S, Cm]
    cond_ptr: torch.Tensor  # [Kc, O, C]
    cond_frame_idx: torch.Tensor  # [Kc] int32 (-1 = empty)
    cond_pinned: torch.Tensor  # [Kc] bool
    cond_obj_valid: torch.Tensor  # [Kc, O] bool
    noncond_mem: torch.Tensor  # [Kn, O, S, Cm]
    noncond_ptr: torch.Tensor  # [Kn, O, C]
    noncond_frame_idx: torch.Tensor  # [Kn] int32
    noncond_obj_valid: torch.Tensor  # [Kn, O] bool
    # Banked-attention caches (None in gather mode). Unified slot space: cond
    # slot i -> row i, non-cond slot j -> row Kc + j, row Kc + Kn = the
    # per-frame obj-ptr staging tile. mem_k holds each memory-attention
    # layer's projected + roped keys of (mem + spatial_pos), written with
    # the memory; mem_v duplicates the raw memory values, so K2 reads K and
    # V straight from bank rows.
    mem_k: Optional[torch.Tensor] = None  # [Kc+Kn+1, O, L, S, D]
    mem_v: Optional[torch.Tensor] = None  # [Kc+Kn+1, O, S, Cm]
    # how many cond tiles the read path attends (0 = full capacity)
    attend_cond_tiles: int = 0

    @property
    def num_objects(self) -> int:
        return self.cond_mem.shape[1]


def resolve_device(device=None) -> torch.device:
    """`device`, or CUDA when it is None; raises rather than fall back to
    the CPU when there is no card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "det_sam2_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def init_bank(cfg: SAM2Config, num_objects: int, dtype=torch.float32,
              attend_cond_tiles: int = 0, banked_layers: int = 0,
              device=None) -> MemoryBank:
    """banked_layers > 0 also allocates the banked-attention caches for that
    many memory-attention layers; the engine takes the banked path whenever
    the bank carries them. device: None = CUDA (raises without a card)."""
    device = resolve_device(device)
    s = cfg.image_embedding_size ** 2
    kc, kn = cfg.cond_bank_size, cfg.noncond_bank_size
    o, cm, c = num_objects, cfg.mem_dim, cfg.hidden_dim

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    mem_k = mem_v = None
    if banked_layers > 0:
        mem_k = zeros(kc + kn + 1, o, banked_layers, s, cfg.memory_attention.d_model)
        mem_v = zeros(kc + kn + 1, o, s, cm)
    return MemoryBank(
        cond_mem=zeros(kc, o, s, cm),
        cond_ptr=zeros(kc, o, c),
        cond_frame_idx=torch.full((kc,), INVALID, dtype=torch.int32, device=device),
        cond_pinned=zeros(kc, dt=torch.bool),
        cond_obj_valid=zeros(kc, o, dt=torch.bool),
        noncond_mem=zeros(kn, o, s, cm),
        noncond_ptr=zeros(kn, o, c),
        noncond_frame_idx=torch.full((kn,), INVALID, dtype=torch.int32, device=device),
        noncond_obj_valid=zeros(kn, o, dt=torch.bool),
        mem_k=mem_k,
        mem_v=mem_v,
        attend_cond_tiles=attend_cond_tiles,
    )


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(n - 1, 0).bit_length()


def cond_tile_bucket(cfg: SAM2Config, live_cond: int) -> int:
    """Power-of-two bucket (capped at capacity) for the attended cond-tile
    count."""
    cap = min(cfg.cond_attn_size, cfg.cond_bank_size)
    return min(next_pow2(min(max(live_cond, 1), cap)), cap)


def grow_objects(bank: MemoryBank, new_num_objects: int) -> MemoryBank:
    """Pad the object axis (a new object mid-stream). Returns a NEW bank (the
    object axis changes shape); the new rows hold zeros / False."""
    o = bank.num_objects
    if new_num_objects <= o:
        return bank
    pad = new_num_objects - o

    def _pad(x):
        if x is None:
            return None
        # F.pad lists the last axis first: pad axis 1 at its end
        return torch.nn.functional.pad(x, [0, 0] * (x.ndim - 2) + [0, pad])

    return dataclasses.replace(
        bank,
        cond_mem=_pad(bank.cond_mem),
        cond_ptr=_pad(bank.cond_ptr),
        cond_obj_valid=_pad(bank.cond_obj_valid),
        noncond_mem=_pad(bank.noncond_mem),
        noncond_ptr=_pad(bank.noncond_ptr),
        noncond_obj_valid=_pad(bank.noncond_obj_valid),
        mem_k=_pad(bank.mem_k),
        mem_v=_pad(bank.mem_v),
    )


def _choose_write_slot(frame_idx_vec, pinned, frame_idx: int):
    """match > first empty > temporally-furthest unpinned (furthest pinned
    when every slot is pinned). Returns (slot [1] int64, had_match 0-d)."""
    match = frame_idx_vec == frame_idx
    empty = frame_idx_vec < 0
    dist = (frame_idx_vec - frame_idx).abs()
    any_unpinned = (~pinned).any()
    evict_key = torch.where(pinned & any_unpinned, -1, dist)
    had_match = match.any()
    slot = torch.where(
        had_match, match.int().argmax(),
        torch.where(empty.any(), empty.int().argmax(), evict_key.argmax()),
    )
    return slot.reshape(1), had_match


def _set_row(dst: torch.Tensor, slot: torch.Tensor, value) -> None:
    dst.index_copy_(0, slot, torch.as_tensor(value, device=dst.device)
                    .to(dst.dtype).reshape((1,) + dst.shape[1:]))


def _write_banked(bank: MemoryBank, row: torch.Tensor, mem, mem_k) -> None:
    """Mirror a slot write into the banked-attention caches."""
    if bank.mem_k is None:
        return
    if mem_k is None:
        raise ValueError(
            "bank carries banked-attention caches; writers must pass mem_k "
            "(model.project_memory_k of the written memory)"
        )
    _set_row(bank.mem_k, row, mem_k)
    _set_row(bank.mem_v, row, mem)


@spanned("bank.write")
def write_cond(bank: MemoryBank, frame_idx: int, mem: torch.Tensor,
               ptr: torch.Tensor, obj_valid: Optional[torch.Tensor] = None,
               pinned: bool = False,
               mem_k: Optional[torch.Tensor] = None) -> MemoryBank:
    """Write one cond slot in place, in the ``bank.write`` span. mem [O, S,
    Cm]; ptr [O, C]; mem_k [O, L, S, D] (banked mode only)."""
    if obj_valid is None:
        obj_valid = torch.ones(mem.shape[0], dtype=torch.bool, device=mem.device)
    slot, had_match = _choose_write_slot(bank.cond_frame_idx, bank.cond_pinned,
                                         frame_idx)
    keep_pin = had_match & bank.cond_pinned.index_select(0, slot)[0]
    _write_banked(bank, slot, mem, mem_k)
    _set_row(bank.cond_mem, slot, mem)
    _set_row(bank.cond_ptr, slot, ptr)
    _set_row(bank.cond_frame_idx, slot, frame_idx)
    _set_row(bank.cond_pinned, slot, keep_pin | pinned)
    _set_row(bank.cond_obj_valid, slot, obj_valid)
    return bank


@spanned("bank.write")
def write_noncond(bank: MemoryBank, frame_idx: int, mem: torch.Tensor,
                  ptr: torch.Tensor, obj_valid: Optional[torch.Tensor] = None,
                  mem_k: Optional[torch.Tensor] = None) -> MemoryBank:
    """Write one non-cond slot in place (eviction = temporally furthest), in
    the ``bank.write`` span."""
    if obj_valid is None:
        obj_valid = torch.ones(mem.shape[0], dtype=torch.bool, device=mem.device)
    slot, _ = _choose_write_slot(bank.noncond_frame_idx,
                                 torch.zeros_like(bank.noncond_frame_idx, dtype=torch.bool),
                                 frame_idx)
    _write_banked(bank, bank.cond_frame_idx.shape[0] + slot, mem, mem_k)
    _set_row(bank.noncond_mem, slot, mem)
    _set_row(bank.noncond_ptr, slot, ptr)
    _set_row(bank.noncond_frame_idx, slot, frame_idx)
    _set_row(bank.noncond_obj_valid, slot, obj_valid)
    return bank


def clear_object_rows(bank: MemoryBank, obj_idx: int) -> MemoryBank:
    """Invalidate every memory row of one object slot (remove_object), so a
    later object reusing the slot never attends the removed one's memories."""
    bank.cond_obj_valid[:, obj_idx] = False
    bank.noncond_obj_valid[:, obj_idx] = False
    return bank


def release_frames(bank: MemoryBank, min_keep_idx,
                   max_keep_idx=None) -> MemoryBank:
    """Invalidate unpinned slots with frame_idx < min_keep_idx (and, given
    max_keep_idx, > max_keep_idx): the fork's release_old_frames. Pinned
    (preload) cond slots survive."""

    def _drop(vec, pinned):
        drop = (vec >= 0) & (vec < min_keep_idx) & ~pinned
        if max_keep_idx is not None:
            drop |= (vec >= 0) & (vec > max_keep_idx) & ~pinned
        vec.masked_fill_(drop, INVALID)

    _drop(bank.cond_frame_idx, bank.cond_pinned)
    _drop(bank.noncond_frame_idx, torch.zeros_like(bank.noncond_frame_idx,
                                                   dtype=torch.bool))
    return bank


def invalidate_noncond(bank: MemoryBank, frame_idx) -> MemoryBank:
    """Drop a frame from the non-cond bank (a frame is never both cond and
    non-cond)."""
    bank.noncond_frame_idx.masked_fill_(bank.noncond_frame_idx == frame_idx,
                                        INVALID)
    return bank


def remove_cond_frame(bank: MemoryBank, frame_idx) -> MemoryBank:
    match = bank.cond_frame_idx == frame_idx
    bank.cond_frame_idx.masked_fill_(match, INVALID)
    bank.cond_pinned.masked_fill_(match, False)
    return bank


def demote_cond_frame(bank: MemoryBank, frame_idx: int) -> MemoryBank:
    """Move a frame's memory from the cond bank to the non-cond bank
    (clear_all_prompts_in_frame's demotion); a no-op when the frame is not
    a cond frame. One host read (whether it is), off the propagation path."""
    match = bank.cond_frame_idx == frame_idx
    if not bool(match.any()):
        return bank
    slot = match.int().argmax().reshape(1)
    # index_select copies: in banked mode the write below goes into the same
    # mem_k tensor the row is read from
    write_noncond(
        bank, frame_idx, bank.cond_mem.index_select(0, slot)[0],
        bank.cond_ptr.index_select(0, slot)[0],
        # carry per-object validity: all-valid would resurrect freed objects
        obj_valid=bank.cond_obj_valid.index_select(0, slot)[0],
        mem_k=None if bank.mem_k is None else bank.mem_k.index_select(0, slot)[0],
    )
    return remove_cond_frame(bank, frame_idx)


def clear_noncond_around(bank: MemoryBank, frame_idx: int,
                         radius: int) -> MemoryBank:
    """Drop non-cond memories within +-radius of a correction frame
    (_clear_non_cond_mem_around_input)."""
    vec = bank.noncond_frame_idx
    vec.masked_fill_((vec >= 0) & ((vec - frame_idx).abs() <= radius), INVALID)
    return bank


# ---------------------------------------------------------------------------
# memory selection (read path)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MemoryLayout:
    """Static description of the packed memory-token sequence."""

    num_cond_tiles: int
    num_noncond_tiles: int
    tokens_per_tile: int
    num_ptr_slots: int
    tokens_per_ptr: int

    @property
    def num_mem_frames(self) -> int:
        return self.num_cond_tiles + self.num_noncond_tiles

    @property
    def num_spatial_tokens(self) -> int:
        return self.num_mem_frames * self.tokens_per_tile

    @property
    def num_ptr_tokens(self) -> int:
        return self.num_ptr_slots * self.tokens_per_ptr

    @property
    def num_tokens(self) -> int:
        return self.num_spatial_tokens + self.num_ptr_tokens


def memory_layout(cfg: SAM2Config, attend_cond_tiles: int = 0) -> MemoryLayout:
    cap = min(cfg.cond_attn_size, cfg.cond_bank_size)
    ka = cap if attend_cond_tiles <= 0 else min(attend_cond_tiles, cap)
    return MemoryLayout(
        num_cond_tiles=ka,
        num_noncond_tiles=cfg.num_maskmem - 1,
        tokens_per_tile=cfg.image_embedding_size ** 2,
        num_ptr_slots=ka + cfg.max_obj_ptrs_in_encoder - 1,
        tokens_per_ptr=cfg.hidden_dim // cfg.mem_dim,
    )


def _desired_noncond_indices(cfg: SAM2Config, frame_idx: int,
                             reverse: bool) -> list:
    """Frame indices of the (num_maskmem - 1) non-cond memories at temporal
    stride r, earliest (t_pos = 1) first (SAM 2's memory selection)."""
    r = cfg.memory_temporal_stride_for_eval
    out = []
    for t_pos in range(1, cfg.num_maskmem):
        t_rel = cfg.num_maskmem - t_pos
        if t_rel == 1:
            idx = frame_idx + 1 if reverse else frame_idx - 1
        elif not reverse:
            idx = ((frame_idx - 2) // r) * r - (t_rel - 2) * r
        else:
            idx = -(-(frame_idx + 2) // r) * r + (t_rel - 2) * r
        out.append(idx)
    return out


def select_memory(cfg: SAM2Config, bank: MemoryBank, frame_idx: int,
                  num_frames: int, reverse: bool = False,
                  gather_spatial: bool = True) -> dict:
    """The packed memory for one tracked frame:

      spatial_mem   [O, (Ka+6)*S, Cm]  cond tiles then non-cond tiles
      spatial_tpos  [Ka+6] int64       index into maskmem_tpos_enc
      spatial_valid [O, Ka+6] bool
      ptrs          [O, P, C]          object pointers (cond + scan)
      ptr_dist      [P] int32          signed frame distance
      ptr_valid     [O, P] bool
      t_diff_max    0-d int32          tpos normaliser (min(F, 16) - 1)

    gather_spatial=False (banked path) skips the tile gather and returns
    ``slots`` [Ka+6] int32 (unified bank rows) instead of spatial_mem.
    """
    lay = memory_layout(cfg, bank.attend_cond_tiles)
    ka = lay.num_cond_tiles
    dev = bank.cond_frame_idx.device
    tpos_sign = -1 if reverse else 1
    kc = bank.cond_frame_idx.shape[0]

    # --- cond tiles: pinned first, then closest |dt| (stable ties) ---
    cfi = bank.cond_frame_idx
    valid = cfi >= 0
    score = torch.where(valid, (cfi - frame_idx).abs(), _FAR)
    score = torch.where(valid & bank.cond_pinned, -1, score)
    cond_slots = torch.sort(score, stable=True).indices[:ka]
    cond_valid = valid[cond_slots]
    cond_t = cfi[cond_slots]
    cond_obj_valid = bank.cond_obj_valid.index_select(0, cond_slots)  # [Ka, O]

    # --- non-cond tiles at t_pos 1..num_maskmem-1 ---
    desired = torch.tensor(_desired_noncond_indices(cfg, frame_idx, reverse),
                           dtype=torch.int32, device=dev)
    eq = bank.noncond_frame_idx[None, :] == desired[:, None]  # [6, Kn]
    found = eq.any(1) & (desired >= 0)
    nc_slots = eq.int().argmax(1)
    nc_obj_valid = bank.noncond_obj_valid.index_select(0, nc_slots)  # [6, O]

    spatial = None
    if gather_spatial:
        mem = torch.cat([bank.cond_mem.index_select(0, cond_slots),
                         bank.noncond_mem.index_select(0, nc_slots)], 0)
        o = mem.shape[1]
        spatial = mem.transpose(0, 1).reshape(o, -1, mem.shape[-1])

    nm = cfg.num_maskmem
    spatial_tpos = torch.cat([
        torch.full((ka,), nm - 1, dtype=torch.int64, device=dev),
        nm - torch.arange(1, nm, dtype=torch.int64, device=dev) - 1,
    ])
    spatial_valid = torch.cat([
        (cond_valid[:, None] & cond_obj_valid).T,
        (found[:, None] & nc_obj_valid).T,
    ], dim=1)

    # --- object pointers: the selected cond frames (past only at eval) ---
    cond_ptrs = bank.cond_ptr.index_select(0, cond_slots)  # [Ka, O, C]
    if cfg.only_obj_ptrs_in_the_past_for_eval:
        past_ok = (cond_t >= frame_idx) if reverse else (cond_t <= frame_idx)
    else:
        past_ok = torch.ones_like(cond_valid)
    cond_ptr_valid = (cond_valid & past_ok)[:, None] & cond_obj_valid
    if cfg.use_signed_tpos_enc_to_obj_ptrs:
        cond_ptr_dist = (frame_idx - cond_t) * tpos_sign
    else:
        cond_ptr_dist = (frame_idx - cond_t).abs()

    # scan part: t_diff = 1 .. max_obj_ptrs-1; a non-cond entry wins, else an
    # UNSELECTED cond frame at the same index
    max_ptrs = min(num_frames, cfg.max_obj_ptrs_in_encoder)
    t_diffs = torch.arange(1, cfg.max_obj_ptrs_in_encoder, dtype=torch.int32,
                           device=dev)
    scan_t = frame_idx + t_diffs if reverse else frame_idx - t_diffs
    in_range = (scan_t >= 0) & (scan_t < num_frames) & (t_diffs < max_ptrs)
    eqp = bank.noncond_frame_idx[None, :] == scan_t[:, None]
    nc_found = eqp.any(1)
    scan_slots = eqp.int().argmax(1)
    scan_ptrs = bank.noncond_ptr.index_select(0, scan_slots)  # [15, O, C]
    scan_obj_valid = bank.noncond_obj_valid.index_select(0, scan_slots)

    selected = ((cond_slots[:, None] == torch.arange(kc, device=dev)[None, :])
                & cond_valid[:, None]).any(0)
    eqc = (cfi[None, :] == scan_t[:, None]) & (valid & ~selected)[None, :]
    c_found = eqc.any(1)
    c_slots = eqc.int().argmax(1)
    c_ptrs = bank.cond_ptr.index_select(0, c_slots)
    c_obj_valid = bank.cond_obj_valid.index_select(0, c_slots)

    scan_ptrs = torch.where(nc_found[:, None, None], scan_ptrs, c_ptrs)
    scan_obj_valid = torch.where(nc_found[:, None], scan_obj_valid, c_obj_valid)
    scan_found = (nc_found | c_found) & in_range

    ptrs = torch.cat([cond_ptrs, scan_ptrs], 0).transpose(0, 1)
    ptr_dist = torch.cat([cond_ptr_dist.int(), t_diffs])
    ptr_valid = torch.cat([cond_ptr_valid, scan_found[:, None] & scan_obj_valid],
                          0).T  # [O, P]
    if not cfg.use_obj_ptrs_in_encoder:
        ptr_valid = torch.zeros_like(ptr_valid)

    out = {
        "spatial_mem": spatial,
        "spatial_tpos": spatial_tpos,
        "spatial_valid": spatial_valid,
        "ptrs": ptrs,
        "ptr_dist": ptr_dist,
        "ptr_valid": ptr_valid,
        "t_diff_max": torch.tensor(max_ptrs - 1, dtype=torch.int32, device=dev),
        "layout": lay,
    }
    if not gather_spatial:
        out["slots"] = torch.cat([cond_slots, kc + nc_slots]).int()
    return out
