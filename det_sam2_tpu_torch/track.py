"""SAM2Engine: the per-frame streaming step functions.

Counterpart of the JAX package's ``track.py`` (``SAM2Engine``), eager
PyTorch: each public method runs the model on the engine's device and
updates the caller's MemoryBank in place (see ``state.py``). Signatures and
output dict keys are the JAX engine's. Inputs may be numpy arrays or
tensors; outputs are tensors on the engine's device. ``propagate_window``,
the JAX engine's window ``lax.scan``, is a loop over stream_step's
per-frame code.

Attention routing on the main path: Hiera global blocks and memory
self-attention go to K1 (``ops.attention.flash_attention``); memory
cross-attention goes to K1 with a bias (gather mode) or to K2
(``flash_attention_banked``, banked mode, the default on CUDA).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from det_sam2_tpu_torch import convert
from det_sam2_tpu_torch.configs import SAM2Config
from det_sam2_tpu_torch.modeling.layers import LayerNorm
from det_sam2_tpu_torch.modeling.sam2_base import SAM2Model, resize_bilinear
from det_sam2_tpu_torch.ops import attention
from det_sam2_tpu_torch.ops.connected_components import fill_holes_in_mask_scores
from det_sam2_tpu_torch.state import (
    MemoryBank,
    memory_layout,
    resolve_device,
    select_memory,
    write_cond,
    write_noncond,
)
from det_sam2_tpu_torch.utils.profiling import span, spanned


def _maybe_fill_holes(cfg: SAM2Config, low_res: torch.Tensor) -> torch.Tensor:
    """fill_holes_in_mask_scores on the low-res logits (fill_hole_area), in
    the ``engine.fill`` span."""
    if cfg.fill_hole_area > 0:
        with span("engine.fill"):
            return fill_holes_in_mask_scores(low_res, float(cfg.fill_hole_area))
    return low_res


def use_multimask(cfg: SAM2Config, is_init: bool, num_pts: int) -> bool:
    """SAM 2's _use_multimask."""
    return (
        cfg.multimask_output_in_sam
        and (is_init or cfg.multimask_output_for_tracking)
        and (cfg.multimask_min_pt_num <= num_pts <= cfg.multimask_max_pt_num)
    )


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """uint8 frames pass through raw (the patch embed normalises them);
    float inputs are taken as already normalised."""
    if img.dtype == torch.uint8:
        return img
    return img.float()


def _fill_stacked(cfg: SAM2Config, low: torch.Tensor) -> torch.Tensor:
    """Hole filling over a window's stacked fp16 mask logits [T, O, 1, s4,
    s4], in fp32, a chunk of frames at a time (the chunk bounds the stencil's
    working set), returned in fp16: the JAX window's order of rounding (fp16
    first, then the fill). Skip-step rows are all-zero planes, one background
    component larger than fill_hole_area, so the fill leaves them alone. One
    ``engine.fill`` span."""
    if cfg.fill_hole_area <= 0 or low.shape[0] == 0:
        return low
    chunk = max(1, 8 // max(low.shape[1], 1))
    with span("engine.fill"):
        return torch.cat([fill_holes_in_mask_scores(c.float(), float(cfg.fill_hole_area)).half()
                          for c in low.split(chunk)])


def _c_strides(shape) -> tuple:
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= n
    return tuple(reversed(strides))


def _broadcast_feats(feats, o: int):
    return tuple(
        f.expand((o,) + tuple(f.shape[1:])) if f.shape[0] == 1 else f
        for f in feats
    )


def _assemble_memory(model: SAM2Model, cfg: SAM2Config, sel):
    """Pack gathered bank slots into the attention token sequence: spatial
    tiles then object-pointer tokens, with positions and validity."""
    lay = sel["layout"]
    s = lay.tokens_per_tile
    cm = cfg.mem_dim
    base = model.sine_pe(cfg.image_embedding_size, cm, sel["ptrs"].device)
    tpos = model.maskmem_tpos_enc[sel["spatial_tpos"], 0, 0].float()  # [T, Cm]
    spatial_pos = (base[None] + tpos[:, None]).reshape(1, -1, cm)
    ptrs = sel["ptrs"]  # [O, P, C]
    o, p, c = ptrs.shape
    tpp = c // cm
    ptr_tokens = ptrs.reshape(o, p * tpp, cm)
    ptr_pe = model.obj_ptr_tpos(sel["ptr_dist"].float(), sel["t_diff_max"])
    ptr_pos = ptr_pe.repeat_interleave(tpp, 0)[None]
    memory = torch.cat([sel["spatial_mem"],
                        ptr_tokens.to(sel["spatial_mem"].dtype)], 1)
    memory_pos = torch.cat([spatial_pos, ptr_pos.to(spatial_pos.dtype)], 1)
    valid = torch.cat([sel["spatial_valid"].repeat_interleave(s, 1),
                       sel["ptr_valid"].repeat_interleave(tpp, 1)], 1)
    return memory, memory_pos, valid, lay


def _conditioned_features(model, cfg, feat_o, bank, frame_idx, num_frames,
                          reverse: bool, is_init: bool):
    """Memory-condition the current frame's features: the memory's
    selection and assembly in the ``bank.select`` span, memory attention in
    ``engine.memattn``."""
    if is_init or cfg.num_maskmem == 0:
        if cfg.directly_add_no_mem_embed:
            return model.no_mem_features(feat_o)
        raise NotImplementedError("SAM 2.1 always sets directly_add_no_mem_embed")
    if bank.mem_k is not None:
        with span("bank.select"):
            memory = _banked_memory(model, cfg, bank, frame_idx, num_frames, reverse)
        with span("engine.memattn"):
            return model.attend_memory_banked(feat_o, bank.mem_k, bank.mem_v, *memory)
    with span("bank.select"):
        sel = select_memory(cfg, bank, frame_idx, num_frames, reverse)
        memory, memory_pos, valid, lay = _assemble_memory(model, cfg, sel)
    with span("engine.memattn"):
        return model.attend_memory(feat_o, memory, memory_pos, valid,
                                   num_mem_frames=lay.num_mem_frames,
                                   num_obj_ptr_tokens=lay.num_ptr_tokens)


def _banked_memory(model, cfg, bank, frame_idx, num_frames, reverse: bool):
    """Bank-indirect conditioning's memory: no tile gathers and no per-frame
    K projection; K2 reads the cached K (mem_k) and raw V (mem_v) from the
    selected bank rows. Only the obj-ptr tokens (written in place into the
    staging row), the validity mask and the tpos vectors are built here.
    Returns K2's (slots, tpos_vecs, mask)."""
    sel = select_memory(cfg, bank, frame_idx, num_frames, reverse,
                        gather_spatial=False)
    lay = sel["layout"]
    s = lay.tokens_per_tile
    cm = cfg.mem_dim
    ptrs = sel["ptrs"]
    o, p, c = ptrs.shape
    tpp = c // cm
    n_ptr = p * tpp
    if n_ptr > s:
        raise ValueError(f"{n_ptr} obj-ptr tokens do not fit the {s}-token "
                         "staging tile; use the gather path (banked_layers=0)")
    ptr_tokens = ptrs.reshape(o, n_ptr, cm).to(bank.mem_v.dtype)
    ptr_pe = model.obj_ptr_tpos(sel["ptr_dist"].float(), sel["t_diff_max"])
    ptr_pos = ptr_pe.repeat_interleave(tpp, 0)[None]
    stage_k = model.project_memory_k(ptr_tokens + ptr_pos.to(ptr_tokens.dtype),
                                     spatial=False)  # [O, L, n_ptr, D]
    stage_row = bank.mem_k.shape[0] - 1
    bank.mem_k[stage_row, :, :, :n_ptr] = stage_k.to(bank.mem_k.dtype)
    bank.mem_v[stage_row, :, :n_ptr] = ptr_tokens
    dev = ptrs.device
    slots = torch.cat([sel["slots"],
                       torch.full((1,), stage_row, dtype=torch.int32, device=dev)])
    tpos = model.maskmem_tpos_enc[sel["spatial_tpos"], 0, 0]  # [T, Cm]
    tpos_vecs = torch.cat([tpos, tpos.new_zeros(1, cm)])
    valid_sp = sel["spatial_valid"].repeat_interleave(s, 1)  # [O, T*S]
    valid_stage = torch.nn.functional.pad(
        sel["ptr_valid"].repeat_interleave(tpp, 1), (0, s - n_ptr))
    mask = torch.cat([valid_sp, valid_stage], 1)
    return slots, tpos_vecs, mask


def _memk(model, bank, smem):
    """K cache of a bank write (None in gather mode)."""
    return model.project_memory_k(smem) if bank.mem_k is not None else None


class SAM2Engine:
    """Holds the model and the step functions. All tracking state lives in
    the MemoryBank owned by the caller."""

    def __init__(self, cfg: SAM2Config, params: Optional[dict] = None,
                 dtype: torch.dtype = torch.float32, device=None, seed: int = 0,
                 plain_kernels: bool = False, banked: Optional[bool] = None):
        """params: a state dict in the SAM 2.1 layout (e.g.
        ``convert.from_jax_params``), or None for the seeded random init.
        device: None = CUDA (raises without a card). plain_kernels=True
        computes every kernel's plain PyTorch version instead of launching
        it: the reference run of a session. banked: the banks this engine
        makes (``banked_layers``) carry the banked-attention caches; None =
        on CUDA only (the JAX package's DET_SAM2_BANKED_ATTN=0|1 as an
        argument)."""
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.banked = banked
        if plain_kernels:
            attn_fn, banked_fn = attention.plain_attention_fns()
        else:
            attn_fn, banked_fn = attention.flash_attention, attention.flash_attention_banked
        model = SAM2Model(cfg, attention_fn=attn_fn, banked_attention_fn=banked_fn,
                          dtype=dtype)
        if params is None:
            params = convert.init_params(model, seed)
        model.load_state_dict(params, strict=True)
        model = model.to(device=self.device, dtype=dtype).eval()
        # LayerNorm computes in fp32; keep its parameters fp32 as well, and
        # plain with the other kernels
        for m in model.modules():
            if isinstance(m, LayerNorm):
                m.float()
                m.plain = plain_kernels
        self.model = model
        if self.device.type == "cuda":
            # torch's cuDNN attention backend, its first pick for Hiera's
            # windowed attention on an H100, rounds by the calling thread's
            # cuDNN handle: a session served on the server's handler threads
            # would differ from the same session on another thread. The
            # flash and efficient backends do not. The switch is process-wide.
            torch.backends.cuda.enable_cudnn_sdp(False)

    @property
    def banked_layers(self) -> int:
        """Memory-attention layer count for the banked-attention caches
        (``state.init_bank(banked_layers=)``), or 0 for the gather path. On
        by default on CUDA when the worst-case obj-ptr token count fits one
        staging tile; ``banked=True`` asks for it on any device and raises
        when the tokens do not fit."""
        lay = memory_layout(self.cfg)  # full-capacity cond tiles
        fits = lay.num_ptr_tokens <= lay.tokens_per_tile
        if self.banked and not fits:
            raise ValueError("banked attention needs the obj-ptr tokens to fit one tile")
        on = self.device.type == "cuda" if self.banked is None else self.banked
        return self.cfg.memory_attention.num_layers if on and fits else 0

    def _t(self, x, dtype=None) -> torch.Tensor:
        t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        return t.to(device=self.device, dtype=dtype)

    def _obj_valid(self, obj_valid, o: int) -> torch.Tensor:
        if obj_valid is None:
            return torch.ones(o, dtype=torch.bool, device=self.device)
        return self._t(obj_valid, torch.bool)

    # ------------------------------------------------------------------

    @torch.no_grad()
    @spanned("engine.encode")
    def encode_image(self, img):
        """img [B, H, W, 3] (uint8 raw or normalised float) -> (feat_s0,
        feat_s1, feat), NHWC, in the ``engine.encode`` span. The frames are
        copied to C-order strides first when they have others (a numpy view
        can carry any stride on a size-1 axis): the trunk's first
        convolution picks its algorithm, and so its rounding, by the
        input's strides."""
        img = self._t(img)
        if img.stride() != _c_strides(img.shape):
            img = img.clone(memory_format=torch.contiguous_format)
        return self.model.forward_image(normalize_image(img))

    def _track(self, feats, bank, frame_idx, num_frames, reverse, obj_valid,
               fill: bool = True):
        """Memory read -> SAM heads -> memory write (in place) -> outputs
        (pred_masks hole-filled unless fill=False). feats have a batch of 1
        (broadcast over the objects) or one row an object. Spans: the
        memory's (``_conditioned_features``), ``engine.heads``,
        ``engine.memenc`` (the memory encoder and the write's K cache),
        ``bank.write`` and ``engine.fill``."""
        cfg, m = self.cfg, self.model
        o = bank.num_objects
        s0, s1, feat = _broadcast_feats(feats, o)
        pix = _conditioned_features(m, cfg, feat, bank, frame_idx, num_frames,
                                    reverse, is_init=False)
        multimask = use_multimask(cfg, is_init=False, num_pts=0)
        with span("engine.heads"):
            (_, _, ious, low_res, high_res, obj_ptr, obj_logits) = m.forward_sam_heads(
                pix, high_res_features=[s0, s1], multimask_output=multimask)
        with span("engine.memenc"):
            maskmem = m.encode_memory(feat, high_res, obj_logits, binarize=False,
                                      apply_non_overlap=cfg.non_overlap_masks_for_mem_enc)
            smem = maskmem.reshape(o, -1, cfg.mem_dim)
            memk = _memk(m, bank, smem)
        write_noncond(bank, frame_idx, smem, obj_ptr,
                      obj_valid=self._obj_valid(obj_valid, o), mem_k=memk)
        return bank, {
            "pred_masks": _maybe_fill_holes(cfg, low_res) if fill else low_res,
            "obj_ptr": obj_ptr,
            "object_score_logits": obj_logits,
            "ious": ious,
        }

    @torch.no_grad()
    def track_step(self, feats, bank: MemoryBank, frame_idx: int,
                   num_frames: int, reverse: bool = False, obj_valid=None):
        """Track one unprompted frame from its features. Returns (bank,
        outputs); the bank is updated in place."""
        return self._track(feats, bank, int(frame_idx), int(num_frames),
                           bool(reverse), obj_valid)

    @torch.no_grad()
    def stream_step(self, img, bank: MemoryBank, frame_idx: int,
                    num_frames: int, reverse: bool = False, obj_valid=None):
        """img [1, H, W, 3] -> (bank, outputs): image encode + track +
        memory write, the streaming hot path."""
        return self._track(self.encode_image(img), bank, int(frame_idx),
                           int(num_frames), bool(reverse), obj_valid)

    @torch.no_grad()
    def prompt_step(self, feats, bank: MemoryBank, frame_idx: int,
                    num_frames: int, points, labels, is_init: bool,
                    reverse: bool = False, prev_logits=None):
        """SAM heads with point / box prompts (no memory write: the caller
        encodes with encode_cond_memory). points [O, P, 2] in model pixels;
        labels [O, P]; prev_logits [O, 1, s4, s4] or None."""
        cfg, m = self.cfg, self.model
        points = self._t(points, torch.float32)
        labels = self._t(labels, torch.int64)
        o = points.shape[0]
        s0, s1, feat = _broadcast_feats(feats, o)
        pix = _conditioned_features(m, cfg, feat, bank, int(frame_idx),
                                    int(num_frames), bool(reverse), bool(is_init))
        mask_inputs = None
        if prev_logits is not None:
            # previous low-res logits as a dense prompt, clamped to +-32
            mask_inputs = self._t(prev_logits, torch.float32).clamp(-32.0, 32.0)
            mask_inputs = mask_inputs[:, 0, :, :, None]
        multimask = use_multimask(cfg, bool(is_init), points.shape[1])
        (_, _, ious, low_res, _, obj_ptr, obj_logits) = m.forward_sam_heads(
            pix, point_coords=points, point_labels=labels, mask_inputs=mask_inputs,
            high_res_features=[s0, s1], multimask_output=multimask)
        return {
            "pred_masks": _maybe_fill_holes(cfg, low_res),
            "obj_ptr": obj_ptr,
            "object_score_logits": obj_logits,
            "ious": ious,
        }

    @torch.no_grad()
    def predict_step(self, feats, points, labels, mask_input=None,
                     multimask: bool = True) -> dict:
        """Memory-less SAM prediction on one image's features (the image
        predictor and the AMG): points [B, P, 2] in model pixels, labels
        [B, P], mask_input [B, 1, s4, s4] logits or None. The heads run
        without the no-object gate on the masks. Returns multimasks [B, M,
        s4, s4] and low_res_masks [B, 1, s4, s4] fp32 logits, ious [B, M],
        object_score_logits [B, 1]."""
        m = self.model
        points = self._t(points, torch.float32)
        labels = self._t(labels, torch.int64)
        s0, s1, feat = _broadcast_feats(feats, points.shape[0])
        if mask_input is not None:
            mask_input = self._t(mask_input, torch.float32)[:, 0, :, :, None]
        (multimasks, _, ious, low_res, _, _, obj_logits) = m.forward_sam_heads(
            m.no_mem_features(feat), point_coords=points, point_labels=labels,
            mask_inputs=mask_input, high_res_features=[s0, s1],
            multimask_output=bool(multimask), gate_no_obj=False)
        return {"multimasks": multimasks, "ious": ious, "low_res_masks": low_res,
                "object_score_logits": obj_logits}

    def _encode(self, feats, bank, frame_idx, low_res_masks, obj_logits,
                obj_ptr, is_mask_from_pts, obj_valid, to_cond, pinned=False):
        cfg, m = self.cfg, self.model
        low_res_masks = self._t(low_res_masks, torch.float32)
        o = low_res_masks.shape[0]
        _, _, feat = _broadcast_feats(feats, o)
        with span("engine.memenc"):
            high_res = resize_bilinear(low_res_masks, (cfg.image_size, cfg.image_size))
            binarize = cfg.binarize_mask_from_pts_for_mem_enc and is_mask_from_pts
            maskmem = m.encode_memory(feat, high_res, self._t(obj_logits, torch.float32),
                                      binarize=binarize,
                                      apply_non_overlap=cfg.non_overlap_masks_for_mem_enc)
            smem = maskmem.reshape(o, -1, cfg.mem_dim)
            memk = _memk(m, bank, smem)
        obj_ptr = self._t(obj_ptr)
        valid = self._obj_valid(obj_valid, o)
        if to_cond:
            return write_cond(bank, int(frame_idx), smem, obj_ptr, obj_valid=valid,
                              pinned=pinned, mem_k=memk)
        return write_noncond(bank, int(frame_idx), smem, obj_ptr, obj_valid=valid,
                             mem_k=memk)

    @torch.no_grad()
    def encode_cond_memory(self, feats, bank: MemoryBank, frame_idx: int,
                           low_res_masks, object_score_logits, obj_ptr,
                           is_mask_from_pts: bool = True, pinned: bool = False,
                           obj_valid=None) -> MemoryBank:
        """Encode a consolidated prompted frame and write it to the cond
        bank (in place)."""
        return self._encode(feats, bank, frame_idx, low_res_masks,
                            object_score_logits, obj_ptr, bool(is_mask_from_pts),
                            obj_valid, to_cond=True, pinned=bool(pinned))

    @torch.no_grad()
    def encode_noncond_memory(self, feats, bank: MemoryBank, frame_idx: int,
                              low_res_masks, object_score_logits, obj_ptr,
                              is_mask_from_pts: bool = True,
                              obj_valid=None) -> MemoryBank:
        """Encode a consolidated frame into the NON-cond bank (in place)."""
        return self._encode(feats, bank, frame_idx, low_res_masks,
                            object_score_logits, obj_ptr, bool(is_mask_from_pts),
                            obj_valid, to_cond=False)

    @torch.no_grad()
    def mask_prompt_step(self, feats, bank: Optional[MemoryBank], frame_idx: int,
                         num_frames: int, mask_inputs, is_init: bool,
                         reverse: bool = False) -> dict:
        """SAM outputs for a mask prompt; no memory is written. mask_inputs
        [O, H, W, 1] binary float at model resolution. With
        cfg.use_mask_input_as_output_without_sam the mask itself is the
        output (no memory read: the bank may be None, as it may when
        is_init); otherwise it is the SAM heads' dense prompt on the
        memory-conditioned features."""
        cfg, m = self.cfg, self.model
        mask_inputs = self._t(mask_inputs, torch.float32)
        s0, s1, feat = _broadcast_feats(feats, mask_inputs.shape[0])
        if cfg.use_mask_input_as_output_without_sam:
            outs = m.use_mask_as_output(feat, [s0, s1], mask_inputs)
        else:
            pix = _conditioned_features(m, cfg, feat, bank, int(frame_idx),
                                        int(num_frames), bool(reverse), bool(is_init))
            outs = m.forward_sam_heads(
                pix, mask_inputs=mask_inputs, high_res_features=[s0, s1],
                multimask_output=use_multimask(cfg, bool(is_init), 0))
        (_, _, ious, low_res, _, obj_ptr, obj_logits) = outs
        return {
            "pred_masks": _maybe_fill_holes(cfg, low_res),
            "obj_ptr": obj_ptr,
            "object_score_logits": obj_logits,
            "ious": ious,
        }

    @torch.no_grad()
    def attach_bank_caches(self, bank: MemoryBank) -> MemoryBank:
        """The bank with its banked-attention caches (mem_k / mem_v) rebuilt
        from the stored memories on the engine's device, or with none when
        the engine runs the gather path. Used after a bank is loaded:
        save_session strips the caches, which are derived state. Returns a
        new bank sharing the memory tensors."""
        nl = self.banked_layers
        if nl == 0:
            return dataclasses.replace(bank, mem_k=None, mem_v=None)
        mems = torch.cat([bank.cond_mem, bank.noncond_mem])  # [K, O, S, Cm]
        k, o, s, cm = mems.shape
        mk = self.model.project_memory_k(mems.reshape(k * o, s, cm))
        mk = mk.reshape(k, o, nl, s, -1).to(mems.dtype)
        # + the per-frame obj-ptr staging row
        return dataclasses.replace(
            bank, mem_k=torch.cat([mk, mk.new_zeros((1,) + mk.shape[1:])]),
            mem_v=torch.cat([mems, mems.new_zeros((1,) + mems.shape[1:])]))

    @torch.no_grad()
    def propagate_window(self, images, bank: MemoryBank, frame_indices, skips,
                         num_frames: int, reverse: bool = False, obj_valid=None,
                         img_idx=None):
        """Track a window of frames: for each step, the same per-frame code
        as stream_step (encode + track + memory write into the bank, in
        place), except that the mask logits are kept in fp16 and hole-filled
        once over the whole window (``_fill_stacked``).

        images: the frames to RUN (an [N, H, W, 3] uint8 tensor or array, or
        a sequence of [H, W, 3] frames); frame_indices, skips [T] (host
        values); img_idx [T] maps each step to its row of images (None =
        identity). A skip step does no inference, writes nothing and returns
        zero rows. Returns (bank, (pred_masks [T, O, 1, s4, s4] fp16, obj_ptr
        [T, O, C] fp32, object_score_logits [T, O, 1] fp32)), on the engine's
        device: nothing is read back to the host. The window is
        propagate_window_batched's with one video."""
        one = ([f[None] for f in images] if isinstance(images, (list, tuple))
               else images[:, None])
        return self.propagate_window_batched(
            one, bank, frame_indices, np.asarray(skips, bool)[:, None], num_frames,
            (bank.num_objects,), reverse=reverse, obj_valid=obj_valid,
            img_idx=img_idx)

    @torch.no_grad()
    @spanned("engine.window")
    def propagate_window_batched(self, images, bank: MemoryBank, frame_indices,
                                 skips, num_frames: int, counts,
                                 reverse: bool = False, obj_valid=None,
                                 img_idx=None):
        """Track B videos in lockstep through one window (the JAX engine's
        ``_batched_window_fn`` body as a loop).

        The bank's object axis is every video's objects concatenated: video
        v owns rows sum(counts[:v]) .. + counts[v] (bank.num_objects ==
        sum(counts)). Each step encodes the B frames in one encode_image
        call, gives each object row its video's features and runs
        stream_step's per-frame body (``_track``) on the merged bank. The
        memory encoder's non-overlap constraint couples objects, so it is
        refused across videos and is the config's with one video.

        images: the steps to RUN, [N, B, H, W, 3] uint8 (a tensor, an array
        or a sequence of [B, H, W, 3]); frame_indices [T] the shared frame
        clock; skips [T, B] per (step, video), host values; img_idx [T] maps
        each step to its row of images (None = identity). A step where only
        some videos skip still runs every row, writes the non-cond slot for
        the rows of the others (obj_valid & ~skip) and returns zero rows for
        the skipped videos; a step where every video skips encodes nothing,
        writes nothing and returns zero rows. Returns (bank, (pred_masks [T,
        O_total, 1, s4, s4] fp16, obj_ptr [T, O_total, C] fp32,
        object_score_logits [T, O_total, 1] fp32)) on the engine's device,
        the fp16 logits hole-filled once over the window (``_fill_stacked``).
        The call is the ``engine.window`` span, a step of its own when no
        span is around it.

        Capacity: a partly skipped step still takes a non-cond slot, so a
        skipped video holds more slots than its own session would; once the
        bank is full, eviction could drop a memory its own session keeps.
        Exactness needs noncond_bank_size >= the strided read span
        ((num_maskmem - 1) * stride) + the most skips of one video in the
        window; a window that breaks it raises."""
        cfg, dev = self.cfg, self.device
        counts = tuple(int(c) for c in counts)
        b, o_total = len(counts), sum(counts)
        if bank.num_objects != o_total:
            raise ValueError(
                f"bank has {bank.num_objects} object rows, counts "
                f"{counts} sum to {o_total}"
            )
        if cfg.non_overlap_masks_for_mem_enc and b > 1:
            raise NotImplementedError(
                "non_overlap_masks_for_mem_enc couples objects across "
                "videos; batched windows require it off (it is off in "
                "every reference config)"
            )
        frame_indices = np.asarray(frame_indices).tolist()
        t = len(frame_indices)
        skips = np.asarray(skips, bool).reshape(t, b)
        if skips.size and b > 1:
            span = (cfg.num_maskmem - 1) * max(1, cfg.memory_temporal_stride_for_eval)
            max_skips = int(skips.sum(axis=0).max())
            if max_skips and cfg.noncond_bank_size < span + max_skips:
                raise ValueError(
                    f"noncond_bank_size={cfg.noncond_bank_size} cannot "
                    f"guarantee single-session-exact eviction for a video "
                    f"with {max_skips} skipped steps this window (needs >= "
                    f"read span {span} + {max_skips}); enlarge the bank or "
                    f"shorten the window"
                )
        img_idx = list(range(t)) if img_idx is None else np.asarray(img_idx).tolist()
        s4 = cfg.image_size // 4
        video_of_obj = np.repeat(np.arange(b), counts)
        skip_o = skips[:, video_of_obj]  # [T, O_total]
        # uploaded once a window: each object row's video, the rows each step
        # writes, the rows each step zeroes
        rows = torch.as_tensor(video_of_obj, device=dev)
        valid = self._obj_valid(obj_valid, o_total)
        skip_dev = torch.as_tensor(skip_o, device=dev)
        write_valid = valid[None] & ~skip_dev
        low = torch.zeros((t, o_total, 1, s4, s4), dtype=torch.float16, device=dev)
        ptr = torch.zeros((t, o_total, cfg.hidden_dim), dtype=torch.float32, device=dev)
        logits = torch.zeros((t, o_total, 1), dtype=torch.float32, device=dev)
        for i in range(t):
            if skips[i].all():
                continue
            feats = self.encode_image(images[img_idx[i]])
            if b > 1:  # one video's features stay a batch of 1 (broadcast)
                feats = tuple(f.index_select(0, rows) for f in feats)
            _, out = self._track(feats, bank, frame_indices[i], int(num_frames),
                                 bool(reverse), write_valid[i], fill=False)
            if skip_o[i].any():
                sk = skip_dev[i]
                low[i] = torch.where(sk[:, None, None, None], 0.0, out["pred_masks"])
                ptr[i] = torch.where(sk[:, None], 0.0, out["obj_ptr"].float())
                logits[i] = torch.where(sk[:, None], 0.0,
                                        out["object_score_logits"].float())
            else:
                low[i] = out["pred_masks"]  # rounded to fp16 before the fill
                ptr[i] = out["obj_ptr"]
                logits[i] = out["object_score_logits"]
        return bank, (_fill_stacked(cfg, low), ptr, logits)

    @torch.no_grad()
    def resize_masks(self, masks, out_hw) -> torch.Tensor:
        """Low-res logits [..., h, w] -> [..., H, W] on the engine's device:
        bilinear, align_corners=False (SAM 2's video-resolution output)."""
        return resize_bilinear(self._t(masks), (int(out_hw[0]), int(out_hw[1])))

    def empty_mask_ptr(self, feats, frame_idx: int = 0) -> torch.Tensor:
        """The object pointer [1, C] of an empty mask on this frame's
        features: the placeholder pointer of an object with no output on a
        consolidated frame."""
        s = self.cfg.image_size
        zeros = torch.zeros((1, s, s, 1), dtype=torch.float32, device=self.device)
        out = self.mask_prompt_step(tuple(f[:1] for f in feats), None, frame_idx,
                                    1, zeros, is_init=True)
        return out["obj_ptr"]
