"""Operations and bytes from shapes: the kernels' rooflines and the step's
model FLOPs, against the H100's published peaks.

The peaks and the bound arithmetic are those of the repository's card check
(``chip_smoke.py``: ``PEAK_FLOPS``, ``PEAK_BYTES``, ``bound_ms`` and the K1 /
K2 rows): NVIDIA's data sheet for the H100 SXM, dense, at its 700 W limit.
A launch's bound is the larger of its FLOPs over the bf16 tensor-core peak
and its bytes over the memory rate; each input byte is counted once, each
output byte once, and attention over live keys only.
"""

from __future__ import annotations

from typing import List, Tuple

PEAK_BF16 = 989e12  # FLOP/s, bf16 tensor cores, dense
PEAK_BYTES = 3.35e12  # B/s, HBM3
BF16 = 2  # bytes an element
F32 = 4


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """The least seconds the card could take: max(FLOPs / peak, bytes /
    memory rate)."""
    return max(flops / peak, nbytes / PEAK_BYTES)


# ---------------------------------------------------------------------------
# K1: csrc/flash_fwd.cu
# ---------------------------------------------------------------------------


def k1_launch(bh: int, nq: int, nk: int, d: int, dv: int, elt: int = BF16):
    """(FLOPs, bytes) of one K1 launch without a bias: QK^T and PV over every
    key, q / k / v read and the output and its fp32 logsumexp written once."""
    flops = 2.0 * bh * nq * nk * (d + dv)
    nbytes = elt * bh * (nq * d + nk * d + nk * dv + nq * dv) + F32 * bh * nq
    return flops, nbytes


def hiera_blocks(h, image_size: int) -> List[dict]:
    """Hiera's blocks as the trunk builds them: per block its input grid,
    widths, heads, window (0 = global) and whether it pools its queries."""
    q_pool = set(h.q_pool_blocks)
    globals_ = set(h.global_att_blocks or ())
    dim, heads, stage = h.embed_dim, h.num_heads, 1
    side = image_size // h.patch_stride
    out = []
    for i in range(h.depth):
        dim_out = dim
        window = h.window_spec[stage - 1]
        if i in globals_:
            window = 0
        if i - 1 in h.stage_ends:
            dim_out = int(dim * h.dim_mul)
            heads = int(heads * h.head_mul)
            stage += 1
        pool = i in q_pool
        out.append(dict(side=side, dim=dim, dim_out=dim_out, heads=heads,
                        window=window, q_pool=pool))
        if pool:
            side //= 2
        dim = dim_out
    return out


def k1_step_launches(cfg, frames: int, rows: int) -> List[Tuple[int, int, int, int, int]]:
    """(BH, Nq, Nk, D, Dv) of every K1 launch of one lockstep step over
    ``frames`` frames and ``rows`` object rows: the trunk's global blocks
    (one launch a block over the frames and heads) and memory
    self-attention (one a layer over the rows). The other attentions are
    below K1's size rule (Nq * Nk < 2^22) and go to plain attention."""
    launches = []
    for b in hiera_blocks(cfg.hiera, cfg.image_size):
        if b["window"] == 0:
            n = b["side"] ** 2
            if b["q_pool"]:
                raise NotImplementedError("a global block that pools its queries")
            d = b["dim_out"] // b["heads"]
            launches.append((frames * b["heads"], n, n, d, d))
    ma = cfg.memory_attention
    s = cfg.image_embedding_size ** 2
    d = ma.d_model // ma.num_heads
    launches += [(rows * ma.num_heads, s, s, d, d)] * ma.num_layers
    return launches


# ---------------------------------------------------------------------------
# K2: csrc/flash_banked_keys.cu (pre-pass) + csrc/flash_banked_fwd.cu
# ---------------------------------------------------------------------------


def memory_live(cfg, k: int) -> Tuple[int, int]:
    """(spatial memory tiles, object-pointer tokens) that frame k of a stream
    prompted on frame 0 alone attends to: frame 0's conditioning memory and
    every non-conditioning memory of frames 1 .. k - 1 that SAM 2's
    selection reads."""
    r = max(1, cfg.memory_temporal_stride_for_eval)
    nm = cfg.num_maskmem
    tiles = 1
    for t_pos in range(1, nm):
        t_rel = nm - t_pos
        prev = k - 1 if t_rel == 1 else ((k - 2) // r) * r - (t_rel - 2) * r
        tiles += 1 <= prev <= k - 1
    ptrs = 1 + sum(1 <= k - t <= k - 1 for t in range(1, cfg.max_obj_ptrs_in_encoder))
    return tiles, ptrs * (cfg.hidden_dim // cfg.mem_dim)


K2_TILE = 64  # keys a tile of K2's main kernel; a bank tile is padded to it


def k2_tiles(cfg) -> int:
    """Tiles a K2 launch walks: the attended conditioning tiles (1: the
    streamer's bucket for one prompted frame), the num_maskmem - 1
    non-conditioning tiles and the object-pointer staging tile."""
    return 1 + (cfg.num_maskmem - 1) + 1


def k2_launches(cfg, rows: int, k: int, elt: int = BF16):
    """[(main FLOPs, main bytes), (pre-pass FLOPs, pre-pass bytes)] of one
    memory-attention layer's K2 call at frame k over ``rows`` object rows.
    Main: QK^T over D and PV over the raw Cm-wide values of the live keys;
    q, the fp32 bias and the output once, each live key's K and V row once.
    Pre-pass: the keys of every tile read from the bank and written padded
    to K2_TILE, the RoPE tables and the per-tile correction once."""
    s = cfg.image_embedding_size ** 2
    s_pad = -(-s // K2_TILE) * K2_TILE
    d, cm = cfg.memory_attention.d_model, cfg.mem_dim
    t = k2_tiles(cfg)
    tiles, ptr_tokens = memory_live(cfg, k)
    live = rows * (tiles * s + ptr_tokens)
    main = (2.0 * s * live * (d + cm),
            elt * rows * s * d + F32 * rows * t * s + elt * rows * s * cm
            + elt * live * (d + cm))
    keys = (0.0, elt * t * rows * s * d + elt * t * rows * s_pad * d
            + 2 * F32 * s * (d // 2) + F32 * t * d)
    return main, keys


# ---------------------------------------------------------------------------
# the whole step: model FLOPs from the reference's modules on the meta device
# ---------------------------------------------------------------------------


def step_model_flops(cfg, frames: int, rows: int, k: int) -> float:
    """Model FLOPs (2 a multiply-add, matrix products and convolutions) of
    one lockstep step at frame k: the trunk, neck and high-res convolutions
    over ``frames`` frames, then, over ``rows`` object rows, memory attention
    against SAM 2's memory of frame k (every memory key and value projected,
    as the published model does), the SAM heads with three masks, and the
    memory encoder. Counted by torch's FlopCounterMode over the reference's
    modules on the meta device: shapes only, nothing computed."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from port_bench.reference.sam2_base import SAM2Model

    meta = torch.device("meta")
    with torch.device(meta):
        model = SAM2Model(cfg).eval().requires_grad_(False)
    s = cfg.image_embedding_size
    tiles, ptr_tokens = memory_live(cfg, k)
    n_mem = tiles * s * s + ptr_tokens

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=meta)

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        s0, s1, _ = model.forward_image(empty(frames, cfg.image_size, cfg.image_size, 3,
                                              dtype=torch.uint8))
        feat = empty(rows, s, s, cfg.hidden_dim)
        s0 = empty(rows, *s0.shape[1:])
        s1 = empty(rows, *s1.shape[1:])
        pix = model.attend_memory(
            feat, empty(rows, n_mem, cfg.mem_dim), empty(rows, n_mem, cfg.mem_dim),
            torch.ones((rows, n_mem), dtype=torch.bool, device=meta),
            num_mem_frames=tiles, num_obj_ptr_tokens=ptr_tokens)
        out = model.forward_sam_heads(pix, high_res_features=[s0, s1], multimask_output=True)
        model.encode_memory(feat, out[4], out[6])
    return float(counter.get_total_flops())
