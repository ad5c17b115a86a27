"""Multi-card encoding of one frame: shard the image's rows.

Counterpart of the JAX package's ``parallel/spatial.py``, where GSPMD
partitions the single-device program over the image height. Here the
partition is written out, one band of rows a rank:

* **Patch embed** (7x7, stride 4, padding 3): a rank owning patch rows
  [r0, r1) reads input rows [4 r0 - 3, 4 r1) of the whole frame (every rank
  has it) and zero-pads only at the image's edges, after the normalisation,
  as the full convolution pads the normalised input. No communication.
* **Positional embedding**: resized at the full grid, then cut to the band.
* **Windowed blocks** (q-pool blocks too): a band is whole window rows of
  the block's own window size; the last band also carries the grid's
  padding. Blocks run unchanged on their bands (pooling stays inside the
  windows). Where the bands do not fall on a block's window rows, the
  residual stream is all-gathered and cut anew; a rank may own no window
  row of a small grid and then computes nothing for that block.
* **Global blocks**: each rank projects q, k, v of its own rows, all-gathers
  k and v, and attends its own queries to every key through the model's
  ``attention_fn`` (on the card K1 with Nq != Nk).
* **Neck**: every rank runs the FPN neck and the decoder's high-resolution
  convolutions on the all-gathered stage outputs (1x1 convolutions and a
  nearest top-down pathway, little work beside the trunk's).

Every rank returns the whole ``(feat_s0, feat_s1, feat)`` of
``engine.encode_image``; a mesh of one rank is ``encode_image`` itself. The
ranks' pieces travel through ``mesh.all_gather_cat`` (gloo for several ranks
on one card, NCCL across cards). This is latency scaling (one frame
faster); ``inference_sharding.py`` is its throughput counterpart.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from det_sam2_tpu_torch.modeling.hiera import max_pool_2x
from det_sam2_tpu_torch.parallel.mesh import all_gather_cat
from det_sam2_tpu_torch.track import normalize_image

Bands = List[Tuple[int, int]]


def split_units(units: int, n: int) -> List[Tuple[int, int]]:
    """[0, units) in n contiguous ranges as even as possible, the longer
    ones first (a range is empty when units < n)."""
    base, extra = divmod(units, n)
    out, a = [], 0
    for r in range(n):
        b = a + base + (r < extra)
        out.append((a, b))
        a = b
    return out


def row_bands(h: int, unit: int, n: int) -> Bands:
    """Row bands [a, b) of an h-row grid over n ranks, cut at multiples of
    `unit`; the last non-empty band ends at h."""
    units = -(-h // unit)
    return [(min(a * unit, h), min(b * unit, h)) for a, b in split_units(units, n)]


def _fits(bands, unit: int, h: int, allow_empty: bool) -> bool:
    if bands is None:
        return False
    if not allow_empty and any(a == b for a, b in bands):
        return False
    return all(a % unit == 0 or a == h for a, _ in bands)


def _sizes(bands, w: int = 1) -> List[int]:
    return [(b - a) * w for a, b in bands]


def _global_block(blk, x, gather_tokens):
    """MultiScaleBlock.forward of a global-attention block on a band of
    rows: its queries attend every rank's keys."""
    attn = blk.attn
    b, h, w, _ = x.shape
    heads = attn.num_heads
    dim_out = blk.norm2.weight.shape[0]
    if h == 0:  # no rows here: add no keys, compute nothing
        empty = x.new_zeros(b, heads, 0, dim_out // heads)
        gather_tokens(empty)  # k
        gather_tokens(empty)  # v
        w_out = w // 2 if blk.q_stride else w
        return x.new_zeros(b, 0, w_out, dim_out)
    shortcut = x
    x = blk.norm1(x)
    if blk.proj is not None:
        shortcut = blk.proj(x)
        if blk.q_stride:
            shortcut = max_pool_2x(shortcut)
    n = h * w
    qkv = attn.qkv(x.reshape(b, n, -1)).reshape(b, n, 3, heads, -1)
    q, k, v = qkv.unbind(2)
    oh, ow = h, w
    if attn.q_pool:
        q = max_pool_2x(q.reshape(b, h, w, -1))
        oh, ow = q.shape[1], q.shape[2]
        q = q.reshape(b, oh * ow, heads, -1)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [B, heads, N, D]
    k, v = gather_tokens(k), gather_tokens(v)
    o = attn.attention_fn(q, k, v)
    o = o.transpose(1, 2).reshape(b, oh * ow, -1)
    x = shortcut + attn.proj(o).reshape(b, oh, ow, -1)
    return x + blk.mlp(blk.norm2(x))


def _windowed_block(blk, x):
    if x.shape[1] == 0:
        w_out = x.shape[2] // 2 if blk.q_stride else x.shape[2]
        return x.new_zeros(x.shape[0], 0, w_out, blk.norm2.weight.shape[0])
    return blk(x)


def make_spatial_encode(engine, mesh, axis_name: str = "spatial"):
    """``encode(img [1, H, W, 3]) -> (feat_s0, feat_s1, feat)`` with the
    trunk's rows sharded over the mesh axis; every rank gets the whole
    result, equal to ``engine.encode_image(img)`` (bit for bit on one
    rank, within rounding on several). Every rank is handed the whole
    frame."""
    model = engine.model
    trunk = model.image_encoder.trunk
    group = mesh.get_group(axis_name)
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    stage_ends = set(trunk.cfg.stage_ends)

    def gather_rows(x, bands):
        return all_gather_cat(mesh, x, 1, _sizes(bands), axis_name)

    def patch_embed(img, band):
        pe = trunk.patch_embed
        conv = pe.proj
        (kh, _), (s, _), (p, pw) = conv.kernel_size, conv.stride, conv.padding
        rows = img.shape[1]
        r0, r1 = band
        lo, hi = r0 * s - p, (r1 - 1) * s - p + kh
        x = pe.normalize(img[:, max(lo, 0):min(hi, rows)])
        x = F.pad(x, (0, 0, max(0, -lo), max(0, hi - rows)))
        return F.conv2d(x, conv.weight, conv.bias, stride=s, padding=(0, pw)).permute(0, 2, 3, 1)

    @torch.no_grad()
    def encode(img):
        img = engine._t(img)
        if n == 1:
            return engine.encode_image(img)
        img = normalize_image(img).contiguous()
        conv = trunk.patch_embed.proj
        (kh, kw), (s, _), (p, pw) = conv.kernel_size, conv.stride, conv.padding
        h = (img.shape[1] + 2 * p - kh) // s + 1
        w = (img.shape[2] + 2 * pw - kw) // s + 1
        pos = trunk.pos_embed_at(h, w)
        first = trunk.blocks[0]
        bands = row_bands(h, first.window_size or (2 if first.q_stride else 1), n)
        a, b = bands[rank]
        if a < b:
            x = patch_embed(img, (a, b))
            x = x + pos[:, a:b].to(x.dtype)
        else:
            x = img.new_zeros(img.shape[0], 0, w, conv.out_channels, dtype=conv.weight.dtype)
        outputs, full = [], None
        for i, blk in enumerate(trunk.blocks):
            h = bands[-1][1]
            ws = blk.window_size
            unit = ws if ws > 0 else (2 if blk.q_stride else 1)
            if not _fits(bands, unit, h, allow_empty=ws > 0):
                full = gather_rows(x, bands) if full is None else full
                bands = row_bands(h, unit, n)
                a, b = bands[rank]
                x = full[:, a:b].contiguous()
            if ws > 0:
                x = _windowed_block(blk, x)
            else:
                wk = x.shape[2]
                x = _global_block(blk, x, lambda t, bands=bands, wk=wk: all_gather_cat(
                    mesh, t, 2, _sizes(bands, wk), axis_name))
            full = None
            if blk.q_stride:
                bands = [(a // 2, b // 2) for a, b in bands]
            if i in stage_ends:
                full = gather_rows(x, bands)
                outputs.append(full)
        return model.decoder_features(model.image_encoder.neck_features(outputs))

    return encode
