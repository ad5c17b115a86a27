"""cv2's INTER_LINEAR resize, rebuilt bit for bit without cv2.

The JAX package resizes ndarray frames with ``cv2.resize`` (uint8, the
frame preparation), mask logits to video or image size with cv2's float
resize (``utils/misc.resize_masks_np``) and stored frames back to video size
the same way (``tensor_to_frame_rgb``); the training loader warps and
resizes with cv2 as well. The card's machine has no cv2, so the port
computes cv2's arithmetic here, on the host (checked against cv2 5.0 in the
CPU tests; ``csrc/mask_resize.cu`` computes the float paths on the card
from the same taps):
  * uint8 [H, W, C] (``resize_linear``): half-pixel centres, coordinates in
    float32, 11-bit weights, the horizontal pass in integers, the vertical
    pass as cv2's SIMD kernel rounds it ((S >> 4) * w >> 16 per row, then
    (sum + 2) >> 2);
  * float32 at 1, 3 or 4 channels (``resize_linear_float``): cv2 hands it
    to IPP, which takes the fractions in float64, rounds them to float32
    and interpolates as p + t * (q - p) with one rounding (an FMA), the
    horizontal pass first; its border code rounds twice in some channels of
    the columns clamped to the image's edge (``ipp_border``);
  * float32 at any other channel count (``resize_linear_float_generic``):
    cv2's own path, float32 coordinates, every product and sum rounded on
    its own, INTER_AREA's fast path at an exact 2x downscale on both axes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _fma32(a, b, c) -> np.ndarray:
    """Correctly rounded float32 a * b + c (one rounding, as an FMA
    instruction) of float32 arrays. The product of two float32 values is
    exact in float64, so the float64 sum has one rounding; rounding that to
    float32 differs from the single rounding only where the float64 sum
    lands exactly halfway between two float32 values, and there the
    float64 sum is rounded to odd first (with its exact error, TwoSum)."""
    a = np.asarray(a, np.float32).astype(np.float64)
    b, c = np.asarray(b, np.float32), np.asarray(c, np.float32)
    s = a * b + c
    low = s.view(np.uint64) & np.uint64(0x1FFFFFFF)
    odd_case = low == np.uint64(0x10000000)
    odd_case |= (np.abs(s) < 2.0 ** -100) & (s != 0)
    if odd_case.any():
        i = np.nonzero(odd_case)
        p = np.broadcast_to(a * b, s.shape)[i]
        cc = np.broadcast_to(c, s.shape)[i].astype(np.float64)
        ss = s[i]
        bb = ss - p
        err = (p - (ss - bb)) + (cc - bb)
        even = (ss.view(np.uint64) & 1) == 0
        bump = (err != 0) & even
        s[i] = np.where(bump, np.nextafter(ss, np.where(err > 0, np.inf, -np.inf)), ss)
    return s.astype(np.float32)


def _linear_taps(dst: int, src: int):
    """cv2.resize INTER_LINEAR's source index and 11-bit weights along one
    axis (the scale as cv2 forms it, 1 / (dst / src); coordinates in
    float32; past an edge the weight goes to the edge pixel)."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    s = s.astype(np.int64)
    f = np.where((s < 0) | (s >= src - 1), np.float32(0), f)
    s = np.clip(s, 0, src - 1)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32)
    w1 = np.rint(f * np.float32(2048)).astype(np.int32)
    return s, np.minimum(s + 1, src - 1), w0, w1


def resize_linear(img: np.ndarray, size: int) -> np.ndarray:
    """cv2.resize(img, (size, size)) of a uint8 [H, W, C] frame. The taps
    are computed in numpy, the integer passes with torch's CPU ops (threaded;
    integers, so exact in any order)."""
    h, w = img.shape[:2]
    x0, x1, a0, a1 = _linear_taps(size, w)
    # the vertical pass as cv2's SIMD kernel rounds it: no weight moved to
    # the edge row, the fixed-point rows shifted by 4 first
    sy = ((np.arange(size, dtype=np.float64) + 0.5) * (1.0 / (size / h)) - 0.5
          ).astype(np.float32)
    y = np.floor(sy)
    fy = (sy - y).astype(np.float32)
    y = y.astype(np.int64)
    b0 = np.rint((np.float32(1) - fy) * np.float32(2048)).astype(np.int32)
    b1 = np.rint(fy * np.float32(2048)).astype(np.int32)
    img = np.ascontiguousarray(img)
    src = torch.from_numpy(img if img.flags.writeable else img.copy())
    t = torch.from_numpy
    rows = src.index_select(1, t(x0)).int().mul_(t(a0).view(1, -1, 1))
    rows.add_(src.index_select(1, t(x1)).int().mul_(t(a1).view(1, -1, 1)))
    rows.bitwise_right_shift_(4)
    v = rows.index_select(0, t(np.clip(y, 0, h - 1))).mul_(t(b0).view(-1, 1, 1))
    v.bitwise_right_shift_(16)
    v1 = rows.index_select(0, t(np.clip(y + 1, 0, h - 1))).mul_(t(b1).view(-1, 1, 1))
    v.add_(v1.bitwise_right_shift_(16))
    return v.add_(2).bitwise_right_shift_(2).clamp_(0, 255).to(torch.uint8).numpy()


def ipp_taps(dst: int, src: int):
    """IPP's linear taps along one axis: the two source indices (clamped to
    the image) and the fraction, taken in float64 and rounded to float32
    (0 where the source index is clamped)."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    s = np.floor(f)
    t = np.where((s < 0) | (s >= src - 1), 0.0, f - s).astype(np.float32)
    s = np.clip(s.astype(np.int64), 0, src - 1)
    return s, np.minimum(s + 1, src - 1), t


def ipp_border(dst: int, src: int) -> np.ndarray:
    """IPP's border rule along the output columns: int8 [dst], 1 where a
    column is in the remainder of the clamped columns of its side and that
    remainder has 5 or more columns, 2 where it is in a full block of 16.
    The clamped columns of a side (source index < 0 on the left, >= src - 1
    on the right) split from left to right into blocks of 16 and a
    remainder. In the flagged columns IPP's vertical pass rounds twice,
    p + round(t * (q - p)): the remainder's in channels 0-1 at 3 channels
    and in all four at 4, the blocks' at 4 channels only."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    s = np.floor(f)
    flag = np.zeros(dst, np.int8)
    for cols in (np.nonzero(s < 0)[0], np.nonzero(s >= src - 1)[0]):
        full = len(cols) // 16 * 16
        flag[cols[:full]] = 2
        if len(cols) - full >= 5:
            flag[cols[full:]] = 1
    return flag


def generic_taps(dst: int, src: int):
    """cv2's own (non-IPP) float INTER_LINEAR taps along one axis: the
    source index floor(f) and the weights (1 - f', f') of
    f = float32((d + 0.5) * scale - 0.5) with scale = 1 / (dst / src) in
    float64 and f' = float32(f - floor(f)). The index is not clamped."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f)
    f = (f - s).astype(np.float32)
    return s.astype(np.int64), np.float32(1) - f, f


def generic_x_taps(dst: int, src: int):
    """The horizontal pass's taps of ``generic_taps``: (x0, x1, a0, a1,
    copy). Left of the image the fraction goes to 0 and the index to 0;
    where the index reaches the last column (``copy``) cv2 copies
    S[src - 1] with no product."""
    s, a0, a1 = generic_taps(dst, src)
    left = s < 0
    a0 = np.where(left, np.float32(1), a0).astype(np.float32)
    a1 = np.where(left, np.float32(0), a1).astype(np.float32)
    copy = s >= src - 1
    x0 = np.clip(s, 0, src - 1)
    return x0, np.minimum(x0 + 1, src - 1), a0, a1, copy


def generic_y_taps(dst: int, src: int):
    """The vertical pass's taps of ``generic_taps``: (y0, y1, b0, b1), the
    indices clamped to the image and the weights kept as they are at the
    top and bottom edges."""
    s, b0, b1 = generic_taps(dst, src)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), b0, b1


def area_fast(out_hw: Tuple[int, int], in_hw: Tuple[int, int]) -> bool:
    """cv2 hands an exact 2x downscale on both axes from INTER_LINEAR to
    INTER_AREA's fast path (its generic path only)."""
    return out_hw[0] * 2 == in_hw[0] and out_hw[1] * 2 == in_hw[1]


def _ipp_chw(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """IPP's float INTER_LINEAR of float32 [C, H, W], C in (1, 3, 4), into
    out [C, H', W']: the horizontal pass, then the vertical, each
    p + t * (q - p) as one FMA (``_fma32``), except where ``ipp_border``
    says the vertical pass rounds twice. Channel by channel: the float64
    temporaries of ``_fma32`` stay one channel's size."""
    c, h, w = x.shape
    oh, ow = out.shape[1:]
    src = x.numpy()
    x0, x1, tx = ipp_taps(ow, w)
    p = np.take(src, x0, axis=2)
    q = np.take(src, x1, axis=2)
    rows = _fma32(tx, np.subtract(q, p, out=q), p)
    y0, y1, ty = ipp_taps(oh, h)
    flag = ipp_border(ow, w)
    cols = np.nonzero(flag == 1 if c == 3 else flag > 0)[0] if c in (3, 4) else []
    twice = range(2 if c == 3 else c) if len(cols) else ()
    for i in range(c):
        p = np.take(rows[i], y0, axis=0)
        q = np.take(rows[i], y1, axis=0)
        q -= p
        o = out[i].numpy()
        o[...] = _fma32(ty[:, None], q, p)
        if i in twice:
            o[:, cols] = p[:, cols] + ty[:, None] * q[:, cols]
    return out


def _generic_chw(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """cv2's generic float INTER_LINEAR of float32 [C, H, W] into out
    [C, H', W']: every product and sum rounded on its own (numpy's and
    torch's CPU multiplies and adds, never fused), so exact in any order.
    The column gathers go through numpy (``np.take``), the row gathers
    through torch, channel by channel."""
    c, h, w = x.shape
    oh, ow = out.shape[1:]
    if area_fast((oh, ow), (h, w)):
        torch.add(x[:, 0::2, 0::2], x[:, 0::2, 1::2], out=out)
        return out.add_(x[:, 1::2, 0::2]).add_(x[:, 1::2, 1::2]).mul_(0.25)
    src = x.numpy()
    x0, x1, a0, a1, copy = generic_x_taps(ow, w)
    rows = np.take(src, x0, axis=2)
    rows *= a0
    tmp = np.take(src, x1, axis=2)
    tmp *= a1
    rows += tmp
    rows[:, :, copy] = src[:, :, w - 1:w]
    t = torch.from_numpy
    rows = t(rows)
    y0, y1, b0, b1 = generic_y_taps(oh, h)
    y0, y1, b0, b1 = t(y0), t(y1), t(b0).view(-1, 1), t(b1).view(-1, 1)
    for i in range(c):
        o = torch.index_select(rows[i], 0, y0, out=out[i]).mul_(b0)
        o.add_(rows[i].index_select(0, y1).mul_(b1))
    return out


# cv2 takes at most this many channels in one resize: the JAX package
# resizes masks through the channel axis in groups of this size
MASK_GROUP = 128


def resize_chw(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """cv2.resize(x as [H, W, C], (W', H')) of a float32 CPU tensor
    [C, H, W] into out [C, H', W']: cv2 takes IPP at 1, 3 or 4 channels and
    its generic path at any other count."""
    x = x.float().contiguous()
    return (_ipp_chw if x.shape[0] in (1, 3, 4) else _generic_chw)(x, out)


def _hwc(path, img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    x = torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(img, np.float32), -1, 0)))
    out = torch.empty((x.shape[0], int(size[1]), int(size[0])), dtype=torch.float32)
    return np.ascontiguousarray(np.moveaxis(path(x, out).numpy(), 0, -1))


def resize_linear_float(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size) of a float32 [H, W, C] image, C in (1, 3, 4),
    through IPP's arithmetic; size is (width, height), as cv2 takes it."""
    return _hwc(_ipp_chw, img, size)


def resize_linear_float_generic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size) of a float32 [H, W, C] image through cv2's
    generic float INTER_LINEAR (cv2 takes it at C not in (1, 3, 4));
    size is (width, height)."""
    return _hwc(_generic_chw, img, size)
