"""cv2's INTER_LINEAR resize, rebuilt bit for bit without cv2.

The JAX package resizes ndarray frames with ``cv2.resize`` (uint8, the
frame preparation) and stored frames back to video size with cv2's float
resize (``tensor_to_frame_rgb``); the training loader warps and resizes with
cv2 as well. The card's machine has no cv2, so the port computes cv2's
arithmetic here, on the host (checked against cv2 5.0 in the CPU tests):
  * uint8 [H, W, C] (``resize_linear``): half-pixel centres, coordinates in
    float32, 11-bit weights, the horizontal pass in integers, the vertical
    pass as cv2's SIMD kernel rounds it ((S >> 4) * w >> 16 per row, then
    (sum + 2) >> 2);
  * float32 [H, W, 3] (``resize_linear_float``): cv2 hands it to IPP, which
    takes the fractions in float64, rounds them to float32 and interpolates
    as p + t * (q - p) with one rounding (an FMA), the horizontal pass
    first. Its border code rounds the first two channels of the columns
    clamped to the image's edge without the FMA once there are 5 or more of
    them a side (an upscale of ~9x or more); this rebuild does not follow
    that.
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


def _float_taps(dst: int, src: int):
    """IPP's linear taps along one axis: the two source indices (clamped to
    the image) and the fraction, taken in float64 and rounded to float32."""
    f = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    s = np.floor(f)
    t = np.where((s < 0) | (s >= src - 1), 0.0, f - s).astype(np.float32)
    s = np.clip(s.astype(np.int64), 0, src - 1)
    return s, np.minimum(s + 1, src - 1), t


def resize_linear_float(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, size) of a float32 [H, W, 3] image; size is (width,
    height), as cv2 takes it."""
    h, w = img.shape[:2]
    ow, oh = int(size[0]), int(size[1])
    src = np.asarray(img, np.float32)
    x0, x1, tx = _float_taps(ow, w)
    p, q = src[:, x0], src[:, x1]
    rows = _fma32(tx[None, :, None], q - p, p)
    y0, y1, ty = _float_taps(oh, h)
    p, q = rows[y0], rows[y1]
    return _fma32(ty[:, None, None], q - p, p)
