"""cv2's INTER_LINEAR resize of mask logits, bit for bit, on the H100.

The JAX package resizes mask logits to the video's or the original image's
size on the host with ``cv2.resize`` (``utils/misc.py:resize_masks_np``):
the masks go through cv2's channel axis 128 at a time, and cv2 takes IPP's
arithmetic at 1, 3 or 4 channels and its own generic float path at any other
count. The port computes those bits on the card with a hand-written kernel,
``csrc/mask_resize.cu`` (host code in the JAX package, so it replaces no
Pallas kernel). Its plain version is the port's host rebuild,
``utils.misc.resize_masks_np`` (``utils/cv2_resize.py``), and the taps of
both come from the same functions there.

``resize_masks_cv2`` given a CPU tensor computes the plain version; given a
CUDA tensor it launches the kernel or raises, and adds one to
``ops.attention.LAUNCHES["mask_resize"]``. The kernel walks tiles of output
rows (``row_tile``) with 4 columns a thread; ``check_launch`` refuses what
its grid and tap offsets do not take. The kernel joins the attention
kernels' build, loading and counts (``ops.attention.register_kernel``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from det_sam2_tpu_torch.ops import attention as att
from det_sam2_tpu_torch.utils import cv2_resize
from det_sam2_tpu_torch.utils.cv2_resize import MASK_GROUP
from det_sam2_tpu_torch.utils.misc import resize_masks_np
from det_sam2_tpu_torch.utils.profiling import spanned

_P, _I = ctypes.c_void_p, ctypes.c_int
# src, dst, idx, wt, n, group, h, w, oh, ow, rows, fault, stream
att.register_kernel("mask_resize", [_P] * 4 + [_I] * 8 + [_P])
# planted faults (csrc/mask_resize.cu kFault*), for the checks that must
# catch them; production calls pass 0
FAULTS = {"generic path compiled with FMA contraction": 1,
          "IPP border rule off": 2,
          "first group on the wrong path": 3,
          "row cache not moved on to y1's row": 4}

# the kernel's block: THREADS threads of 4 columns each, over a tile of
# MIN_ROWS to MAX_ROWS output rows of one mask (csrc/mask_resize.cu)
THREADS, MIN_ROWS, MAX_ROWS = 64, 8, 32
# threads an SM holds at once
_SM_THREADS = 2048
_GRID_YZ = 65535  # CUDA's limit on grid.y and grid.z
_INT32_MAX = 2 ** 31 - 1


def _round4(ow: int) -> int:
    return -(-ow // 4) * 4


def row_tile(n: int, oh: int, ow: int, sms: int) -> int:
    """The kernel's row tile: MAX_ROWS rows, halved (down to MIN_ROWS) while
    the launch has fewer threads than ``sms`` SMs hold at once, so small
    resizes still fill the card; then at least the rows that keep the row
    tiles within grid.y."""
    blocks_x = -(-_round4(ow) // (4 * THREADS))
    rows = MAX_ROWS
    while rows > MIN_ROWS and n * -(-oh // rows) * blocks_x * THREADS < sms * _SM_THREADS:
        rows //= 2
    return max(rows, -(-oh // _GRID_YZ))


def check_launch(n: int, in_hw, out_hw) -> None:
    """Raise ValueError on exactly the resizes that csrc/mask_resize.cu does
    not take (its C entry refuses the same): no mask or more than 65535 (the
    masks are grid.z), an empty size, more output rows than 65535 tiles of
    MAX_ROWS (grid.y), or taps whose offsets leave int32."""
    (h, w), (oh, ow) = in_hw, out_hw
    if min(h, w, oh, ow) < 1:
        raise ValueError(f"mask_resize takes non-empty sizes, got {h}x{w} -> {oh}x{ow}")
    if not 1 <= n <= _GRID_YZ:
        raise ValueError(f"mask_resize takes 1 to {_GRID_YZ} masks a launch, got {n}")
    if oh > _GRID_YZ * MAX_ROWS:
        raise ValueError(f"mask_resize takes at most {_GRID_YZ * MAX_ROWS} output rows "
                         f"({_GRID_YZ} tiles of {MAX_ROWS}), got {oh}")
    if 6 * _round4(ow) + 4 * oh > _INT32_MAX:
        raise ValueError(f"mask_resize's taps for {oh}x{ow} outgrow int32 offsets")


def mask_resize_taps(in_hw, out_hw) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's taps for a resize [h, w] -> [H, W], packed as the
    kernel reads them: int32 [gx0, gx1, ix0, ix1, copy, border] (W4 each)
    then [gy0, gy1, iy0, iy1] (H each); float32 [ga0, ga1, itx] (W4 each)
    then [gb0, gb1, ity] (H each). g* are cv2's generic taps, i* IPP's. W4
    is W rounded up to 4, so that each column array starts 16-byte aligned
    and a thread loads its 4 columns' taps as one 16-byte load; the columns
    past W repeat the last column's taps."""
    (h, w), (oh, ow) = in_hw, out_hw
    gx0, gx1, ga0, ga1, copy = cv2_resize.generic_x_taps(ow, w)
    gy0, gy1, gb0, gb1 = cv2_resize.generic_y_taps(oh, h)
    ix0, ix1, itx = cv2_resize.ipp_taps(ow, w)
    iy0, iy1, ity = cv2_resize.ipp_taps(oh, h)
    border = cv2_resize.ipp_border(ow, w)
    pad = lambda a: np.pad(a, (0, _round4(ow) - ow), mode="edge")  # noqa: E731
    idx = np.concatenate([pad(a) for a in (gx0, gx1, ix0, ix1, copy, border)]
                         + [gy0, gy1, iy0, iy1])
    wt = np.concatenate([pad(a) for a in (ga0, ga1, itx)] + [gb0, gb1, ity])
    return idx.astype(np.int32), wt.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_taps(in_hw, out_hw, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mask_resize_taps`` on device dev, kept for the next call of the
    same sizes (a video's frames, an image's masks)."""
    idx, wt = mask_resize_taps(in_hw, out_hw)
    return torch.from_numpy(idx).to(dev), torch.from_numpy(wt).to(dev)


@functools.lru_cache(maxsize=8)
def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def resize_masks_cv2_ref(x: torch.Tensor, out_hw, group: int = MASK_GROUP) -> torch.Tensor:
    """Plain version: the host rebuild of cv2's resize, [..., h, w] ->
    float32 [..., H, W] on x's device."""
    out = resize_masks_np(x.detach().float().cpu().numpy(), out_hw, group)
    return torch.from_numpy(np.ascontiguousarray(out)).to(x.device)


def launch_args(src: torch.Tensor, out: torch.Tensor, group: int, fault: int = 0):
    """The C entry's arguments for src [n, h, w] -> out [n, H, W], both
    float32, contiguous and 16-byte aligned on one card, with the taps
    cached on that card: ``att.launch("mask_resize", *launch_args(...))``."""
    (n, h, w), (oh, ow) = src.shape, out.shape[1:]
    idx, wt = _device_taps((h, w), (oh, ow), src.device)
    return (src.data_ptr(), out.data_ptr(), idx.data_ptr(), wt.data_ptr(), n, group,
            h, w, oh, ow, row_tile(n, oh, ow, _sms(src.device)), fault,
            torch.cuda.current_stream(src.device).cuda_stream)


@spanned("ops.mask_resize")
def resize_masks_cv2(x: torch.Tensor, out_hw, group: int = MASK_GROUP,
                     fault: int = 0) -> torch.Tensor:
    """Mask logits [..., h, w] -> float32 [..., H, W], equal to the JAX
    package's ``resize_masks_np`` with cv2 present: the masks flattened to
    [N, h, w] and resized as the channels of cv2 calls of ``group`` masks
    (128, the JAX package's; 1 for its per-object resizes). A CPU tensor
    takes the plain version; a CUDA tensor launches csrc/mask_resize.cu on
    the current stream, one launch a call, or raises (``check_launch``).
    The call is the ``ops.mask_resize`` span."""
    h, w = x.shape[-2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (h, w) == (oh, ow):
        return x
    if not 1 <= group <= MASK_GROUP:
        raise ValueError(f"cv2 takes 1 to {MASK_GROUP} channels a call, got {group}")
    if not x.is_cuda:
        if fault:
            raise ValueError("planted faults exist only in the kernel")
        return resize_masks_cv2_ref(x, (oh, ow), group)
    lead = x.shape[:-2]
    src = x.float().reshape(-1, h, w).contiguous()
    n = src.shape[0]
    out = torch.empty((n, oh, ow), dtype=torch.float32, device=x.device)
    if n:
        check_launch(n, (h, w), (oh, ow))
        if src.data_ptr() % 16:  # a view into a larger buffer
            src = src.clone()
        att.launch("mask_resize", *launch_args(src, out, group, fault))
    return out.reshape(*lead, oh, ow)
