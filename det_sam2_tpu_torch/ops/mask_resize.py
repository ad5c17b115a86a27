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
``ops.attention.LAUNCHES["mask_resize"]``. The kernel joins the attention
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

_P, _I = ctypes.c_void_p, ctypes.c_int
# src, dst, idx, wt, n, group, h, w, oh, ow, fault, stream
att.register_kernel("mask_resize", [_P] * 4 + [_I] * 7 + [_P])
# planted faults (csrc/mask_resize.cu kFault*), for the checks that must
# catch them; production calls pass 0
FAULTS = {"generic path compiled with FMA contraction": 1,
          "IPP border rule off": 2,
          "first group on the wrong path": 3}


def mask_resize_taps(in_hw, out_hw) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's taps for a resize [h, w] -> [H, W], packed as the
    kernel reads them: int32 [gx0, gx1, ix0, ix1, copy, border] (W each)
    then [gy0, gy1, iy0, iy1] (H each); float32 [ga0, ga1, itx] (W each)
    then [gb0, gb1, ity] (H each). g* are cv2's generic taps, i* IPP's."""
    (h, w), (oh, ow) = in_hw, out_hw
    gx0, gx1, ga0, ga1, copy = cv2_resize.generic_x_taps(ow, w)
    gy0, gy1, gb0, gb1 = cv2_resize.generic_y_taps(oh, h)
    ix0, ix1, itx = cv2_resize.ipp_taps(ow, w)
    iy0, iy1, ity = cv2_resize.ipp_taps(oh, h)
    border = cv2_resize.ipp_border(ow, w)
    idx = np.concatenate([gx0, gx1, ix0, ix1, copy, border, gy0, gy1, iy0, iy1])
    wt = np.concatenate([ga0, ga1, itx, gb0, gb1, ity])
    return idx.astype(np.int32), wt.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_taps(in_hw, out_hw, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """``mask_resize_taps`` on device dev, kept for the next call of the
    same sizes (a video's frames, an image's masks)."""
    idx, wt = mask_resize_taps(in_hw, out_hw)
    return torch.from_numpy(idx).to(dev), torch.from_numpy(wt).to(dev)


def resize_masks_cv2_ref(x: torch.Tensor, out_hw, group: int = MASK_GROUP) -> torch.Tensor:
    """Plain version: the host rebuild of cv2's resize, [..., h, w] ->
    float32 [..., H, W] on x's device."""
    out = resize_masks_np(x.detach().float().cpu().numpy(), out_hw, group)
    return torch.from_numpy(np.ascontiguousarray(out)).to(x.device)


def resize_masks_cv2(x: torch.Tensor, out_hw, group: int = MASK_GROUP,
                     fault: int = 0) -> torch.Tensor:
    """Mask logits [..., h, w] -> float32 [..., H, W], equal to the JAX
    package's ``resize_masks_np`` with cv2 present: the masks flattened to
    [N, h, w] and resized as the channels of cv2 calls of ``group`` masks
    (128, the JAX package's; 1 for its per-object resizes). A CPU tensor
    takes the plain version; a CUDA tensor launches csrc/mask_resize.cu on
    the current stream."""
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
    if oh > 65535 or n > 65535 or min(h, w, oh, ow) < 1:
        raise ValueError(f"mask_resize takes 1 <= H, N <= 65535 and non-empty sizes, "
                         f"got {n} masks {h}x{w} -> {oh}x{ow}")
    out = torch.empty((n, oh, ow), dtype=torch.float32, device=x.device)
    if n:
        idx, wt = _device_taps((h, w), (oh, ow), x.device)
        att.launch("mask_resize", src.data_ptr(), out.data_ptr(), idx.data_ptr(),
                   wt.data_ptr(), n, group, h, w, oh, ow, fault,
                   torch.cuda.current_stream(x.device).cuda_stream)
    return out.reshape(*lead, oh, ow)
