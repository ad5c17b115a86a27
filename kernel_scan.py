"""How K1's forward time scales with the work of a key tile, on one CUDA card.

    python3 kernel_scan.py

Times K1 (flash_attention_fwd) and torch's scaled_dot_product_attention at
the Hiera global shapes with one factor varied at a time: the widths D and
Dv (the work of a key tile), the keys Nk (the tiles a block walks) and the
rows BH (the blocks of the grid), in bf16 and fp32. A time that hardly
moves when the work of a tile grows says the kernel is bound by what it
pays a tile, not by its arithmetic. Prints the card's name and power limit
first; exits non-zero, having run nothing, without a card. chip_smoke.py
holds the kernels against their plain versions; this script only times.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

# (dtype, [(bh, nq, nk, d, dv)]): the Hiera global shapes with one factor varied
SCAN = ((torch.bfloat16, [(4, 4096, 4096, 64, 64), (4, 4096, 4096, 96, 96),
                          (4, 4096, 4096, 128, 128), (4, 4096, 4096, 96, 64),
                          (4, 4096, 8192, 96, 96), (2, 4096, 4096, 96, 96),
                          (8, 4096, 4096, 96, 96)]),
        (torch.float32, [(64, 4096, 4096, 56, 56), (64, 4096, 4096, 64, 64),
                         (64, 4096, 4096, 32, 32)]))


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_scan: no CUDA device; nothing was run", flush=True)
        return 2
    import chip_smoke as cs
    from det_sam2_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.log(cs.gpu_line())
    att.build_kernels(("flash_fwd",))
    for dtype, shapes in SCAN:
        for bh, nq, nk, d, dv in shapes:
            q, k, v, _ = cs._k1_inputs(0, bh, nq, nk, d, dv, dtype, None, dev)
            iters = 20 if dtype == torch.bfloat16 else 3
            ms = cs.time_ms(lambda: att.flash_attention_fwd(q, k, v), iters)
            lib = cs.time_ms(lambda: F.scaled_dot_product_attention(
                q[:, None], k[:, None], v[:, None]), iters)
            tflops = 2.0 * bh * nq * nk * (d + dv) / ms / 1e9
            cs.log(f"[scan] {str(dtype)[6:]} bh {bh} nq {nq} nk {nk} d {d} dv {dv}: "
                   f"ms {ms:.4f} sdpa_ms {lib:.4f} TFLOP/s {tflops:.1f}")
            del q, k, v
    return 0


if __name__ == "__main__":
    sys.exit(main())
