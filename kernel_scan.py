"""Time scans of the kernels' limits on one CUDA card.

    python3 kernel_scan.py        # K1's time as the work of a key tile varies
    python3 kernel_scan.py mma    # mma.sync m16n8k8 TF32 clocks and rate

Default mode: times K1 (flash_attention_fwd) and torch's
scaled_dot_product_attention at the Hiera global shapes with one factor
varied at a time: the widths D and Dv (the work of a key tile), the keys Nk
(the tiles a block walks) and the rows BH (the blocks of the grid), in bf16
and fp32. A time that hardly moves when the work of a tile grows says the
kernel is bound by what it pays a tile, not by its arithmetic.

`mma` mode: the ceiling of K3a / K3b's design, which takes every
fp32-grade product as three `mma.sync` m16n8k8 TF32 products (3xTF32). A
probe kernel does nothing but such mmas on registers, with 4, 8 or 16 warps
an SM and 1-16 independent accumulator chains a warp, one block an SM over
every SM. Each block counts its own clocks (`clock64`), so the result is in
clocks an mma an SM sub-partition (SMSP), with no assumption about the
clock rate; the TF32 rate comes from the event time. The probe is built
with nvcc into build/kernel_scan/ (git-ignored) at first use.

Prints the card's name and power limit first; exits non-zero, having run
nothing, without a card. chip_smoke.py holds the kernels against their
plain versions; this script only times.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

# (dtype, [(bh, nq, nk, d, dv)]): the Hiera global shapes with one factor varied
SCAN = ((torch.bfloat16, [(4, 4096, 4096, 64, 64), (4, 4096, 4096, 96, 96),
                          (4, 4096, 4096, 128, 128), (4, 4096, 4096, 96, 64),
                          (4, 4096, 8192, 96, 96), (2, 4096, 4096, 96, 96),
                          (8, 4096, 4096, 96, 96)]),
        (torch.float32, [(64, 4096, 4096, 56, 56), (64, 4096, 4096, 64, 64),
                         (64, 4096, 4096, 32, 32)]))

MMA_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int NACC>
__global__ void probe(float* out, long long* clocks, int iters) {
  uint32_t a[4];
  for (int i = 0; i < 4; ++i) a[i] = ((threadIdx.x * (2 * i + 1)) & 0x007fe000u) | 0x3f800000u;
  const uint32_t b0 = a[0] ^ 0x2000u, b1 = a[1] ^ 0x4000u;
  float acc[NACC][4];
  for (int j = 0; j < NACC; ++j)
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) mma_tf32(acc[j], a, b0, b1);
  }
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.0f;
  for (int j = 0; j < NACC; ++j)
    for (int e = 0; e < 4; ++e) s += acc[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
  if (threadIdx.x == 0) clocks[blockIdx.x] = t1 - t0;
}
extern "C" int run(int nacc, int blocks, int threads, int iters, float* out, long long* clocks) {
  switch (nacc) {
    case 1: probe<1><<<blocks, threads>>>(out, clocks, iters); break;
    case 2: probe<2><<<blocks, threads>>>(out, clocks, iters); break;
    case 4: probe<4><<<blocks, threads>>>(out, clocks, iters); break;
    case 8: probe<8><<<blocks, threads>>>(out, clocks, iters); break;
    default: probe<16><<<blocks, threads>>>(out, clocks, iters); break;
  }
  return (int)cudaGetLastError();
}
"""


def scan_k1(cs) -> None:
    from det_sam2_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
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


def scan_mma(cs) -> None:
    from det_sam2_tpu_torch.ops.attention import _nvcc

    out_dir = Path(__file__).resolve().parent / "build" / "kernel_scan"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "mma_probe.cu").write_text(MMA_PROBE)
    subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(out_dir / "mma_probe.so"),
                    str(out_dir / "mma_probe.cu")], check=True)
    lib = ctypes.CDLL(str(out_dir / "mma_probe.so"))
    lib.run.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p, ctypes.c_void_p]
    lib.run.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(sms * 512, device="cuda")
    clocks = torch.empty(sms, dtype=torch.int64, device="cuda")
    for warps in (4, 8, 16):
        for nacc in (1, 2, 4, 8, 16):
            iters = 16384 // nacc
            args = (nacc, sms, 32 * warps, iters, out.data_ptr(), clocks.data_ptr())
            if lib.run(*args):
                raise RuntimeError("mma probe launch failed")
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            lib.run(*args)
            end.record()
            torch.cuda.synchronize()
            clk = float(clocks.max()) / (iters * nacc * warps / 4)
            flops = sms * warps * iters * nacc * 2 * 16 * 8 * 8
            cs.log(f"[mma] warps/SM {warps:2d}, chains/warp {nacc:2d}: {clk:6.2f} clocks an "
                   f"mma an SMSP, {flops / start.elapsed_time(end) / 1e9:6.1f} TFLOP/s TF32")


def main(argv) -> int:
    if argv[1:] not in ([], ["mma"]):
        print("usage: python3 kernel_scan.py [mma]", flush=True)
        return 2
    if not torch.cuda.is_available():
        print("kernel_scan: no CUDA device; nothing was run", flush=True)
        return 2
    import chip_smoke as cs

    cs.log(cs.gpu_line())
    if argv[1:] == ["mma"]:
        scan_mma(cs)
    else:
        scan_k1(cs)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
