// K3a: flash-attention backward, dq, for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel det_sam2_tpu/ops/attention.py:_flash_bwd_dq_kernel
// (and _flash_bwd_dq_kernel_nobias), launched there by _flash_bwd_call. For
// q, k [BH, N, D], v [BH, Nk, Dv], dO [BH, Nq, Dv] fp32, the forward's lse
// and delta = rowsum(dO * O) [BH, Nq] fp32, and an optional additive key bias
// [BH, Nk] fp32, it computes
//   P  = exp(q k^T / sqrt(D) + bias - lse)   (0 where lse <= -1e29: _safe_p)
//   dS = P * (dO v^T - delta)
//   dq = sum over key tiles of round(dS) k / sqrt(D)
// with dS rounded to k's type before the product (attention.py:232), as the
// TPU kernel does. Key tiles whose bias is all below -1e29 are skipped before
// their K/V rows are read; ragged Nq and Nk are masked here (no padding).
//
// What bounds it on the H100: 2 Nq Nk (2 D + Dv) FLOPs over the live keys on
// a few MB of input, so operations. The products are fp32-grade, taken on
// the tensor cores as 3xTF32: three TF32 passes, so the bound is 3 x FLOPs /
// 495 TFLOP/s (the CUDA cores' exact fp32 would be FLOPs / 67 TFLOP/s, 2.5x
// longer).
//
// Design (flash_common.cuh: flash_bwd_body): a block of eight warps keeps
// the Q and dO of 64 query rows (32 at D = Dv = 256) in shared memory and
// loops over the live key tiles itself, in place of the TPU kernel's
// sequential grid axis; K and V tiles stream through a 2-4-stage cp.async
// ring. S = Q K^T, dP = dO V^T and dq += dS K are mma.sync m16n8k8 TF32
// products in the 3xTF32 split, in loops whose shapes are compile-time; dq
// stays in registers (the warps of a row group each hold a share of its
// columns and take that share of S's and dP's contraction) and is written
// once. No atomics: each block owns its dq rows, so the result is the same
// from run to run.
#include "flash_common.cuh"

namespace {

template <typename T, int DMAX, int DVMAX, int BT>
__global__ void __launch_bounds__(flash::kBwdThreads, flash::bwd_min_blocks(DMAX, DVMAX))
flash_bwd_dq_kernel(const flash::BwdParams<T> p) {
  flash::flash_bwd_body<T, false, DMAX, DVMAX, BT>(p);
}

template <typename T>
struct Launch {
  flash::BwdParams<T> p;
  int bh;
  cudaStream_t st;
  template <int DMAX, int DVMAX>
  int run() const {
    constexpr int BT = flash::bwd_tile(DMAX, DVMAX);
    const int nlist = (p.nk + BT - 1) / BT;
    flash::BwdParams<T> args = p;
    args.stages = flash::bwd_stages(DMAX, DVMAX, BT, nlist, flash::bwd_min_blocks(DMAX, DVMAX) > 1);
    if (args.stages == 0) return flash::kErrSmem;
    constexpr int BR = flash::bwd_rows(DMAX, DVMAX);
    const dim3 grid((p.nq + BR - 1) / BR, bh);
    return flash::launch_kernel_n(flash_bwd_dq_kernel<T, DMAX, DVMAX, BT>, grid,
                                  flash::kBwdThreads,
                                  flash::bwd_smem_bytes(DMAX, DVMAX, BT, args.stages, nlist), st,
                                  args);
  }
};

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias, const float* dout,
           const float* lse, const float* delta, void* dq, int bh, int nq, int nk, int d, int dv,
           float scale, int fault, cudaStream_t st) {
  flash::BwdParams<T> p{static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v), bias, dout, lse, delta,
                        static_cast<T*>(dq), nullptr, nullptr, nq, nk, d, dv, scale, fault, 0};
  return flash::dispatch_bwd(d, dv, Launch<T>{p, bh, st});
}

}  // namespace

// C entry for ctypes. q, k, v and dq in the element type (dtype: 0 = fp32,
// 1 = bf16); dout, lse, delta and bias fp32; bias may be null. fault: 0, or
// a planted fault of flash_common.cuh (checks only). Returns the CUDA error
// code of the launch (0 = launched) or flash_common.cuh's kErrSmem.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* bias,
                            const void* dout, const void* lse, const void* delta, void* dq,
                            int bh, int nq, int nk, int d, int dv, int dtype, float scale,
                            int fault, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* g = static_cast<const float*>(dout);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 1)
    return launch<flash::bf16>(q, k, v, b, g, l, dl, dq, bh, nq, nk, d, dv, scale, fault, st);
  return launch<float>(q, k, v, b, g, l, dl, dq, bh, nq, nk, d, dv, scale, fault, st);
}
