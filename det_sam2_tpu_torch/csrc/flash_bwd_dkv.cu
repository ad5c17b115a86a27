// K3b: flash-attention backward, dk and dv, for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel det_sam2_tpu/ops/attention.py:_flash_bwd_dkv_kernel
// (and _flash_bwd_dkv_kernel_nobias), launched there by _flash_bwd_call. With
// the inputs of K3a (flash_bwd_dq.cu) it computes, for each key row,
//   dv = sum over query tiles of P^T dO            (fp32 P and dO, :280)
//   dk = sum over query tiles of round(dS)^T q / sqrt(D)
// with P = exp(q k^T / sqrt(D) + bias - lse) (0 where lse <= -1e29) and
// dS = P * (dO v^T - delta) rounded to q's type (attention.py:289). A block
// of keys whose bias is all below -1e29 is skipped (its dk, dv are 0)
// before anything is read; ragged Nq and Nk are masked here.
//
// What bounds it on the H100: 2 Nq Nk (2 D + 2 Dv) FLOPs over the live keys
// on a few MB, so operations; as 3xTF32 on the tensor cores the bound is 3 x
// FLOPs / 495 TFLOP/s (exact fp32 on the CUDA cores: FLOPs / 67 TFLOP/s).
//
// Design (flash_common.cuh: flash_bwd_body): a block of eight warps keeps
// the K and V of 64 key rows (32 at D = Dv = 256) in shared memory and loops
// over the query tiles itself, in place of the TPU kernel's sequential grid
// axis; Q and dO tiles stream through a 2-4-stage cp.async ring. S^T = K
// Q^T, dP^T = V dO^T, dk += dS^T Q and dv += P^T dO are mma.sync m16n8k8
// TF32 products in the 3xTF32 split, in loops whose shapes are
// compile-time; dk and dv stay in registers (the warps of a row group each
// hold a share of their columns and take that share of S's and dP's
// contraction) and are written once. dk and dv have their own widths (D and
// Dv differ in memory cross-attention). No atomics: each block owns its key
// rows, so the result is the same from run to run.
#include "flash_common.cuh"

namespace {

template <typename T, int DMAX, int DVMAX, int BT>
__global__ void __launch_bounds__(flash::kBwdThreads, flash::bwd_min_blocks(DMAX, DVMAX))
flash_bwd_dkv_kernel(const flash::BwdParams<T> p) {
  flash::flash_bwd_body<T, true, DMAX, DVMAX, BT>(p);
}

template <typename T>
struct Launch {
  flash::BwdParams<T> p;
  int bh;
  cudaStream_t st;
  template <int DMAX, int DVMAX>
  int run() const {
    constexpr int BT = flash::bwd_tile(DMAX, DVMAX);
    flash::BwdParams<T> args = p;
    args.stages = flash::bwd_stages(DMAX, DVMAX, BT, 0, flash::bwd_min_blocks(DMAX, DVMAX) > 1);
    if (args.stages == 0) return flash::kErrSmem;
    constexpr int BR = flash::bwd_rows(DMAX, DVMAX);
    const dim3 grid((p.nk + BR - 1) / BR, bh);
    return flash::launch_kernel_n(flash_bwd_dkv_kernel<T, DMAX, DVMAX, BT>, grid,
                                  flash::kBwdThreads,
                                  flash::bwd_smem_bytes(DMAX, DVMAX, BT, args.stages, 0), st, args);
  }
};

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias, const float* dout,
           const float* lse, const float* delta, void* dk, void* dvo, int bh, int nq, int nk,
           int d, int dv, float scale, int fault, cudaStream_t st) {
  flash::BwdParams<T> p{static_cast<const T*>(q), static_cast<const T*>(k),
                        static_cast<const T*>(v), bias, dout, lse, delta, nullptr,
                        static_cast<T*>(dk), static_cast<T*>(dvo), nq, nk, d, dv, scale, fault, 0};
  return flash::dispatch_bwd(d, dv, Launch<T>{p, bh, st});
}

}  // namespace

// C entry for ctypes: the arguments of flash_bwd_dq, with dk [BH, Nk, D] and
// dv [BH, Nk, Dv] (element type) in place of dq. Returns the CUDA error code
// of the launch (0 = launched) or flash_common.cuh's kErrSmem.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* bias,
                             const void* dout, const void* lse, const void* delta, void* dk,
                             void* dvo, int bh, int nq, int nk, int d, int dv, int dtype,
                             float scale, int fault, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* g = static_cast<const float*>(dout);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 1)
    return launch<flash::bf16>(q, k, v, b, g, l, dl, dk, dvo, bh, nq, nk, d, dv, scale, fault,
                               st);
  return launch<float>(q, k, v, b, g, l, dl, dk, dvo, bh, nq, nk, d, dv, scale, fault, st);
}
