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
// Design: one block (4 warps) per BQ query rows (64, or 32 when D and Dv are
// so wide that shared memory would not hold 64) keeps Q, dO and the dq
// accumulator in shared memory and loops over 32-key tiles itself, in place
// of the TPU kernel's sequential grid axis. No atomics: each block owns its
// dq rows, so the result is the same from run to run. Products are fp32 FMAs
// on the CUDA cores from shared memory in register micro-tiles
// (flash_common.cuh: mm_nt, mm_nn_acc), for bf16 inputs too.
//
// What bounds it on the H100: 2 * Nq * Nk * (2 D + Dv) FLOPs over the live
// keys on a few MB of input, so operations; at fp32 CUDA-core rates (67
// TFLOP/s peak) this simple kernel is far from the bf16 tensor-core bound.
// Tensor-core products (mma/wgmma) and a pipelined K/V ring are later work;
// PERF.md has its time beside the bound.
#include "flash_common.cuh"

namespace {

using flash::bf16;
constexpr int kBK = 32;  // keys per tile

__host__ size_t smem_bytes(int bq, int d, int dv) {
  const int ldk = flash::ld_f32(d), ldv = flash::ld_f32(dv);
  const size_t floats = (size_t)bq * (2 * ldk + ldv) + (size_t)kBK * (ldk + ldv) +
                        (size_t)bq * (kBK + 4) + 2 * bq + kBK;
  return floats * sizeof(float) + 16;
}

template <typename T, int BQ>
__global__ void __launch_bounds__(flash::kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ bias, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int nq, int nk, int d, int dv, float scale, int fault) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int RM = BQ / 16, LDS = kBK + 4;
  const int ldk = flash::ld_f32(d), ldv = flash::ld_f32(dv);
  const int dpad = flash::round_up(d, 32), dvpad = flash::round_up(dv, 32);
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sdO = sQ + BQ * ldk;
  float* sdQ = sdO + BQ * ldv;
  float* sK = sdQ + BQ * ldk;
  float* sV = sK + kBK * ldk;
  float* sdS = sV + kBK * ldv;
  float* sLse = sdS + BQ * LDS;
  float* sDelta = sLse + BQ;
  float* sBias = sDelta + BQ;
  int* sFlag = reinterpret_cast<int*>(sBias + kBK);

  const size_t bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int nvalid_q = min(BQ, nq - q0);
  const size_t row0 = bh * nq + q0;
  flash::stage_f32<T>(sQ, ldk, q + row0 * d, d, nvalid_q, BQ, d, dpad);
  flash::stage_f32<float>(sdO, ldv, dout + row0 * dv, dv, nvalid_q, BQ, dv, dvpad);
  for (int i = threadIdx.x; i < BQ * ldk; i += flash::kThreads) sdQ[i] = 0.0f;
  for (int r = threadIdx.x; r < BQ; r += flash::kThreads) {
    sLse[r] = r < nvalid_q ? lse[row0 + r] : flash::kDeadLse;
    sDelta[r] = r < nvalid_q && fault != flash::kFaultNoDelta ? delta[row0 + r] : 0.0f;
  }
  const T* kb = k + bh * nk * d;
  const T* vb = v + bh * nk * dv;
  const float* bb = bias != nullptr ? bias + bh * nk : nullptr;
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;

  const int ntiles = (nk + kBK - 1) / kBK;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * kBK;
    if (!flash::bias_tile_live(bb, k0, kBK, nk, sBias, sFlag)) continue;
    const int nvalid_k = min(kBK, nk - k0);
    flash::stage_f32<T>(sK, ldk, kb + (size_t)k0 * d, d, nvalid_k, kBK, d, dpad);
    flash::stage_f32<T>(sV, ldv, vb + (size_t)k0 * dv, dv, nvalid_k, kBK, dv, dvpad);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this thread's rows x keys, then dS
    float s[RM][4], dp[RM][4];
    flash::mm_nt<RM, 4>(s, sQ, ldk, sK, ldk, d);
    flash::mm_nt<RM, 4>(dp, sdO, ldv, sV, ldv, dv);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = rg + 16 * i;
      const float l = sLse[r];
      const bool live_row = l > flash::kSkipThreshold || fault == flash::kFaultUnsafeP;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 8 * j;
        const float p = live_row ? expf(s[i][j] * scale + sBias[c] - l) : 0.0f;
        sdS[r * LDS + c] = flash::round_to<T>(p * (dp[i][j] - sDelta[r]));
      }
    }
    __syncthreads();
    // dq += round(dS) K * scale (the TPU kernel scales each tile's product)
    flash::mm_nn_acc<RM>(sdQ, ldk, sdS, LDS, sK, ldk, kBK, dpad, scale);
  }
  __syncthreads();
  T* out = dq + row0 * d;
  for (int i = threadIdx.x; i < nvalid_q * d; i += flash::kThreads) {
    const int r = i / d, c = i % d;
    flash::store_elem(out + (size_t)r * d + c, sdQ[r * ldk + c]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias, const float* dout,
           const float* lse, const float* delta, void* dq, int bh, int nq, int nk, int d, int dv,
           float scale, int fault, cudaStream_t st) {
  const T *qq = static_cast<const T*>(q), *kk = static_cast<const T*>(k),
          *vv = static_cast<const T*>(v);
  T* out = static_cast<T*>(dq);
  constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use
  if (smem_bytes(64, d, dv) <= kMaxSmem) {
    const dim3 grid((nq + 63) / 64, bh);
    return flash::launch_kernel(flash_bwd_dq_kernel<T, 64>, grid, smem_bytes(64, d, dv), st,
                                qq, kk, vv, bias, dout, lse, delta, out, nq, nk, d, dv, scale,
                                fault);
  }
  const dim3 grid((nq + 31) / 32, bh);
  return flash::launch_kernel(flash_bwd_dq_kernel<T, 32>, grid, smem_bytes(32, d, dv), st, qq,
                              kk, vv, bias, dout, lse, delta, out, nq, nk, d, dv, scale, fault);
}

}  // namespace

// C entry for ctypes. q, k, v and dq in the element type (dtype: 0 = fp32,
// 1 = bf16); dout, lse, delta and bias fp32; bias may be null. fault: 0, or
// a planted fault of flash_common.cuh (checks only). Returns the CUDA error
// code of the launch (0 = launched).
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
    return launch<bf16>(q, k, v, b, g, l, dl, dq, bh, nq, nk, d, dv, scale, fault, st);
  return launch<float>(q, k, v, b, g, l, dl, dq, bh, nq, nk, d, dv, scale, fault, st);
}
