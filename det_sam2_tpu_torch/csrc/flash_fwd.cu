// K1: flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel det_sam2_tpu/ops/attention.py:_flash_kernel (and
// _flash_kernel_nobias), launched there by _flash_call. Computes
//   out = softmax(q k^T / sqrt(D) + bias) v,   lse = logsumexp of the row,
// for q, k [BH, N, D], v [BH, Nk, Dv] (Dv may differ from D), an optional
// fp32 additive key bias [BH, Nk] of 0 / -1e30, bf16 or fp32 inputs with fp32
// accumulation. Key tiles whose bias is all below -1e29 are skipped, and a
// row with no live key comes out as zeros (not NaN).
//
// What bounds it on the H100: at the slice's shapes (Nq = 4096, Nk = 4096 or
// 28736, D = 96 or 256) the two products do ~2 * Nq * Nk * (D + Dv) FLOPs on
// a few MB of input, so it is compute bound (989 TFLOP/s bf16 peak against
// 3.35 TB/s). The design keeps the scores out of device memory (one pass over
// K/V per 64-row query tile) and, for bf16, keeps scores, probabilities and
// the output accumulator in registers around mma.sync tensor-core products
// (flash_common.cuh). It does not yet use wgmma, TMA or a pipelined K/V ring,
// so it reaches a fraction of the peak; see PERF.md for its time beside the
// bound.
#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::TileK;

template <typename T>
struct DenseSrc {
  const T* k;         // this row's [Nk, D]
  const T* v;         // this row's [Nk, Dv]
  const float* bias;  // this row's [Nk] or nullptr
  int nk, d, dv;

  __device__ int num_tiles() const { return (nk + TileK<T>::value - 1) / TileK<T>::value; }

  __device__ void load_bias(int tile, float* dst) const {
    constexpr int BK = TileK<T>::value;
    for (int c = threadIdx.x; c < BK; c += flash::kThreads) {
      const int key = tile * BK + c;
      dst[c] = key < nk ? (bias != nullptr ? bias[key] : 0.0f) : -INFINITY;
    }
  }

  // K rows into sk (row stride ldk, zero-padded to dp columns), V into sv
  __device__ void load_kv(int tile, T* sk, int ldk, int dp, T* sv, int ldv, int dvp) const {
    constexpr int BK = TileK<T>::value;
    const int k0 = tile * BK, nvalid = min(BK, nk - k0);
    flash::load_rows<T>(sk, ldk, k + (size_t)k0 * d, d, nvalid, BK, d, dp);
    flash::load_rows<T>(sv, ldv, v + (size_t)k0 * dv, dv, nvalid, BK, dv, dvp);
  }
};

template <typename T>
__device__ inline DenseSrc<T> dense_src(const T* k, const T* v, const float* bias, int nk,
                                        int d, int dv) {
  const size_t bh = blockIdx.y;
  DenseSrc<T> src;
  src.k = k + bh * nk * d;
  src.v = v + bh * nk * dv;
  src.bias = bias != nullptr ? bias + bh * nk : nullptr;
  src.nk = nk;
  src.d = d;
  src.dv = dv;
  return src;
}

template <int DVMAX>
__global__ void __launch_bounds__(flash::kThreads)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const float* __restrict__ bias, bf16* __restrict__ out, float* __restrict__ lse,
               int nq, int nk, int d, int dv, float scale) {
  flash::flash_body_bf16<DVMAX>(dense_src(k, v, bias, nk, d, dv), q, out, lse, nq, d, dv,
                                scale, bias != nullptr);
}

__global__ void __launch_bounds__(flash::kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              float* __restrict__ out, float* __restrict__ lse, int nq, int nk, int d, int dv,
              float scale) {
  flash::flash_body_f32(dense_src(k, v, bias, nk, d, dv), q, out, lse, nq, d, dv, scale,
                        bias != nullptr);
}

}  // namespace

// C entry for ctypes. dtype: 0 = fp32, 1 = bf16. bias and lse may be null.
// Returns the CUDA error code of the launch (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                         void* out, void* lse, int bh, int nq, int nk, int d, int dv,
                         int dtype, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((nq + flash::kBQ - 1) / flash::kBQ, bh);
  const float* b = static_cast<const float*>(bias);
  float* l = static_cast<float*>(lse);
  if (dtype == 1) {
    const bf16 *qq = static_cast<const bf16*>(q), *kk = static_cast<const bf16*>(k),
               *vv = static_cast<const bf16*>(v);
    bf16* oo = static_cast<bf16*>(out);
    const size_t smem = flash::smem_bytes_bf16(d, dv);
    const int dvp = flash::round_up(dv, 16);
    if (dvp <= 64)
      return flash::launch_kernel(flash_fwd_bf16<64>, grid, smem, st, qq, kk, vv, b, oo, l, nq,
                                  nk, d, dv, scale);
    if (dvp <= 128)
      return flash::launch_kernel(flash_fwd_bf16<128>, grid, smem, st, qq, kk, vv, b, oo, l,
                                  nq, nk, d, dv, scale);
    return flash::launch_kernel(flash_fwd_bf16<256>, grid, smem, st, qq, kk, vv, b, oo, l, nq,
                                nk, d, dv, scale);
  }
  return flash::launch_kernel(flash_fwd_f32, grid, flash::smem_bytes_f32(d, dv), st,
                              static_cast<const float*>(q), static_cast<const float*>(k),
                              static_cast<const float*>(v), b, static_cast<float*>(out), l,
                              nq, nk, d, dv, scale);
}
