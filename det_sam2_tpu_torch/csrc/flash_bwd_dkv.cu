// K3b: flash-attention backward, dk and dv, for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel det_sam2_tpu/ops/attention.py:_flash_bwd_dkv_kernel
// (and _flash_bwd_dkv_kernel_nobias), launched there by _flash_bwd_call. With
// the inputs of K3a (flash_bwd_dq.cu) it computes, for each key row,
//   dv = sum over query tiles of P^T dO            (fp32 P and dO, :280)
//   dk = sum over query tiles of round(dS)^T q / sqrt(D)
// with P = exp(q k^T / sqrt(D) + bias - lse) (0 where lse <= -1e29) and
// dS = P * (dO v^T - delta) rounded to q's type (attention.py:289). A key
// tile whose bias is all below -1e29 is skipped (its dk, dv are 0) before
// anything is read; ragged Nq and Nk are masked here.
//
// Design: one block (4 warps) per 32 key rows keeps K, V and the fp32 dk, dv
// accumulators in shared memory and loops over query tiles of 64 rows (32
// when D and Dv are so wide that shared memory would not hold 64), in place
// of the TPU kernel's sequential grid axis. dk and dv have their own widths
// (D and Dv differ in memory cross-attention). No atomics: each block owns
// its key rows, so the result is the same from run to run. fp32 FMAs on the
// CUDA cores from shared memory in register micro-tiles, for bf16 too.
//
// What bounds it on the H100: 2 * Nq * Nk * (2 D + 2 Dv) FLOPs over the live
// keys on a few MB, so operations; this simple kernel runs at CUDA-core fp32
// rates, far from the bf16 tensor-core bound (PERF.md has the numbers).
#include "flash_common.cuh"

namespace {

using flash::bf16;
constexpr int kBKV = 32;  // keys per block

__host__ size_t smem_bytes(int bq, int d, int dv) {
  const int ldk = flash::ld_f32(d), ldv = flash::ld_f32(dv);
  const size_t floats = (size_t)kBKV * (2 * ldk + 2 * ldv) + (size_t)bq * (ldk + ldv) +
                        2 * (size_t)kBKV * (bq + 4) + 2 * bq + kBKV;
  return floats * sizeof(float) + 16;
}

template <typename T, int BQ>
__global__ void __launch_bounds__(flash::kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ bias, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dvo, int nq, int nk, int d, int dv,
                     float scale, int fault) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int CN = BQ / 8, LDP = BQ + 4;
  const int ldk = flash::ld_f32(d), ldv = flash::ld_f32(dv);
  const int dpad = flash::round_up(d, 32), dvpad = flash::round_up(dv, 32);
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + kBKV * ldk;
  float* sdK = sV + kBKV * ldv;
  float* sdV = sdK + kBKV * ldk;
  float* sQ = sdV + kBKV * ldv;
  float* sdO = sQ + BQ * ldk;
  float* sP = sdO + BQ * ldv;
  float* sdS = sP + kBKV * LDP;
  float* sLse = sdS + kBKV * LDP;
  float* sDelta = sLse + BQ;
  float* sBias = sDelta + BQ;
  int* sFlag = reinterpret_cast<int*>(sBias + kBKV);

  const size_t bh = blockIdx.y;
  const int ntiles = (nk + kBKV - 1) / kBKV;
  const int k0 = blockIdx.x * kBKV;
  const int nvalid_k = min(kBKV, nk - k0);
  const float* bb = bias != nullptr ? bias + bh * nk : nullptr;
  bool live = flash::bias_tile_live(bb, k0, kBKV, nk, sBias, sFlag);
  if (fault == flash::kFaultSkipTile && blockIdx.x == 1) live = false;
  // planted fault: this tile's dv goes to the next tile's rows
  const int kt_out = fault == flash::kFaultDvWrongTile ? (blockIdx.x + 1) % ntiles : blockIdx.x;
  const int nvalid_out = min(nvalid_k, nk - kt_out * kBKV);
  T* dk_out = dk + (bh * nk + k0) * d;
  T* dv_out = dvo + (bh * nk + (size_t)kt_out * kBKV) * dv;
  if (!live) {  // a dead tile: dk = dv = 0, as the TPU kernel's init leaves them
    for (int i = threadIdx.x; i < nvalid_k * d; i += flash::kThreads)
      flash::store_elem(dk_out + i, 0.0f);
    for (int i = threadIdx.x; i < nvalid_out * dv; i += flash::kThreads)
      flash::store_elem(dv_out + i, 0.0f);
    return;
  }
  flash::stage_f32<T>(sK, ldk, k + (bh * nk + k0) * d, d, nvalid_k, kBKV, d, dpad);
  flash::stage_f32<T>(sV, ldv, v + (bh * nk + k0) * dv, dv, nvalid_k, kBKV, dv, dvpad);
  for (int i = threadIdx.x; i < kBKV * ldk; i += flash::kThreads) sdK[i] = 0.0f;
  for (int i = threadIdx.x; i < kBKV * ldv; i += flash::kThreads) sdV[i] = 0.0f;
  const T* qb = q + bh * nq * d;
  const float* gb = dout + bh * nq * dv;
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;

  for (int q0 = 0; q0 < nq; q0 += BQ) {
    const int nvalid_q = min(BQ, nq - q0);
    __syncthreads();  // the previous tile's readers are done
    flash::stage_f32<T>(sQ, ldk, qb + (size_t)q0 * d, d, nvalid_q, BQ, d, dpad);
    flash::stage_f32<float>(sdO, ldv, gb + (size_t)q0 * dv, dv, nvalid_q, BQ, dv, dvpad);
    for (int r = threadIdx.x; r < BQ; r += flash::kThreads) {
      sLse[r] = r < nvalid_q ? lse[bh * nq + q0 + r] : flash::kDeadLse;
      sDelta[r] = r < nvalid_q ? delta[bh * nq + q0 + r] : 0.0f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this thread's keys x queries
    float s[2][CN], dp[2][CN];
    flash::mm_nt<2, CN>(s, sK, ldk, sQ, ldk, d);
    flash::mm_nt<2, CN>(dp, sV, ldv, sdO, ldv, dv);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = rg + 16 * i;
      const float b = sBias[key];
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int qi = cg + 8 * j;
        const float l = sLse[qi];
        const bool live_row = l > flash::kSkipThreshold || fault == flash::kFaultUnsafeP;
        const float p = live_row ? expf(s[i][j] * scale + b - l) : 0.0f;
        sP[key * LDP + qi] = p;
        sdS[key * LDP + qi] = flash::round_to<T>(p * (dp[i][j] - sDelta[qi]));
      }
    }
    __syncthreads();
    flash::mm_nn_acc<2>(sdV, ldv, sP, LDP, sdO, ldv, BQ, dvpad, 1.0f);
    flash::mm_nn_acc<2>(sdK, ldk, sdS, LDP, sQ, ldk, BQ, dpad, scale);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nvalid_k * d; i += flash::kThreads) {
    const int r = i / d, c = i % d;
    flash::store_elem(dk_out + (size_t)r * d + c, sdK[r * ldk + c]);
  }
  for (int i = threadIdx.x; i < nvalid_out * dv; i += flash::kThreads) {
    const int r = i / dv, c = i % dv;
    flash::store_elem(dv_out + (size_t)r * dv + c, sdV[r * ldv + c]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias, const float* dout,
           const float* lse, const float* delta, void* dk, void* dvo, int bh, int nq, int nk,
           int d, int dv, float scale, int fault, cudaStream_t st) {
  const T *qq = static_cast<const T*>(q), *kk = static_cast<const T*>(k),
          *vv = static_cast<const T*>(v);
  T *gk = static_cast<T*>(dk), *gv = static_cast<T*>(dvo);
  constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block may use
  const dim3 grid((nk + kBKV - 1) / kBKV, bh);
  if (smem_bytes(64, d, dv) <= kMaxSmem)
    return flash::launch_kernel(flash_bwd_dkv_kernel<T, 64>, grid, smem_bytes(64, d, dv), st,
                                qq, kk, vv, bias, dout, lse, delta, gk, gv, nq, nk, d, dv,
                                scale, fault);
  return flash::launch_kernel(flash_bwd_dkv_kernel<T, 32>, grid, smem_bytes(32, d, dv), st, qq,
                              kk, vv, bias, dout, lse, delta, gk, gv, nq, nk, d, dv, scale,
                              fault);
}

}  // namespace

// C entry for ctypes: the arguments of flash_bwd_dq, with dk [BH, Nk, D] and
// dv [BH, Nk, Dv] (element type) in place of dq. Returns the CUDA error code
// of the launch (0 = launched).
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
    return launch<bf16>(q, k, v, b, g, l, dl, dk, dvo, bh, nq, nk, d, dv, scale, fault, st);
  return launch<float>(q, k, v, b, g, l, dl, dk, dvo, bh, nq, nk, d, dv, scale, fault, st);
}
