// K2: bank-indirect memory cross-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel det_sam2_tpu/ops/attention.py:_flash_banked_kernel,
// launched there by _flash_banked_call. Single-head attention of
// q [B, Nq, D] over T memory tiles of S keys each, read straight from the
// memory bank: tile t is bank row slots[t], its keys are
//   k = mem_k[slots[t], b, layer] + corr_t,
//   corr_t[j] = [w1*cos_j - w2*sin_j, w1*sin_j + w2*cos_j]   (halves layout),
// with w1, w2 the two halves of w[t] (the temporal-position term of that
// tile, rotated by the same RoPE tables as the cached keys), and its values
// are mem_v[slots[t], b]. The correction is computed in fp32 and added to the
// cached K before it is rounded to the input type and multiplied. The bias
// [B, T*S] (0 / -1e30) skips dead key tiles; an object with no live key gets
// zeros. No lse, no backward: inference only, as on the TPU.
//
// What bounds it on the H100: at the slice (Nq = 4096, T = 8 tiles of
// S = 4096 keys, D = 256, Cm = 64) it does 2 * Nq * T*S * (D + Cm) FLOPs per
// object, ~86 GFLOP, over ~20 MB of bank rows: compute bound. The design
// reads each bank row once per 64-row query tile with no gathered copy of
// K/V in device memory, applies the RoPE correction while the K tile is
// staged into shared memory, and runs both products on the tensor cores for
// bf16 (mma.sync, fp32 accumulate, register-resident scores and output; see
// flash_common.cuh). No wgmma/TMA pipeline yet; see PERF.md.
#include "flash_common.cuh"

namespace {

using flash::bf16;
using flash::TileK;

template <typename T>
struct BankSrc {
  const T* mem_k;      // [Ktot, B, L, S, D]
  const T* mem_v;      // [Ktot, B, S, Cm]
  const int* slots;    // [T]
  const float* w;      // [T, D]
  const float* bias;   // this object's [T*S]
  const float* cos_t;  // [S, D/2]
  const float* sin_t;  // [S, D/2]
  int b, nb, nl, layer, s, d, cm, ktot, ntile, tiles_per_row;

  __device__ int num_tiles() const { return ntile * tiles_per_row; }

  __device__ void load_bias(int tile, float* dst) const {
    constexpr int BK = TileK<T>::value;
    const int t = tile / tiles_per_row, j0 = (tile % tiles_per_row) * BK;
    const int slot = slots[t];
    // an out-of-range slot reads as a dead tile instead of out of bounds
    const bool ok = slot >= 0 && slot < ktot;
    for (int c = threadIdx.x; c < BK; c += flash::kThreads) {
      const int j = j0 + c;
      dst[c] = (ok && j < s) ? bias[(size_t)t * s + j] : -INFINITY;
    }
  }

  // K rows of bank row slots[t] plus the tile's RoPE correction, 8 channels
  // of each half per step (16-byte loads of K, 32-byte loads of the tables)
  __device__ void load_kv(int tile, T* sk, int ldk, int dp, T* sv, int ldv, int dvp) const {
    constexpr int BK = TileK<T>::value;
    const int t = tile / tiles_per_row, j0 = (tile % tiles_per_row) * BK;
    const int nvalid = min(BK, s - j0);
    const size_t slot = (size_t)slots[t];
    const T* krow = mem_k + (((slot * nb + b) * nl + layer) * s + j0) * d;
    const T* vrow = mem_v + ((slot * nb + b) * s + j0) * cm;
    const int half = d / 2, vecs = half / 8;
    const float* w1 = w + (size_t)t * d;
    const float* w2 = w1 + half;
    for (int i = threadIdx.x; i < BK * vecs; i += flash::kThreads) {
      const int r = i / vecs, c = (i % vecs) * 8;
      float k1[8] = {}, k2[8] = {};
      if (r < nvalid) {
        float cs[8], sn[8], a[8], bb[8];
        flash::load8(krow + (size_t)r * d + c, k1);
        flash::load8(krow + (size_t)r * d + c + half, k2);
        flash::load8(cos_t + (size_t)(j0 + r) * half + c, cs);
        flash::load8(sin_t + (size_t)(j0 + r) * half + c, sn);
        flash::load8(w1 + c, a);
        flash::load8(w2 + c, bb);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          k1[e] += a[e] * cs[e] - bb[e] * sn[e];
          k2[e] += a[e] * sn[e] + bb[e] * cs[e];
        }
      }
      flash::store8(sk + (size_t)r * ldk + c, k1);
      flash::store8(sk + (size_t)r * ldk + c + half, k2);
    }
    const int padc = dp - d;
    for (int i = threadIdx.x; i < BK * padc; i += flash::kThreads)
      sk[(size_t)(i / padc) * ldk + d + i % padc] = T(0.0f);
    flash::load_rows<T>(sv, ldv, vrow, cm, nvalid, BK, cm, dvp);
  }
};

template <typename T>
__device__ inline BankSrc<T> bank_src(const T* mem_k, const T* mem_v, const int* slots,
                                      const float* w, const float* bias, const float* cos_t,
                                      const float* sin_t, int nb, int d, int cm, int ktot,
                                      int nl, int s, int ntile, int layer) {
  BankSrc<T> src;
  src.mem_k = mem_k;
  src.mem_v = mem_v;
  src.slots = slots;
  src.w = w;
  src.b = blockIdx.y;
  src.bias = bias + (size_t)blockIdx.y * ntile * s;
  src.cos_t = cos_t;
  src.sin_t = sin_t;
  src.nb = nb;
  src.nl = nl;
  src.layer = layer;
  src.s = s;
  src.d = d;
  src.cm = cm;
  src.ktot = ktot;
  src.ntile = ntile;
  src.tiles_per_row = (s + TileK<T>::value - 1) / TileK<T>::value;
  return src;
}

#define BANK_PARAMS(T)                                                                        \
  const T *__restrict__ q, const T *__restrict__ mem_k, const T *__restrict__ mem_v,          \
      const int *__restrict__ slots, const float *__restrict__ w,                             \
      const float *__restrict__ bias, const float *__restrict__ cos_t,                        \
      const float *__restrict__ sin_t, T *__restrict__ out, int nb, int nq, int d, int cm,    \
      int ktot, int nl, int s, int ntile, int layer, float scale

template <int DVMAX>
__global__ void __launch_bounds__(flash::kThreads) flash_banked_bf16(BANK_PARAMS(bf16)) {
  flash::flash_body_bf16<DVMAX>(
      bank_src(mem_k, mem_v, slots, w, bias, cos_t, sin_t, nb, d, cm, ktot, nl, s, ntile, layer),
      q, out, nullptr, nq, d, cm, scale, true);
}

__global__ void __launch_bounds__(flash::kThreads) flash_banked_f32(BANK_PARAMS(float)) {
  flash::flash_body_f32(
      bank_src(mem_k, mem_v, slots, w, bias, cos_t, sin_t, nb, d, cm, ktot, nl, s, ntile, layer),
      q, out, nullptr, nq, d, cm, scale, true);
}

}  // namespace

// C entry for ctypes. dtype: 0 = fp32, 1 = bf16 (q, mem_k, mem_v and out);
// slots int32, w / bias / cos / sin fp32; D a multiple of 16. Returns the
// launch's CUDA error code.
extern "C" int flash_banked_fwd(const void* q, const void* mem_k, const void* mem_v,
                                const void* slots, const void* w, const void* bias,
                                const void* cos_t, const void* sin_t, void* out, int nb, int nq,
                                int d, int cm, int ktot, int nl, int s, int ntile, int layer,
                                int dtype, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((nq + flash::kBQ - 1) / flash::kBQ, nb);
  const int* sl = static_cast<const int*>(slots);
  const float *ww = static_cast<const float*>(w), *bi = static_cast<const float*>(bias),
              *co = static_cast<const float*>(cos_t), *si = static_cast<const float*>(sin_t);
  if (dtype == 1) {
    const bf16 *qq = static_cast<const bf16*>(q), *mk = static_cast<const bf16*>(mem_k),
               *mv = static_cast<const bf16*>(mem_v);
    bf16* oo = static_cast<bf16*>(out);
    const size_t smem = flash::smem_bytes_bf16(d, cm);
    const int cmp = flash::round_up(cm, 16);
    if (cmp <= 64)
      return flash::launch_kernel(flash_banked_bf16<64>, grid, smem, st, qq, mk, mv, sl, ww, bi,
                                  co, si, oo, nb, nq, d, cm, ktot, nl, s, ntile, layer, scale);
    if (cmp <= 128)
      return flash::launch_kernel(flash_banked_bf16<128>, grid, smem, st, qq, mk, mv, sl, ww, bi,
                                  co, si, oo, nb, nq, d, cm, ktot, nl, s, ntile, layer, scale);
    return flash::launch_kernel(flash_banked_bf16<256>, grid, smem, st, qq, mk, mv, sl, ww, bi,
                                co, si, oo, nb, nq, d, cm, ktot, nl, s, ntile, layer, scale);
  }
  return flash::launch_kernel(flash_banked_f32, grid, flash::smem_bytes_f32(d, cm), st,
                              static_cast<const float*>(q), static_cast<const float*>(mem_k),
                              static_cast<const float*>(mem_v), sl, ww, bi, co, si,
                              static_cast<float*>(out), nb, nq, d, cm, ktot, nl, s, ntile, layer,
                              scale);
}
