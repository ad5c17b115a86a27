// K2's pre-pass: the corrected keys of the attended memory tiles, built once
// a launch, for Hopper (sm_90a), CUDA C++.
//
// Part of the port of det_sam2_tpu/ops/attention.py:_flash_banked_kernel:
// the TPU kernel added each tile's temporal-position correction to every K
// block it fetched (:477-488). Here, for each tile t of the slot list and
// each object b,
//   keys[b, t, j] = round(mem_k[slots[t], b, layer, j] + corr_t[j]),   j < S
//   corr_t[j] = [w1*cos_j - w2*sin_j, w1*sin_j + w2*cos_j]   (halves layout)
// with w1, w2 the halves of w[t], in fp32 with each product, sum and
// difference rounded once (no fused multiply-add), so the result equals
// ops/attention.py:banked_keys bit for bit, then rounded once to the
// element type. Rows S..S_pad of each tile, and every row of a tile whose
// slot is outside [0, Ktot), are zeros. K2's main kernel
// (flash_banked_fwd.cu) reads these keys.
//
// What bounds it on the H100: it reads T*B*S*D elements of the bank and the
// [S, D] tables and writes as many keys: bytes (~34 MB each way at the
// serving shape, ~21 us at 3.35 TB/s). 16-byte loads and stores, eight
// channels of each half a thread, one pass.
#include "flash_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
flash_banked_keys_kernel(const T* __restrict__ mem_k, const int* __restrict__ slots,
                         const float* __restrict__ w, const float* __restrict__ cos_t,
                         const float* __restrict__ sin_t, T* __restrict__ keys, int nb, int d,
                         int ktot, int nl, int s, int s_pad, int ntile, int layer) {
  const int t = blockIdx.y, b = blockIdx.z;
  const int half = d / 2, vecs = half / 8;
  const int slot = slots[t];
  const bool ok = slot >= 0 && slot < ktot;
  T* dst = keys + ((size_t)b * ntile + t) * s_pad * d;
  const T* src = mem_k + ((((size_t)(ok ? slot : 0) * nb + b) * nl + layer) * s) * d;
  const float* w1 = w + (size_t)t * d;
  const float* w2 = w1 + half;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < s_pad * vecs;
       i += gridDim.x * blockDim.x) {
    const int r = i / vecs, c = (i % vecs) * 8;
    float k1[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float k2[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (ok && r < s) {
      float cs[8], sn[8], a[8], bb[8];
      flash::load8(src + (size_t)r * d + c, k1);
      flash::load8(src + (size_t)r * d + c + half, k2);
      flash::load8(cos_t + (size_t)r * half + c, cs);
      flash::load8(sin_t + (size_t)r * half + c, sn);
      flash::load8(w1 + c, a);
      flash::load8(w2 + c, bb);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        k1[e] = __fadd_rn(k1[e], __fsub_rn(__fmul_rn(cs[e], a[e]), __fmul_rn(sn[e], bb[e])));
        k2[e] = __fadd_rn(k2[e], __fadd_rn(__fmul_rn(sn[e], a[e]), __fmul_rn(cs[e], bb[e])));
      }
    }
    flash::store8(dst + (size_t)r * d + c, k1);
    flash::store8(dst + (size_t)r * d + c + half, k2);
  }
}

template <typename T>
int launch(const void* mem_k, const int* slots, const float* w, const float* cos_t,
           const float* sin_t, void* keys, int nb, int d, int ktot, int nl, int s, int s_pad,
           int ntile, int layer, cudaStream_t st) {
  const int items = s_pad * (d / 16);
  const dim3 grid((items + 255) / 256, ntile, nb);
  flash_banked_keys_kernel<T><<<grid, 256, 0, st>>>(
      static_cast<const T*>(mem_k), slots, w, cos_t, sin_t, static_cast<T*>(keys), nb, d, ktot,
      nl, s, s_pad, ntile, layer);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry for ctypes. dtype: 0 = fp32, 1 = bf16 (mem_k and keys); slots
// int32 [T]; w fp32 [T, D]; cos / sin fp32 [S, D/2]; keys [B, T, S_pad, D];
// D a multiple of 16. Returns the CUDA error code of the launch (0 =
// launched).
extern "C" int flash_banked_keys(const void* mem_k, const void* slots, const void* w,
                                 const void* cos_t, const void* sin_t, void* keys, int nb, int d,
                                 int ktot, int nl, int s, int s_pad, int ntile, int layer,
                                 int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slots);
  const float *ww = static_cast<const float*>(w), *co = static_cast<const float*>(cos_t),
              *si = static_cast<const float*>(sin_t);
  if (dtype == 1)
    return launch<flash::bf16>(mem_k, sl, ww, co, si, keys, nb, d, ktot, nl, s, s_pad, ntile,
                               layer, st);
  return launch<float>(mem_k, sl, ww, co, si, keys, nb, d, ktot, nl, s, s_pad, ntile, layer, st);
}
