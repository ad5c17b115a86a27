// LayerNorm over the trailing axis with fp32 statistics, for Hopper
// (sm_90a), CUDA C++.
//
// Replaces no TPU kernel: the JAX package's LayerNorm
// (det_sam2_tpu/modeling/layers.py:173) is plain jnp that XLA fuses into one
// sweep. The port's plain version (modeling/layers.layer_norm_ref) runs as
// about twelve PyTorch launches a call, each a full fp32 pass; this kernel
// computes the same formula in one pass:
//   c = x[0], mean_c = sum(x - c) / C, mean2_c = sum((x - c)^2) / C,
//   var = max(mean2_c - mean_c^2, 0),
//   y = ((x - c) - mean_c) * rsqrt(var + eps) * w + b,
// with the shift c of the plain version (no cancellation when |mean| >>
// std), every step after the sums rounded where the plain version rounds
// (__fsub_rn / __fmul_rn / __fadd_rn are never contracted into an FMA), w
// and b fp32, y in x's type. Only the order of the two sums differs.
//
// What bounds it on the H100: bytes. A bf16 row of C elements is read once
// and written once (4 bytes an element, against ~68 for the plain
// version's passes); at 3.35 TB/s the Hiera-L trunk's 282 M elements a frame
// take ~0.34 ms. The design keeps the row in registers between the read and
// the write:
//   * a row is held by a group of G lanes of one warp (G = 1 to 32, a power
//     of two), each lane holding up to N vectors of VEC elements (16 bytes
//     where C allows), vector k of the row in lane k % G, slot k / G: a
//     warp's load of slot j covers G consecutive vectors of each of its
//     32 / G rows. The wrapper (ops/layer_norm.plan) picks VEC, G and N from
//     C, so few lanes idle (C = 144: G = 4, N = 5) and narrow rows pack many
//     to a warp (C = 4, 16: a row a lane or two);
//   * the shift c is broadcast from the group's first lane, the two sums
//     are reduced by xor shuffles inside the group;
//   * blocks stride over the rows (a grid of at most four waves of the
//     blocks the SMs hold at once), so w and b are read once a block, into
//     shared memory;
//   * nothing else touches device memory: no scratch, no second pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

// planted faults, for the checks that must catch them; production passes 0
constexpr int kFaultUnshifted = 1;  // statistics of x itself: E[x^2] - E[x]^2
constexpr int kFaultLastVector = 2;  // the row's last vector never read
constexpr int kFaultSwapWB = 3;  // w and b swapped

constexpr int kThreads = 256;  // a block: 8 warps
// the grid: at most kWaves times the blocks the SMs hold at once. On an
// H100 (bf16, 0.26-17 M rows) four waves read 0.77-0.85 of the bytes bound
// where one read 0.72-0.81: fewer rows a block loop leave a shorter tail,
// while an uncapped grid pays w and b and a block's start for every few
// rows (0.59 at C = 4, 17 M rows)
constexpr int kWaves = 4;
constexpr int kLaneElems = 48;  // the most elements a lane holds (registers)
constexpr int kMaxC = 32 * kLaneElems;

typedef uint16_t bf16_bits;  // a bf16 element as its raw bits

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16_bits v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
template <typename S> __device__ __forceinline__ S from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16_bits from_float<bf16_bits>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// VEC elements in one aligned access (16 bytes where C allows)
template <typename S, int VEC>
struct alignas(sizeof(S) * VEC) Pack {
  S e[VEC];
};

template <typename S, int VEC, int N>
__global__ void __launch_bounds__(kThreads)
    layer_norm_kernel(const S* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, S* __restrict__ y, long long rows, int c,
                      int g, float eps, int fault) {
  extern __shared__ float sh[];  // w [c], then b [c]
  for (int i = threadIdx.x; i < c; i += kThreads) {
    sh[i] = fault == kFaultSwapWB ? b[i] : w[i];
    sh[c + i] = fault == kFaultSwapWB ? w[i] : b[i];
  }
  __syncthreads();
  typedef Pack<S, VEC> P;
  const int nv = c / VEC;
  const int lane = threadIdx.x & 31;
  const int sub = lane & (g - 1);  // this lane's place in its row's group
  const int lead = lane - sub;  // the group's first lane
  const int rows_warp = 32 / g;
  const long long rows_block = kThreads / g;
  const float inv_c = 1.0f / static_cast<float>(c);
  // warp-uniform: every lane of a warp runs the same iterations, so each
  // shuffle sees all 32 lanes; a lane past the last row loads nothing
  for (long long r0 = blockIdx.x * rows_block + (threadIdx.x >> 5) * rows_warp; r0 < rows;
       r0 += gridDim.x * rows_block) {
    const long long row = r0 + lane / g;
    const bool live = row < rows;
    const P* xr = reinterpret_cast<const P*>(x + (live ? row : 0) * c);
    float v[N][VEC];
    bool in[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int k = j * g + sub;
      in[j] = live && k < nv;
      const bool read = in[j] && !(fault == kFaultLastVector && k == nv - 1);
      P p;
      if (read) p = xr[k];
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[j][e] = read ? to_float(p.e[e]) : 0.0f;
    }
    const float shift = fault == kFaultUnshifted ? 0.0f : __shfl_sync(0xffffffffu, v[0][0], lead);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = __fsub_rn(v[j][e], shift);
        v[j][e] = d;
        if (in[j]) {
          s1 += d;
          s2 = fmaf(d, d, s2);
        }
      }
    }
    for (int off = g >> 1; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mean = __fmul_rn(s1, inv_c);
    const float mean2 = __fmul_rn(s2, inv_c);
    const float var = fmaxf(__fsub_rn(mean2, __fmul_rn(mean, mean)), 0.0f);
    const float rstd = rsqrtf(__fadd_rn(var, eps));
    P* yr = reinterpret_cast<P*>(y + (live ? row : 0) * c);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (!in[j]) continue;
      const int k = j * g + sub;
      const float* wk = sh + k * VEC;
      const float* bk = sh + c + k * VEC;
      P p;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float t = __fmul_rn(__fsub_rn(v[j][e], mean), rstd);
        p.e[e] = from_float<S>(__fadd_rn(__fmul_rn(t, wk[e]), bk[e]));
      }
      yr[k] = p;
    }
  }
}

struct Args {
  const void* x;
  const float* w;
  const float* b;
  void* y;
  long long rows;
  int c, g, sms;
  float eps;
  int fault;
  cudaStream_t stream;
};

template <typename S, int VEC, int N>
int run(const Args& a) {
  auto kernel = layer_norm_kernel<S, VEC, N>;
  const size_t smem = 2 * sizeof(float) * a.c;
  static int per_sm = 0;  // blocks an SM holds at once: the kernel's registers decide
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kThreads, 2 * sizeof(float) * kMaxC);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) per_sm = 1;
  }
  const long long rows_block = kThreads / a.g;
  const long long need = (a.rows + rows_block - 1) / rows_block;
  const long long most = (long long)a.sms * per_sm * kWaves;
  const unsigned grid = (unsigned)(need < most ? need : most);
  kernel<<<grid, kThreads, smem, a.stream>>>(static_cast<const S*>(a.x), a.w, a.b,
                                             static_cast<S*>(a.y), a.rows, a.c, a.g, a.eps,
                                             a.fault);
  return (int)cudaGetLastError();
}

// the instance of N slots a lane, among Ns
template <typename S, int VEC, int... Ns>
int run_n(int n, const Args& a) {
  int err = (int)cudaErrorInvalidValue;
  ((n == Ns ? (err = run<S, VEC, Ns>(a), true) : false) || ...);
  return err;
}

// 16-byte vectors (the port's widths): every N up to kLaneElems / VEC, so a
// lane holds no register it does not use; narrower vectors (C not a multiple
// of 16 bytes' elements): one slot (C = 4 in bf16: a row a lane) or the
// most, the unused ones never loaded
template <typename S>
int run_vec(int vec, int n, const Args& a) {
  if constexpr (sizeof(S) == 2) {
    switch (vec) {
      case 8: return run_n<S, 8, 1, 2, 3, 4, 5, 6>(n, a);
      case 4: return run_n<S, 4, 1, 12>(n, a);
      case 2: return run_n<S, 2, 1, 24>(n, a);
      case 1: return run_n<S, 1, 1, 48>(n, a);
    }
  } else {
    switch (vec) {
      case 4: return run_n<S, 4, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12>(n, a);
      case 2: return run_n<S, 2, 1, 24>(n, a);
      case 1: return run_n<S, 1, 1, 48>(n, a);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x [rows, c] (dtype 1: bf16, 0: fp32) -> y of the same type and shape, both
// contiguous and 16-byte aligned; w, b fp32 [c]. vec, g, n: the wrapper's
// plan (c % vec == 0, vec * sizeof <= 16, g a power of two <= 32, g * n * vec
// >= c). sms: the card's SM count. Returns a CUDA error code, 0 on success.
extern "C" int layer_norm(const void* x, const void* w, const void* b, void* y, long long rows,
                          int c, int vec, int g, int n, int dtype, float eps, int sms,
                          int fault, void* stream) {
  const int size = dtype == 1 ? 2 : 4;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0 &&
      ((reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(b)) & 3) == 0;
  if (!aligned || (dtype != 0 && dtype != 1) || rows < 1 || c < 1 || c > kMaxC || vec < 1 ||
      vec * size > 16 || c % vec || g < 1 || g > 32 || (g & (g - 1)) || n < 1 ||
      n * vec > kLaneElems || (long long)g * n * vec < c || sms < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{x, static_cast<const float*>(w), static_cast<const float*>(b), y, rows, c, g,
               sms, eps, fault, static_cast<cudaStream_t>(stream)};
  return dtype == 1 ? run_vec<bf16_bits>(vec, n, a) : run_vec<float>(vec, n, a);
}
