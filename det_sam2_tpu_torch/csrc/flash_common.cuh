// Shared core of the two hand-written Hopper flash-attention forward kernels
// (flash_fwd.cu, flash_banked_fwd.cu).
//
// One thread block (four warps) computes one 64-row query tile of one
// (batch * head) row and loops over the key/value tiles itself, in place of
// the TPU kernel's sequential grid axis. A key tile whose additive bias is
// below -1e29 everywhere is skipped before its K/V rows are read; a query row
// that saw no live key (l == 0) is written as zeros. Both ragged edges (Nq,
// Nk) are masked here, so the wrappers never pad.
//
// bf16 (the main path): warp w owns query rows [16w, 16w+16). Q, K and V
// tiles are staged in shared memory (rows padded by 16 bytes, so ldmatrix is
// free of bank conflicts); Q K^T and P V run as mma.sync m16n8k16 bf16 with
// fp32 accumulation; the scores, the probabilities P (re-packed to bf16 A
// fragments straight from the score accumulators), the running max / sum
// and the output accumulator all stay in registers.
// fp32: the same loop with fp32 FMAs on the CUDA cores (no TF32), scores and
// the output accumulator in shared memory: exact to fp32 rounding, slow, and
// not on the main path.
//
// A key-tile source policy (Src) supplies the bias and K/V rows of each tile:
// flash_fwd.cu reads dense [BH, Nk, D] rows, flash_banked_fwd.cu reads memory
// bank rows named by a slot list.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kBQ = 64;          // query rows per block
constexpr int kThreads = 128;    // four warps
constexpr int kBK16 = 64;        // key rows per tile, bf16
constexpr int kBK32 = 32;        // key rows per tile, fp32
constexpr float kNegInit = -1e30f;       // running-max start, as the TPU kernel
constexpr float kSkipThreshold = -1e29f; // a tile whose max bias is below is skipped

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 8 consecutive elements <-> fp32 (16-byte bf16 / 32-byte fp32 accesses)
__device__ inline void load8(const bf16* p, float f[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}
__device__ inline void load8(const float* p, float f[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ inline void store8(bf16* p, const float f[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ inline void store8(float* p, const float f[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// Copy rows [0, nrows) of a row-major [*, ncols] global matrix (row stride
// src_ld elements) into shared memory with row stride dst_ld, 16 bytes per
// access; rows >= nvalid and columns in [ncols, ncols_pad) are zero-filled.
// Requires ncols, ncols_pad, src_ld, dst_ld multiples of 16 / sizeof(T) and a
// 16-byte aligned src.
template <typename T>
__device__ inline void load_rows(T* dst, int dst_ld, const T* src, size_t src_ld,
                                 int nvalid, int nrows, int ncols, int ncols_pad) {
  constexpr int VE = 16 / sizeof(T);
  const int vpr = ncols_pad / VE;
  for (int i = threadIdx.x; i < nrows * vpr; i += kThreads) {
    const int r = i / vpr, c = (i % vpr) * VE;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid && c < ncols) val = *reinterpret_cast<const uint4*>(src + r * src_ld + c);
    *reinterpret_cast<uint4*>(dst + (size_t)r * dst_ld + c) = val;
  }
}

// Reads the tile's bias into dst, then (when has_bias) decides whether any
// key of the tile is live. Called by every thread; returns the same value in
// every thread.
template <typename Src>
__device__ inline bool tile_live(const Src& src, int kt, float* bias, int* flag, int bk,
                                 bool has_bias) {
  __syncthreads();  // the previous tile's readers are done with the buffers
  src.load_bias(kt, bias);
  __syncthreads();
  if (!has_bias) return true;
  if (threadIdx.x < 32) {
    float mx = -INFINITY;
    for (int c = threadIdx.x; c < bk; c += 32) mx = fmaxf(mx, bias[c]);
    mx = warp_max(mx);
    if (threadIdx.x == 0) *flag = mx > kSkipThreshold;
  }
  __syncthreads();
  return *flag != 0;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 with register-resident scores and accumulators
// ---------------------------------------------------------------------------

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ inline void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ inline void ldmatrix_x4_trans(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// c[16x8] += a[16x16] b[16x8], bf16 in, fp32 accumulate
__device__ inline void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// shared-memory row strides (elements) of the bf16 path: +8 elements (16 B)
// so that the 8 rows an ldmatrix reads fall in 8 different bank groups
__host__ __device__ inline int ld_bf16(int width) { return round_up(width, 16) + 8; }

__host__ inline size_t smem_bytes_bf16(int d, int dv) {
  return sizeof(bf16) * ((size_t)(kBQ + kBK16) * ld_bf16(d) + (size_t)kBK16 * ld_bf16(dv))
       + sizeof(float) * kBK16 + 16;
}

// DVMAX: compile-time bound on round_up(Dv, 16) (64, 128 or 256), so the
// output accumulator is a register array.
// q: [BH, Nq, D]; out: [BH, Nq, Dv]; lse: [BH, Nq] fp32 or nullptr.
template <int DVMAX, typename Src>
__device__ inline void flash_body_bf16(const Src& src, const bf16* __restrict__ q,
                                       bf16* __restrict__ out, float* __restrict__ lse,
                                       int nq, int d, int dv, float scale, bool has_bias) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int BK = kBK16;
  const int dp = round_up(d, 16), dvp = round_up(dv, 16);
  const int ldk = ld_bf16(d), ldv = ld_bf16(dv);
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kBQ * ldk;
  bf16* sV = sK + BK * ldk;
  float* sBias = reinterpret_cast<float*>(sV + BK * ldv);
  int* sFlag = reinterpret_cast<int*>(sBias + BK);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int mi = lane / 8, mr = lane % 8;  // ldmatrix: matrix index, row in it
  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int nvalid_q = min(kBQ, nq - q0);

  load_rows<bf16>(sQ, ldk, q + ((size_t)bh * nq + q0) * d, d, nvalid_q, kBQ, d, dp);

  float o[DVMAX / 8][4];
#pragma unroll
  for (int i = 0; i < DVMAX / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.0f;
  float m_run[2] = {kNegInit, kNegInit};  // rows g and g + 8 of the warp's 16
  float l_run[2] = {0.0f, 0.0f};          // this thread's share of the row sums

  const int ntiles = src.num_tiles();
  for (int kt = 0; kt < ntiles; ++kt) {
    if (!tile_live(src, kt, sBias, sFlag, BK, has_bias)) continue;
    src.load_kv(kt, sK, ldk, dp, sV, ldv, dvp);
    __syncthreads();

    // S[16 x 64] = Q K^T for this warp's rows
    float s[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
    for (int k0 = 0; k0 < dp; k0 += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, sQ + (warp * 16 + (lane % 16)) * ldk + k0 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        // K rows are the columns of K^T: the non-transposed ldmatrix of
        // K[keys][k0..k0+16] gives the B fragments of two 8-key n-tiles
        uint32_t b[4];
        ldmatrix_x4(b, sK + (np * 16 + (mi / 2) * 8 + mr) * ldk + k0 + (mi % 2) * 8);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // online softmax on the registers: thread holds rows g (s[.][0..1]) and
    // g + 8 (s[.][2..3]) at key columns nt*8 + 2*t4 + {0, 1}
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float bias = sBias[nt * 8 + 2 * t4 + j];
        s[nt][j] = s[nt][j] * scale + bias;
        s[nt][2 + j] = s[nt][2 + j] * scale + bias;
        mx[0] = fmaxf(mx[0], s[nt][j]);
        mx[1] = fmaxf(mx[1], s[nt][2 + j]);
      }
    }
    float alpha[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nt][j] = expf(s[nt][j] - m_run[0]);
        s[nt][2 + j] = expf(s[nt][2 + j] - m_run[1]);
        rsum[0] += s[nt][j];
        rsum[1] += s[nt][2 + j];
      }
    }
    l_run[0] = l_run[0] * alpha[0] + rsum[0];
    l_run[1] = l_run[1] * alpha[1] + rsum[1];
#pragma unroll
    for (int i = 0; i < DVMAX / 8; ++i) {
      o[i][0] *= alpha[0]; o[i][1] *= alpha[0];
      o[i][2] *= alpha[1]; o[i][3] *= alpha[1];
    }

    // O[16 x Dv] += P V: the score accumulators of two adjacent n-tiles are
    // exactly the A fragment of a 16-key chunk
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
#pragma unroll
      for (int np = 0; np < DVMAX / 16; ++np) {
        if (np * 16 < dvp) {
          // V[keys][cols] is K-major for B: transposed ldmatrix
          uint32_t b[4];
          ldmatrix_x4_trans(b, sV + (kc * 16 + (mi % 2) * 8 + mr) * ldv + np * 16 + (mi / 2) * 8);
          mma_bf16(o[2 * np], pa, b[0], b[1]);
          mma_bf16(o[2 * np + 1], pa, b[2], b[3]);
        }
      }
    }
  }

  // finalize: full row sums across the quad, then out = O / l (0 if l == 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = warp * 16 + g + 8 * r;
    if (row >= nvalid_q) continue;
    const float inv = l_run[r] > 0.0f ? 1.0f / l_run[r] : 0.0f;
    bf16* orow = out + ((size_t)bh * nq + q0 + row) * dv;
#pragma unroll
    for (int nt = 0; nt < DVMAX / 8; ++nt) {
      const int col = nt * 8 + 2 * t4;
      if (col < dv)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[nt][2 * r] * inv, o[nt][2 * r + 1] * inv);
    }
    if (lse != nullptr && t4 == 0)
      lse[(size_t)bh * nq + q0 + row] = m_run[r] + logf(fmaxf(l_run[r], 1e-20f));
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core FMAs, scores and accumulator in shared memory
// ---------------------------------------------------------------------------

__host__ inline size_t smem_bytes_f32(int d, int dv) {
  const int dp = round_up(d, 16), dvp = round_up(dv, 16);
  return sizeof(float) * ((size_t)kBQ * dp + (size_t)kBK32 * dp + (size_t)kBK32 * dvp
                          + (size_t)kBQ * kBK32 + (size_t)kBQ * dvp + 3 * kBQ + kBK32) + 16;
}

template <typename Src>
__device__ inline void flash_body_f32(const Src& src, const float* __restrict__ q,
                                      float* __restrict__ out, float* __restrict__ lse,
                                      int nq, int d, int dv, float scale, bool has_bias) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int BK = kBK32;
  static_assert(kBQ == 64 && BK == 32 && kThreads == 128, "fp32 micro-tiling");
  const int dp = round_up(d, 16), dvp = round_up(dv, 16);
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + kBQ * dp;
  float* sV = sK + BK * dp;
  float* sS = sV + BK * dvp;   // scores, then probabilities
  float* sO = sS + kBQ * BK;
  float* sM = sO + kBQ * dvp;
  float* sL = sM + kBQ;
  float* sAlpha = sL + kBQ;
  float* sBias = sAlpha + kBQ;
  int* sFlag = reinterpret_cast<int*>(sBias + BK);
  const int bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const int nvalid_q = min(kBQ, nq - q0);

  load_rows<float>(sQ, dp, q + ((size_t)bh * nq + q0) * d, d, nvalid_q, kBQ, d, dp);
  for (int i = threadIdx.x; i < kBQ * dvp; i += kThreads) sO[i] = 0.0f;
  for (int i = threadIdx.x; i < kBQ; i += kThreads) { sM[i] = kNegInit; sL[i] = 0.0f; }

  const int ntiles = src.num_tiles();
  for (int kt = 0; kt < ntiles; ++kt) {
    if (!tile_live(src, kt, sBias, sFlag, BK, has_bias)) continue;
    src.load_kv(kt, sK, dp, dp, sV, dvp, dvp);
    __syncthreads();
    {  // S = Q K^T: 128 threads as a 16 x 8 grid of 4 x 4 micro-tiles
      const int r0 = (threadIdx.x / 8) * 4, c0 = (threadIdx.x % 8) * 4;
      float acc[4][4] = {};
      for (int k = 0; k < dp; ++k) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) { qv[i] = sQ[(r0 + i) * dp + k]; kv[i] = sK[(c0 + i) * dp + k]; }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sS[(r0 + i) * BK + c0 + j] = acc[i][j];
    }
    __syncthreads();
    {  // online softmax: warp w owns rows [16w, 16w+16), one key per lane
      const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
      for (int rr = 0; rr < 16; ++rr) {
        const int r = w * 16 + rr;
        const float s = sS[r * BK + lane] * scale + sBias[lane];
        const float m_prev = sM[r];
        const float m_new = fmaxf(m_prev, warp_max(s));
        const float p = expf(s - m_new);
        sS[r * BK + lane] = p;
        const float sum = warp_sum(p);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          sAlpha[r] = alpha;
          sL[r] = sL[r] * alpha + sum;
          sM[r] = m_new;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kBQ * dv; i += kThreads) {  // O = O * alpha + P V
      const int r = i / dv, c = i % dv;
      float acc = sO[r * dvp + c] * sAlpha[r];
#pragma unroll 8
      for (int k = 0; k < BK; ++k) acc = fmaf(sS[r * BK + k], sV[k * dvp + c], acc);
      sO[r * dvp + c] = acc;
    }
  }
  __syncthreads();
  float* out_blk = out + ((size_t)bh * nq + q0) * dv;
  for (int i = threadIdx.x; i < nvalid_q * dv; i += kThreads) {
    const int r = i / dv, c = i % dv;
    const float l = sL[r];
    out_blk[(size_t)r * dv + c] = l > 0.0f ? sO[r * dvp + c] / l : 0.0f;
  }
  if (lse != nullptr) {
    for (int r = threadIdx.x; r < nvalid_q; r += kThreads)
      lse[(size_t)bh * nq + q0 + r] = sM[r] + logf(fmaxf(sL[r], 1e-20f));
  }
}

// key rows per tile for element type T
template <typename T> struct TileK;
template <> struct TileK<bf16> { static constexpr int value = kBK16; };
template <> struct TileK<float> { static constexpr int value = kBK32; };

// Set the dynamic shared-memory limit of `kernel` and launch it.
template <typename Kernel, typename... Args>
inline int launch_kernel(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                         Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace flash
