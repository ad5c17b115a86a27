// Shared core of the hand-written Hopper flash-attention kernels: the
// forward bodies of K1 (flash_fwd.cu) and K2 (flash_banked_fwd.cu) and,
// further down, the body of the two backward kernels (flash_bwd_dq.cu,
// flash_bwd_dkv.cu), 3xTF32 on the tensor cores.
//
// Forward. One thread block computes one 64-row query tile of one (batch *
// head) row and loops over the key/value tiles itself, in place of the TPU
// kernel's sequential grid axis. Before the loop every thread of the block
// reads the additive bias and the block builds, in shared memory, the list
// of live key tiles (a tile is live when any of its keys has a bias above
// -1e29); only those are ever copied or multiplied. A query row that saw no
// live key (l == 0) is written as zeros. Both ragged edges (Nq, Nk) are
// handled here: the wrappers never pad.
//
// bf16 (the serving path): warp-specialised. One producer warp starts TMA
// copies of Q (once) and of the K and V tiles of the live list into a ring
// of 2-4 stages in shared memory, each stage with a "full" and an "empty"
// mbarrier; rows past Nq / Nk and columns past D come in as TMA's
// out-of-bounds zeros. A consumer warpgroup (four warps, the block's 64
// query rows) computes S = Q K^T with wgmma (Q and K K-major in
// 128-byte-swizzled shared memory, 64-column panels), runs the online
// softmax on the accumulator registers, and accumulates O += P V with
// wgmma, P taken straight from the score registers (RS form) and V read as
// the transposed B operand; tile i's S is started with the previous tile's
// P V, so the softmax overlaps a product. Scores, P and O never leave
// registers. Where the grid has no more blocks than the card has SMs, a
// second consumer warpgroup takes every other live tile and the two merge
// their partial (O, max, sum) at the end, so each SM still has two
// warpgroups to interleave.
// fp32 (the training path): four warps, no tensor cores (exact fp32 FMAs, as
// the training gradient gate assumes); K and V double-buffered with cp.async,
// S and O in register micro-tiles, P through shared memory; 64 or 128 query
// rows a block (f32_tile).
//
// A key-tile source policy (Src) supplies the bias and the K/V rows of each
// tile: flash_fwd.cu reads dense [BH, Nk, D] rows, flash_banked_fwd.cu reads
// the pre-pass's corrected keys and the memory bank's value rows by slot.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver entry is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

constexpr int kBQ = 64;          // query rows per block
constexpr int kThreads = 128;    // four warps: the fp32 forward
constexpr int kBK16 = 64;        // key rows per tile, bf16 forward
constexpr float kNegInit = -1e30f;       // running-max start, as the TPU kernel
constexpr float kSkipThreshold = -1e29f; // a tile whose max bias is below is skipped
constexpr int kPanelBytes = 64 * 128;    // 64 rows x 64 bf16: one 128-byte swizzle span a row
constexpr size_t kMaxSmem = 232448;      // 227 KB, the most a block may use
constexpr size_t kSmemPerSm = 233472;    // 228 KB an SM, 1 KB of it reserved per block

// Planted faults of the forward kernels, for the checks that must catch
// them (chip_smoke.py phase 1); 0 in every production call.
enum FwdFault : int {
  kFwdFaultNone = 0,
  kFaultWrongStage = 1  // the consumer reads the K/V of the next ring stage
};

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

__device__ inline float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
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

__device__ inline uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// fp32 shared-memory row stride for `width` columns: 16-byte rows, 4 mod 32
// banks, so the strided micro-tiles below touch 8 (16) different banks for
// 8 (4) different rows
__host__ __device__ inline int ld_f32(int width) { return round_up(width, 32) + 4; }

__device__ inline float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// acc[i][j] = sum_{k < kdim} A[rg + 16 i][k] * B[cg + 8 j][k] with rg =
// threadIdx.x / 8, cg = threadIdx.x % 8: the 128 threads tile a (16 RM) x
// (8 CN) block of A B^T (rows strided so a warp reads distinct banks).
// kdim is a multiple of 4; lda, ldb multiples of 4. UNROLL2: the depth loop
// unrolled by two (the forward; the backward kernels leave it to nvcc).
template <int RM, int CN, bool UNROLL2 = false>
__device__ inline void mm_nt(float (&acc)[RM][CN], const float* A, int lda, const float* B,
                             int ldb, int kdim) {
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.0f;
  auto step = [&](int k) {
    float4 a[RM], b[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = ld4(A + (rg + 16 * i) * lda + k);
#pragma unroll
    for (int j = 0; j < CN; ++j) b[j] = ld4(B + (cg + 8 * j) * ldb + k);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  };
  if constexpr (UNROLL2) {
#pragma unroll 2
    for (int k = 0; k < kdim; k += 4) step(k);
  } else {
    for (int k = 0; k < kdim; k += 4) step(k);
  }
}

// ---------------------------------------------------------------------------
// forward: the list of live key tiles, built once per block
// ---------------------------------------------------------------------------

// The additive bias of one key tile: key c of the tile reads p[c] (0 when p
// is null) for c < n, and is dead (-inf) from n on: past Nk, past S in a bank
// tile, or in a tile whose bank slot is out of range.
struct TileBias {
  const float* p;
  int n;
  __device__ float at(int c) const { return c < n ? (p != nullptr ? p[c] : 0.0f) : -INFINITY; }
};

// Every thread of the block calls it. Writes the indices of the live tiles
// of BK keys (any key with bias above -1e29), in increasing order, to
// list[0, n) in shared memory and returns n in every thread; ends with the
// list visible to the whole block. Without a bias every tile is live.
template <int BK, class Src>
__device__ inline int build_live_list(const Src& src, int* list) {
  const int ntiles = src.num_tiles(BK);
  int* count = list + ntiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, nwarps = blockDim.x / 32;
  if (!src.has_bias()) {
    for (int t = threadIdx.x; t < ntiles; t += blockDim.x) list[t] = t;
    __syncthreads();
    return ntiles;
  }
  for (int t = warp; t < ntiles; t += nwarps) {
    const TileBias tb = src.tile_bias(t * BK);
    float mx = -INFINITY;
    for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, tb.at(c));
    mx = warp_max(mx);
    if (lane == 0) list[t] = mx > kSkipThreshold;
  }
  __syncthreads();
  if (warp == 0) {  // compact the flags in place: entry n <= t is written after flag t is read
    int n = 0;
    for (int t0 = 0; t0 < ntiles; t0 += 32) {
      const int t = t0 + lane;
      const bool live = t < ntiles && list[t] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) list[n + __popc(m & ((1u << lane) - 1u))] = t;
      n += __popc(m);
    }
    if (lane == 0) *count = n;
  }
  __syncthreads();
  return *count;
}

// ---------------------------------------------------------------------------
// bf16: TMA ring, mbarriers, wgmma
// ---------------------------------------------------------------------------

__device__ inline void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ inline void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// wait until the phase of parity `parity` of the barrier has completed
__device__ inline void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: one box of the tensor map into shared memory, completion counted in
// bytes on `bar`
__device__ inline void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                   int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ inline void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                   int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: rows of
// 128 B, 8-row groups `sbo` bytes apart; `lbo` is the stride between
// 64-column atoms of an MN-major operand (ignored by K-major ones)
__device__ inline uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pin registers that wgmma reads or writes at this point of the program, so
// the compiler moves no access to them into an asynchronous wgmma stage
template <int N>
__device__ inline void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ inline void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define FLASH_D32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define FLASH_D32_OPS(d)                                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory;
// d is overwritten when accumulate == 0
__device__ inline void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FLASH_D32_OPS(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (the mma.m16n8k16 A
// fragment of each warp's 16 rows), B MN-major in shared memory
__device__ inline void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FLASH_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FLASH_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 forward's shapes are compile-time, so that no branch splits a
// wgmma stage (ptxas serialises the wgmmas of a stage with control flow in
// it): KS depth steps of 16 columns for Q K^T (4, 6, 8 or 16; the columns
// past D are TMA's zeros) and NVP 64-column panels of V (1, 2 or 4; the
// columns past Dv likewise). Q and K take ceil(KS / 4) panels.
__host__ __device__ inline int depth_steps(int d) {
  const int k = (d + 15) / 16;
  return k <= 4 ? 4 : k <= 6 ? 6 : k <= 8 ? 8 : 16;
}
__host__ __device__ inline int v_panels(int dv) { return dv <= 64 ? 1 : dv <= 128 ? 2 : 4; }

// Shared memory of the bf16 forward: Q panels, `stages` x (K panels, V
// panels), the barriers, the live list. +1024 for aligning the base to the
// 1024-byte period of the swizzle.
__host__ __device__ inline size_t smem_bytes_bf16(int d, int dv, int stages, int ntiles) {
  const int np = (depth_steps(d) + 3) / 4, nvp = v_panels(dv);
  return 1024 + (size_t)kPanelBytes * (np + stages * (np + nvp)) + 8 * (2 * stages + 1) +
         4 * (ntiles + 1);
}

// threads of a bf16 forward block: NWG consumer warpgroups and the producer warp
__host__ __device__ constexpr int threads_bf16(int nwg) { return 128 * nwg + 32; }

__device__ inline void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// KS = depth_steps(D), NVP = v_panels(Dv); the output accumulator is a
// register array of NVP x 32. NWG consumer warpgroups (1 or 2) share the 64
// query rows: warpgroup w takes the live tiles w, w + NWG, ... with its own
// running max, sum and O, and the two are merged at the end (an in-block
// split of the keys, so that a grid of fewer blocks than SMs still has two
// warpgroups an SM to overlap one's softmax with the other's wgmma). tm_q:
// the [BH, Nq, D] map of q in boxes of 64 x 64; out: [BH, Nq, Dv]; lse:
// [BH, Nq] fp32 or nullptr. Threads [0, 128 NWG) are the consumers, the warp
// after them the producer.
template <int KS, int NVP, int NWG, class Src>
__device__ inline void flash_body_bf16(const Src& src, const CUtensorMap* tm_q,
                                       bf16* __restrict__ out, float* __restrict__ lse, int nq,
                                       int dv, float scale, int stages, int fault) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int np = (KS + 3) / 4, nvp = NVP;
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  const int stage_bytes = kPanelBytes * (np + nvp);
  unsigned char* sQ = base;
  unsigned char* sK0 = base + kPanelBytes * np;  // stage s: K at sK0 + s * stage_bytes, V after
  uint64_t* full = reinterpret_cast<uint64_t*>(sK0 + (size_t)stages * stage_bytes);
  uint64_t* empty = full + stages;
  uint64_t* qbar = empty + stages;
  int* list = reinterpret_cast<int*>(qbar + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);  // the one warpgroup that read the stage
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int nlive = build_live_list<kBK16>(src, list);  // its barriers publish the inits

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kBQ;
  if (warp == 4 * NWG) {  // producer: one thread starts every copy
    if (lane == 0 && nlive > 0) {
      mbar_expect_tx(qbar, kPanelBytes * np);
      for (int p = 0; p < np; ++p)
        tma_load_3d(sQ + p * kPanelBytes, tm_q, qbar, 64 * p, q0, src.row);
      for (int i = 0; i < nlive; ++i) {
        const int s = i % stages;
        if (i >= stages) mbar_wait(&empty[s], ((i / stages) - 1) & 1);
        mbar_expect_tx(&full[s], stage_bytes);
        unsigned char* sk = sK0 + (size_t)s * stage_bytes;
        src.load_tile(list[i], sk, sk + kPanelBytes * np, np, nvp, &full[s]);
      }
    }
    return;
  }

  // consumers: warp wr of warpgroup wg owns query rows [16 wr, 16 wr + 16);
  // thread (g, t4) holds rows g and g + 8 of them at columns 8j + 2 t4 +
  // {0, 1} of every 64-wide accumulator (the wgmma D layout). Tile i's
  // S = Q K^T is started together with the P V of the warpgroup's previous
  // tile, so its softmax runs while the tensor cores do that product.
  const int wg = warp / 4, wr = warp % 4;
  const int g = lane / 4, t4 = lane % 4;
  float o[NVP][32];
#pragma unroll
  for (int p = 0; p < NVP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.0f;
  float m_run[2] = {kNegInit, kNegInit};  // rows g and g + 8 of the warp's 16
  float l_run[2] = {0.0f, 0.0f};          // this thread's share of the row sums
  float sc[32];                           // scores, then probabilities, of one tile
  float bias[16];                         // the bias of this thread's 16 key columns
  uint32_t pa[4][4];                      // P of the previous tile as wgmma A fragments
  // the K and V of tile i (the planted fault reads the next stage's)
  auto stage_k = [&](int i) -> const unsigned char* {
    const int s = fault == kFaultWrongStage ? (i + 1) % stages : i % stages;
    return sK0 + (size_t)s * stage_bytes;
  };
  // the bias of tile i, read before its scores are needed
  auto load_bias = [&](int i) {
    const TileBias tb = src.tile_bias(list[i] * kBK16);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) bias[2 * j + e] = tb.at(8 * j + 2 * t4 + e);
  };
  // S[64 x 64] = Q K^T of tile i: depth steps of 16 columns, 4 a panel
  auto start_s = [&](int i) {
    const unsigned char* sK = stage_k(i);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int off = (kk >> 2) * kPanelBytes + (kk & 3) * 32;
      wgmma_ss(sc, sw128_desc(sQ + off, 16, 1024), sw128_desc(sK + off, 16, 1024), kk);
    }
  };
  // O[64 x Dv] += P V of tile i: depth step c takes key columns [16c, 16c +
  // 16), the A fragment pa[c]; V is the transposed (MN-major) B operand, one
  // wgmma a 64-column panel, depth step c at row 16c of the panel
  auto start_pv = [&](int i) {
    const unsigned char* sV = stage_k(i) + kPanelBytes * np;
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int p = 0; p < NVP; ++p)
        wgmma_rs(o[p], pa[c], sw128_desc(sV + p * kPanelBytes + c * 2048, kPanelBytes, 1024));
  };
  auto fence_all = [&]() {
    fence_regs(sc);
#pragma unroll
    for (int p = 0; p < NVP; ++p) fence_regs(o[p]);
#pragma unroll
    for (int c = 0; c < 4; ++c) fence_regs(pa[c]);
  };
  // the online softmax of a tile on sc (sc[4j + 2r + e]: row g + 8r, key
  // column 8j + 2 t4 + e): scaled scores plus bias to probabilities; returns
  // the rescale factors alpha of the running max and this tile's row sums
  auto softmax = [&](float (&alpha)[2], float (&rsum)[2]) {
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = sc[4 * j + e] * scale + bias[2 * j + e];
        sc[4 * j + 2 + e] = sc[4 * j + 2 + e] * scale + bias[2 * j + e];
        mx[0] = fmaxf(mx[0], sc[4 * j + e]);
        mx[1] = fmaxf(mx[1], sc[4 * j + 2 + e]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      rsum[r] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = expf(sc[4 * j + e] - m_run[0]);
        sc[4 * j + 2 + e] = expf(sc[4 * j + 2 + e] - m_run[1]);
        rsum[0] += sc[4 * j + e];
        rsum[1] += sc[4 * j + 2 + e];
      }
    }
  };
  // O = O * alpha (O holds the tiles before this one), l = l * alpha + rsum,
  // and this tile's P packed to bf16 A fragments
  auto rescale_pack = [&](const float (&alpha)[2], const float (&rsum)[2]) {
    l_run[0] = l_run[0] * alpha[0] + rsum[0];
    l_run[1] = l_run[1] * alpha[1] + rsum[1];
#pragma unroll
    for (int p = 0; p < NVP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[p][4 * j] *= alpha[0];
        o[p][4 * j + 1] *= alpha[0];
        o[p][4 * j + 2] *= alpha[1];
        o[p][4 * j + 3] *= alpha[1];
      }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      pa[c][0] = pack_bf16(sc[8 * c], sc[8 * c + 1]);
      pa[c][1] = pack_bf16(sc[8 * c + 2], sc[8 * c + 3]);
      pa[c][2] = pack_bf16(sc[8 * c + 4], sc[8 * c + 5]);
      pa[c][3] = pack_bf16(sc[8 * c + 6], sc[8 * c + 7]);
    }
  };

  if (wg < nlive) {  // this warpgroup's first tile
    load_bias(wg);
    mbar_wait(qbar, 0);
    mbar_wait(&full[wg % stages], (wg / stages) & 1);
    fence_all();
    wgmma_fence();
    start_s(wg);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    float alpha[2], rsum[2];
    softmax(alpha, rsum);
    rescale_pack(alpha, rsum);
  }
  for (int i = wg + NWG; i < nlive; i += NWG) {
    load_bias(i);
    mbar_wait(&full[i % stages], (i / stages) & 1);
    fence_all();
    wgmma_fence();
    start_s(i);
    wgmma_commit();
    start_pv(i - NWG);
    wgmma_commit();
    wgmma_wait<1>();  // S of tile i is in; P V of the previous tile may still run
    fence_regs(sc);
    float alpha[2], rsum[2];
    softmax(alpha, rsum);
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NVP; ++p) fence_regs(o[p]);
    mbar_arrive(&empty[(i - NWG) % stages]);  // the previous tile's K and V are read
    rescale_pack(alpha, rsum);
  }
  if (wg < nlive) {  // the P V of this warpgroup's last tile
    const int last = wg + (nlive - 1 - wg) / NWG * NWG;
    fence_all();
    wgmma_fence();
    start_pv(last);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NVP; ++p) fence_regs(o[p]);
    mbar_arrive(&empty[last % stages]);
  }

  if constexpr (NWG == 2) {
    // merge warpgroup 1's (O, max, sum) into warpgroup 0's through the now
    // idle ring: thread t of both holds the same rows and columns
    constexpr int W = NVP * 32 + 4;
    float* xo = reinterpret_cast<float*>(sK0);  // [W][128]
    const int t = threadIdx.x % 128;
    named_bar_sync(1, 256);  // both warpgroups are done with the ring
    if (wg == 1) {
#pragma unroll
      for (int p = 0; p < NVP; ++p)
#pragma unroll
        for (int k = 0; k < 32; ++k) xo[(p * 32 + k) * 128 + t] = o[p][k];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        xo[(W - 4 + r) * 128 + t] = m_run[r];
        xo[(W - 2 + r) * 128 + t] = l_run[r];
      }
    }
    named_bar_sync(2, 256);
    if (wg == 1) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = xo[(W - 4 + r) * 128 + t], l1 = xo[(W - 2 + r) * 128 + t];
      const float m = fmaxf(m_run[r], m1);
      const float a0 = expf(m_run[r] - m), a1 = expf(m1 - m);
      l_run[r] = l_run[r] * a0 + l1 * a1;
      m_run[r] = m;
#pragma unroll
      for (int p = 0; p < NVP; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 4 * j + 2 * r + e;
            o[p][k] = o[p][k] * a0 + xo[(p * 32 + k) * 128 + t] * a1;
          }
    }
  }

  // finalize: full row sums across the quad, then out = O / l (0 if l == 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int nvalid_q = min(kBQ, nq - q0);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wr * 16 + g + 8 * r;
    if (row >= nvalid_q) continue;
    const float inv = l_run[r] > 0.0f ? 1.0f / l_run[r] : 0.0f;
    bf16* orow = out + ((size_t)src.row * nq + q0 + row) * dv;
#pragma unroll
    for (int p = 0; p < NVP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * p + 8 * j + 2 * t4;
        if (col < dv)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[p][4 * j + 2 * r] * inv, o[p][4 * j + 2 * r + 1] * inv);
      }
    if (lse != nullptr && t4 == 0)
      lse[(size_t)src.row * nq + q0 + row] = m_run[r] + logf(fmaxf(l_run[r], 1e-20f));
  }
}

// ---------------------------------------------------------------------------
// fp32: cp.async double buffer, register micro-tiles on the CUDA cores
// ---------------------------------------------------------------------------

__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Columns [0, ncols) of rows [0, nrows) of a row-major fp32 matrix (row
// stride src_ld) into shared memory (row stride dst_ld), by the NT threads
// of the block, 16 bytes a copy; rows >= nvalid and columns >= nsrc are
// zero-filled. ncols and nsrc multiples of 4, src 16-byte aligned.
template <int NT = kThreads>
__device__ inline void cp_rows_f32(float* dst, int dst_ld, const float* src, size_t src_ld,
                                   int nvalid, int nrows, int ncols, int nsrc) {
  const int vpr = ncols / 4;
  for (int i = threadIdx.x; i < nrows * vpr; i += NT) {
    const int r = i / vpr, c = (i % vpr) * 4;
    const bool ok = r < nvalid && c < nsrc;
    cp_async16(dst + (size_t)r * dst_ld + c, ok ? src + r * src_ld + c : src, ok);
  }
}

// Shared memory of the fp32 forward with BQ query rows and BK-key tiles: Q,
// two K and two V buffers, P (row stride BK + 8: the 32 lanes of a warp
// store to 32 banks), the live list.
__host__ __device__ inline size_t smem_bytes_f32(int d, int dv, int bq, int bk, int ntiles) {
  return sizeof(float) * ((size_t)bq * ld_f32(d) + 2 * (size_t)bk * (ld_f32(d) + ld_f32(dv)) +
                          (size_t)bq * (bk + 8)) +
         4 * (ntiles + 1);
}

// Query rows and keys a tile of the fp32 forward.
struct F32Tile {
  int bq, bk;
};

// 128 query rows and 32 keys a tile where Dv <= 128 and two such blocks
// share an SM (twice a thread's independent FMAs, half the K / V copies and
// barriers a FLOP); else 64 rows and 64 or 32 keys, whichever lets more
// blocks share an SM (64 on a tie: fewer barriers a key); {0, 0} when
// nothing fits
inline F32Tile f32_tile(int d, int dv, int nkeys) {
  auto per_sm = [](size_t bytes) {
    return bytes > kMaxSmem ? 0 : (int)(kSmemPerSm / (bytes + 1024));
  };
  if (dv <= 128 && per_sm(smem_bytes_f32(d, dv, 128, 32, (nkeys + 31) / 32)) >= 2)
    return {128, 32};
  const int n64 = per_sm(smem_bytes_f32(d, dv, 64, 64, (nkeys + 63) / 64));
  const int n32 = per_sm(smem_bytes_f32(d, dv, 64, 32, (nkeys + 31) / 32));
  if (n64 == 0 && n32 == 0) return {0, 0};
  return {64, n64 >= n32 ? 64 : 32};
}

// DVMAX: compile-time bound on round_up(Dv, 32) (64, 128 or 256); BQ, BK:
// query rows and keys a tile (f32_tile). q: [BH, Nq, D] (this block's rows
// at src.row); out: [BH, Nq, Dv]; lse: [BH, Nq] or nullptr. Thread (rg, cg)
// = (tid / 8, tid % 8) holds S and O of rows rg + 16 i (i < BQ / 16), S at
// key columns cg + 8 j, O at columns 4 cg + 32 jj + e.
template <int DVMAX, int BK, int BQ, class Src>
__device__ inline void flash_body_f32(const Src& src, const float* __restrict__ q,
                                      float* __restrict__ out, float* __restrict__ lse, int nq,
                                      int d, int dv, float scale, int fault) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int CN = BK / 8, NJ = DVMAX / 32, LDP = BK + 8, RM = BQ / 16;
  const int ldk = ld_f32(d), ldv = ld_f32(dv), dvr = round_up(dv, 32);
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + BQ * ldk;        // two buffers of BK rows
  float* sV = sK + 2 * BK * ldk;    // two buffers of BK rows
  float* sP = sV + 2 * BK * ldv;    // [BQ, BK] probabilities
  int* list = reinterpret_cast<int*>(sP + BQ * LDP);
  const int q0 = blockIdx.x * BQ, nvalid_q = min(BQ, nq - q0);
  const int nlive = build_live_list<BK>(src, list);
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;

  cp_rows_f32(sQ, ldk, q + ((size_t)src.row * nq + q0) * d, d, nvalid_q, BQ, d, d);
  auto fetch = [&](int i) {
    const float *kp, *vp;
    int nk_valid, nv_valid;
    src.rows(list[i], BK, kp, vp, nk_valid, nv_valid);
    cp_rows_f32(sK + (i & 1) * BK * ldk, ldk, kp, d, nk_valid, BK, d, d);
    cp_rows_f32(sV + (i & 1) * BK * ldv, ldv, vp, dv, nv_valid, BK, dv, dv);
  };
  if (nlive > 0) fetch(0);
  cp_async_commit();

  float o[NJ][RM][4];
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
    for (int r = 0; r < RM; ++r) o[jj][r][0] = o[jj][r][1] = o[jj][r][2] = o[jj][r][3] = 0.0f;
  float m_run[RM], l_run[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m_run[r] = kNegInit;
    l_run[r] = 0.0f;
  }

  for (int i = 0; i < nlive; ++i) {
    if (i + 1 < nlive) fetch(i + 1);  // its buffer's readers (tile i - 1) are done
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int buf = (fault == kFaultWrongStage ? i + 1 : i) & 1;
    const float* k_ = sK + buf * BK * ldk;
    const float* v_ = sV + buf * BK * ldv;
    const TileBias tb = src.tile_bias(list[i] * BK);
    float bias[CN];
#pragma unroll
    for (int j = 0; j < CN; ++j) bias[j] = tb.at(cg + 8 * j);

    float s[RM][CN];
    mm_nt<RM, CN, true>(s, sQ, ldk, k_, ldk, d);
    float alpha[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        s[r][j] = s[r][j] * scale + bias[j];
        mx = fmaxf(mx, s[r][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[r], mx);
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
      float rsum = 0.0f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = expf(s[r][j] - m_new);
        rsum += p;
        sP[(rg + 16 * r) * LDP + cg + 8 * j] = p;
      }
      l_run[r] = l_run[r] * alpha[r] + rsum;
    }
    __syncthreads();

    // O = O * alpha + P V
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[jj][r][e] *= alpha[r];
    for (int k = 0; k < BK; k += 4) {
      float4 a[RM];
#pragma unroll
      for (int r = 0; r < RM; ++r) a[r] = ld4(sP + (rg + 16 * r) * LDP + k);
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) {
        if (32 * jj < dvr) {
          const int c = 4 * cg + 32 * jj;
          const float4 b0 = ld4(v_ + (k + 0) * ldv + c), b1 = ld4(v_ + (k + 1) * ldv + c);
          const float4 b2 = ld4(v_ + (k + 2) * ldv + c), b3 = ld4(v_ + (k + 3) * ldv + c);
#pragma unroll
          for (int r = 0; r < RM; ++r) {
            float* acc = o[jj][r];
            acc[0] = fmaf(a[r].x, b0.x, acc[0]);
            acc[1] = fmaf(a[r].x, b0.y, acc[1]);
            acc[2] = fmaf(a[r].x, b0.z, acc[2]);
            acc[3] = fmaf(a[r].x, b0.w, acc[3]);
            acc[0] = fmaf(a[r].y, b1.x, acc[0]);
            acc[1] = fmaf(a[r].y, b1.y, acc[1]);
            acc[2] = fmaf(a[r].y, b1.z, acc[2]);
            acc[3] = fmaf(a[r].y, b1.w, acc[3]);
            acc[0] = fmaf(a[r].z, b2.x, acc[0]);
            acc[1] = fmaf(a[r].z, b2.y, acc[1]);
            acc[2] = fmaf(a[r].z, b2.z, acc[2]);
            acc[3] = fmaf(a[r].z, b2.w, acc[3]);
            acc[0] = fmaf(a[r].w, b3.x, acc[0]);
            acc[1] = fmaf(a[r].w, b3.y, acc[1]);
            acc[2] = fmaf(a[r].w, b3.z, acc[2]);
            acc[3] = fmaf(a[r].w, b3.w, acc[3]);
          }
        }
      }
    }
    __syncthreads();  // P and this tile's buffers are free for the next tiles
  }
  cp_async_wait<0>();

  // finalize: row sums across the 8 threads of a row, out = O / l (0 if l == 0)
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const int row = rg + 16 * r;
    if (row >= nvalid_q) continue;
    float* orow = out + ((size_t)src.row * nq + q0 + row) * dv;
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      const int c = 4 * cg + 32 * jj;
      if (c < dv) {
        const float* acc = o[jj][r];
        *reinterpret_cast<float4*>(orow + c) =
            l > 0.0f ? make_float4(acc[0] / l, acc[1] / l, acc[2] / l, acc[3] / l)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    if (lse != nullptr && cg == 0)
      lse[(size_t)src.row * nq + q0 + row] = m_run[r] + logf(fmaxf(l, 1e-20f));
  }
}

// ---------------------------------------------------------------------------
// host side of the forward kernels
// ---------------------------------------------------------------------------

// Error codes the C entries return besides CUDA's own: a tensor map the
// driver would not encode (kErrTensorMap + its CUresult), no driver entry
// point for the encoder, a shape whose tiles do not fit in shared memory.
constexpr int kErrTensorMap = 10000;
constexpr int kErrNoEncoder = 20000;
constexpr int kErrSmem = 20001;

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// libraries need no link against the driver
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &res);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first, `dims`; byte
// strides of dimensions 1.. in `strides`) read in boxes of 64 x 64 (x 1 ...)
// with the 128-byte swizzle that the wgmma descriptors assume; out-of-bounds
// elements read as zeros. Returns 0 or an error code.
inline int encode_bf16_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
                           const uint64_t* strides) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint32_t box[5] = {64, 64, 1, 1, 1}, unit[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                        const_cast<void*>(ptr), reinterpret_cast<const cuuint64_t*>(dims),
                        reinterpret_cast<const cuuint64_t*>(strides), box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + (int)r;
}

inline int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) n = 132;
  }
  return n;
}

// Consumer warpgroups of the bf16 forward: two (splitting the block's key
// tiles) where the grid has no more blocks than the card has SMs, so that
// each SM still runs two; one where V is 4 panels wide (its 128 output
// registers a thread leave no room for a second warpgroup).
inline int consumer_groups(int dv, long long blocks) {
  return v_panels(dv) <= 2 && blocks <= num_sms() ? 2 : 1;
}

// Ring stages of the bf16 forward (2-4; at least 3 for two warpgroups, each
// of which holds one stage while it waits for the next), or 0 when they do
// not fit: one warpgroup takes two blocks an SM where the grid has more
// blocks than the card has SMs and two stages fit in half an SM, else as
// many stages as fit in one block's 227 KB.
inline int ring_stages(int d, int dv, int ntiles, long long blocks, int nwg) {
  const size_t fixed = smem_bytes_bf16(d, dv, 0, ntiles);
  const size_t stage = (size_t)kPanelBytes * ((depth_steps(d) + 3) / 4 + v_panels(dv));
  const size_t half_sm = kSmemPerSm / 2 - 1024;
  if (nwg == 1 && blocks > num_sms() && fixed + 2 * stage <= half_sm)
    return (int)(((half_sm - fixed) / stage) < 4 ? (half_sm - fixed) / stage : 4);
  const int least = nwg + 1;
  if (fixed + least * stage > kMaxSmem) return 0;
  const size_t n = (kMaxSmem - fixed) / stage;
  return (int)(n < 4 ? n : 4);
}

// f.run<KS, NVP, NWG>() with the bf16 forward's compile-time shape for D,
// Dv and its warpgroup count
template <class F>
inline int dispatch_bf16(int d, int dv, int nwg, const F& f) {
  const int nvp = v_panels(dv);
#define FLASH_NVP(KS)                                                              \
  (nvp == 4 ? f.template run<KS, 4, 1>()                                           \
   : nwg == 2 ? (nvp == 1 ? f.template run<KS, 1, 2>() : f.template run<KS, 2, 2>()) \
              : (nvp == 1 ? f.template run<KS, 1, 1>() : f.template run<KS, 2, 1>()))
  switch (depth_steps(d)) {
    case 4: return FLASH_NVP(4);
    case 6: return FLASH_NVP(6);
    case 8: return FLASH_NVP(8);
    default: return FLASH_NVP(16);
  }
#undef FLASH_NVP
}

// Set the dynamic shared-memory limit of `kernel` and launch it with
// `threads` threads a block.
template <typename Kernel, typename... Args>
inline int launch_kernel_n(Kernel kernel, dim3 grid, int threads, size_t smem,
                           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The same with the four-warp block of the fp32 forward.
template <typename Kernel, typename... Args>
inline int launch_kernel(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                         Args... args) {
  return launch_kernel_n(kernel, grid, kThreads, smem, stream, args...);
}

// ---------------------------------------------------------------------------
// backward (K3a flash_bwd_dq.cu, K3b flash_bwd_dkv.cu): one body for both.
//
// A block keeps 64 (or 32) rows resident in shared memory as fp32 (K3a: the
// query rows' Q and dO; K3b: the key rows' K and V) and streams the other side in
// tiles of BT rows (K3a: K and V of the live key tiles; K3b: Q and dO of
// every query tile) through a ring of 2-4 cp.async stages, so the copies of
// the next tiles are in flight during the math of this one. bf16 operands
// are widened to fp32 on the way in (plain loads, not cp.async).
//
// Products run on the tensor cores as 3xTF32 (mma.sync m16n8k8 .tf32 with
// fp32 accumulators): each fp32 operand x is split into hi = x rounded to
// TF32 and lo = (x - hi) rounded to TF32, and a product is lo*hi + hi*lo +
// hi*hi. The small terms go to an accumulator of their own, added to the
// large one once the contraction is done: the tensor core truncates where
// it aligns addends, and small terms added to a large sum would lose their
// low bits. bf16 values are exact in TF32 (lo = 0), so those passes are
// left out at compile time. The output accumulators (dq; dk, dv) live in
// registers: each tile's contribution is summed in fresh registers and then
// added to them with an fp32 add, so no truncated sum spans two tiles.
//
// Shapes are compile-time inside the loops: D and Dv are padded to their
// bucket (64 or 256) with zero columns in shared memory, and the planted
// one-pass fault picks another instance of the product loops at the call,
// so that no branch splits the loops (a branch there fences every mma into
// its own region and the loads of the next step cannot move ahead of it).
//
// Eight warps (two warpgroups) in SIDES = 2 (or 4, bwd_sides) shares of the
// columns: warp w owns the 16 resident rows of row group w % (8 / SIDES)
// and the column share w / (8 / SIDES). For S = X A^T and dP = Y B^T it
// takes that share of the contraction (of D, of Dv), and the warps of a row
// group add their partial sums through shared memory in one fixed order
// (so all hold the same bits); all then compute the same P and dS, and each
// multiplies them into its own share of the output columns. dS and P go
// from the accumulator layout straight to A fragments, the keys of each
// 8-key step taken in a permuted order that the B fragments follow. No
// atomics: every block owns its output rows, so a launch is deterministic.
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;    // eight warps: two warpgroups
constexpr float kDeadLse = -1e30f;  // lse of a query row outside Nq: P = 0

// Planted faults of the backward kernels, for the checks that must catch
// them (chip_smoke.py phase 1); 0 in every production call.
enum BwdFault : int {
  kFaultNone = 0,
  kFaultNoDelta = 1,      // K3a: dS = P * dP, the delta term left out
  kFaultSkipTile = 2,     // K3b: key block 1 skipped although it is live
  kFaultUnsafeP = 3,      // both: P = exp(S - lse) also where lse <= -1e29
  kFaultDvWrongTile = 4,  // K3b: block b's dv written to the rows of block b + 1
  kFaultOneTf32Pass = 5   // both: every product hi * hi alone (one TF32 pass)
};

template <typename T> __device__ inline float round_to(float x);
template <> __device__ inline float round_to<float>(float x) { return x; }
template <> __device__ inline float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <typename T> __device__ inline T from_float(float x);
template <> __device__ inline float from_float<float>(float x) { return x; }
template <> __device__ inline bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }
__device__ inline void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ inline void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// The 3xTF32 split of x: hi = x rounded to TF32 (10 mantissa bits, to
// nearest, ties away from zero: the rounding of cvt.rna.tf32.f32), lo = x -
// hi (exact in fp32) rounded the same way; x = hi + lo to about 2^-22
// relative. Integer operations on the bits, as the plain
// ops/attention.py:split_tf32 does: adding half a TF32 ulp rounds, and the
// low 13 bits need no mask for the mma, which reads the top 19 bits of a
// .tf32 operand (CUTLASS's round_half_ulp_truncate relies on the same); hi
// is masked only where it is subtracted.
__device__ inline void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}

// d += a b: one m16n8k8 TF32 product with fp32 accumulators. Thread (g, t) =
// (lane / 4, lane % 4) holds a = A[g][t], A[g + 8][t], A[g][t + 4],
// A[g + 8][t + 4]; b = B[t][g], B[t + 4][g]; d = D[g][2t], D[g][2t + 1],
// D[g + 8][2t], D[g + 8][2t + 1].
__device__ inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 3xTF32 step: la += a_lo b_hi, lb += a_hi b_lo, hi += a_hi b_hi (three
// accumulators, so no two of the step's products wait on each other). LOA /
// LOB: the operand has a low part (fp32 data; bf16 data is exact in TF32).
// ONE: the planted fault that keeps hi * hi alone.
template <bool LOA, bool LOB, bool ONE>
__device__ inline void mma3(float (&hi)[4], float (&la)[4], float (&lb)[4],
                            const uint32_t (&ah)[4], const uint32_t (&al)[4],
                            const uint32_t (&bh)[2], const uint32_t (&bl)[2]) {
  if constexpr (LOA && !ONE) mma_tf32(la, al, bh[0], bh[1]);
  if constexpr (LOB && !ONE) mma_tf32(lb, ah, bl[0], bl[1]);
  mma_tf32(hi, ah, bh[0], bh[1]);
}

// acc[n] = sum over the KS 8-column steps from column 8 k0 of X[16 rows][8 kk
// + 0..7] T[8 n + 0..7][8 kk + 0..7]^T for n < NT: a 16 x 8 NT block of X
// T^T, both operands K-major in shared memory (row strides 4 mod 32 banks,
// so the fragment loads are free of bank conflicts).
template <int NT, int KS, bool LOA, bool LOB, bool ONE>
__device__ inline void mm_nt_3xtf32(float (&acc)[NT][4], const float* x, int ldx,
                                    const float* tt, int ldt, int k0) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  // the two low passes share an accumulator where NT >= 4 steps already
  // give enough independent ones (fewer registers)
  constexpr bool LO2 = NT >= 4;
  float la[NT][4], lb[LO2 ? 1 : NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = la[n][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < (LO2 ? 1 : NT); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) lb[n][e] = 0.0f;
#pragma unroll 4
  for (int kk = k0; kk < k0 + KS; ++kk) {
    const int c = 8 * kk + t;
    uint32_t ah[4], al[4];
    split_tf32(x[g * ldx + c], ah[0], al[0]);
    split_tf32(x[(g + 8) * ldx + c], ah[1], al[1]);
    split_tf32(x[g * ldx + c + 4], ah[2], al[2]);
    split_tf32(x[(g + 8) * ldx + c + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float* b = tt + (8 * n + g) * ldt + c;
      uint32_t bh[2], bl[2];
      split_tf32(b[0], bh[0], bl[0]);
      split_tf32(b[4], bh[1], bl[1]);
      if constexpr (LO2)
        mma3<LOA, LOB, ONE>(acc[n], la[n], la[n], ah, al, bh, bl);
      else
        mma3<LOA, LOB, ONE>(acc[n], la[n], lb[n], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (LO2)
        acc[n][e] += la[n][e];
      else
        acc[n][e] += la[n][e] + lb[n][e];
    }
}

// acc[n] += sum over j < NT of C[16 rows][8 j + 0..7] T[8 j + 0..7][8 (n0 +
// n) + 0..7] for n < NO. C (dS or P) is in the accumulator layout of
// mm_nt_3xtf32 and is used as the A operand in place: in step j, A's column
// t is key 8j + 2t and column t + 4 is key 8j + 2t + 1, and T's rows are read
// in that order. T row-major in shared memory (row stride 4 mod 32 banks).
// Each output step's sum over the tile is taken in fresh registers and added
// to acc in fp32.
template <int NT, int NO, bool LOA, bool LOB, bool ONE>
__device__ inline void mm_cn_3xtf32(float (&acc)[NO][4], const float (&cf)[NT][4],
                                    const float* tt, int ldt, int n0) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
  uint32_t ah[NT][4], al[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split_tf32(cf[j][0], ah[j][0], al[j][0]);
    split_tf32(cf[j][2], ah[j][1], al[j][1]);
    split_tf32(cf[j][1], ah[j][2], al[j][2]);
    split_tf32(cf[j][3], ah[j][3], al[j][3]);
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const float* b = tt + 2 * t * ldt + 8 * (n0 + n) + g;
    float hi[4] = {0.0f, 0.0f, 0.0f, 0.0f}, la[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float lb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh[2], bl[2];
      split_tf32(b[8 * j * ldt], bh[0], bl[0]);
      split_tf32(b[(8 * j + 1) * ldt], bh[1], bl[1]);
      mma3<LOA, LOB, ONE>(hi, la, lb, ah[j], al[j], bh, bl);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += hi[e] + (la[e] + lb[e]);
  }
}

// Rows [0, NROWS) of a row-major [*, ncols] matrix of T into fp32 shared
// memory (row stride ldd), padded to PAD columns: rows >= nvalid and
// columns >= ncols as zeros. fp32 by cp_rows_f32 (in the caller's open
// cp.async group), bf16 widened on the way (8 elements a load). ncols a
// multiple of 8, src 16-byte aligned.
template <typename T, int NROWS, int PAD>
__device__ inline void stage_rows(float* dst, int ldd, const T* src, int ncols, int nvalid) {
  if constexpr (sizeof(T) == 4) {
    cp_rows_f32<kBwdThreads>(dst, ldd, src, ncols, nvalid, NROWS, PAD, ncols);
  } else {
    constexpr int VPR = PAD / 8;
    for (int i = threadIdx.x; i < NROWS * VPR; i += kBwdThreads) {
      const int r = i / VPR, c = (i % VPR) * 8;
      float f[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (r < nvalid && c < ncols) load8(src + (size_t)r * ncols + c, f);
      store8(dst + r * ldd + c, f);
    }
  }
}

__device__ inline void cp_async_wait_upto(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<2>();
}

// out[r][8 (n0 + n) + 2t + {0, 1}] = acc * scale for this thread's rows r =
// r16 + g + {0, 8} below nvalid and columns below ld: each element of the
// block's rows written once, from registers
template <int NO, typename T>
__device__ inline void store_acc(T* out, int ld, const float (&acc)[NO][4], int r16, int n0,
                                 int nvalid, float scale) {
  const int g = (threadIdx.x % 32) / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = r16 + g + 8 * rr;
    if (r >= nvalid) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      if (8 * (n0 + n) < ld)
        store2(out + (size_t)r * ld + 8 * (n0 + n) + 2 * t, acc[n][2 * rr] * scale,
               acc[n][2 * rr + 1] * scale);
  }
}

// Operands of the backward kernels (the C entries' arguments): q, k [BH, N,
// D], v [BH, Nk, Dv] and the gradients gq, gk, gv of the same shapes in T;
// dout [BH, Nq, Dv], lse and delta [BH, Nq], bias [BH, Nk] (or null) fp32.
template <typename T>
struct BwdParams {
  const T *q, *k, *v;
  const float *bias, *dout, *lse, *delta;
  T *gq, *gk, *gv;
  int nq, nk, d, dv;
  float scale;
  int fault, stages;
};

// The keys of one (batch * head) row as tiles of BK keys: the source policy
// of build_live_list (0 bias without one, -inf past Nk).
struct BwdKeys {
  const float* bias;  // [Nk] or null
  int nk;
  __device__ int num_tiles(int bk) const { return (nk + bk - 1) / bk; }
  __device__ bool has_bias() const { return bias != nullptr; }
  __device__ TileBias tile_bias(int k0) const {
    return TileBias{bias != nullptr ? bias + k0 : nullptr, nk - k0};
  }
};

// Streamed rows a tile: 16 where D and Dv both take the 256-column bucket
// (the fp32 resident rows and the ring of 256-column tiles leave room for
// two or three such stages only), else 32.
__host__ __device__ constexpr int bwd_tile(int dmax, int dvmax) {
  return dmax > 64 && dvmax > 64 ? 16 : 32;
}
// Ways the eight warps split the output columns (and S's and dP's
// contraction): 4, over 32 resident rows a block (two row groups of 16),
// where D and Dv both take the 256 bucket: K3b's dk and dv would otherwise
// hold 128 accumulator registers a thread and spill, and the BH = 3 memory
// self-attention grid doubles to 2.9 waves of blocks; else 2, over 64 rows
// (four row groups), which reads each streamed tile for twice the rows.
__host__ __device__ constexpr int bwd_sides(int dmax, int dvmax) {
  return dmax > 64 && dvmax > 64 ? 4 : 2;
}
__host__ __device__ constexpr int bwd_rows(int dmax, int dvmax) {
  return 16 * (8 / bwd_sides(dmax, dvmax));
}
// Blocks an SM the register budget is set for: two at D, Dv <= 64.
__host__ __device__ constexpr int bwd_min_blocks(int dmax, int dvmax) {
  return dmax <= 64 && dvmax <= 64 ? 2 : 1;
}
// floats of the exchange buffer: [8 warps][S, dP][BT / 8][4][32 lanes]
__host__ __device__ constexpr int bwd_xch_floats(int bt) { return 2 * 4 * 2 * (bt / 8) * 128; }

// Shared memory of the backward at the column buckets dmax, dvmax: the
// resident rows, `stages` streamed tiles, the exchange buffer and (K3a) the
// live list of nlist key tiles.
inline size_t bwd_smem_bytes(int dmax, int dvmax, int bt, int stages, int nlist) {
  const size_t row = (size_t)ld_f32(dmax) + ld_f32(dvmax);
  const size_t rows = bwd_rows(dmax, dvmax);
  return sizeof(float) * (rows * row + (size_t)stages * bt * row + bwd_xch_floats(bt)) +
         (nlist > 0 ? 4 * ((size_t)nlist + 1) : 0);
}

// Ring stages of the backward (2-4), or 0 when two do not fit: two blocks an
// SM where the kernel is built for it and two stages fit in half an SM, with
// as many stages as fit there; else as many as fit in one block's 227 KB.
inline int bwd_stages(int dmax, int dvmax, int bt, int nlist, bool two_blocks) {
  const size_t half_sm = kSmemPerSm / 2 - 1024;
  const size_t base = bwd_smem_bytes(dmax, dvmax, bt, 0, nlist);
  const size_t stage =
      bwd_smem_bytes(dmax, dvmax, bt, 1, 0) - bwd_smem_bytes(dmax, dvmax, bt, 0, 0);
  const size_t cap = two_blocks && base + 2 * stage <= half_sm ? half_sm : kMaxSmem;
  if (base + 2 * stage > cap) return 0;
  const size_t n = (cap - base) / stage;
  return n < 4 ? (int)n : 4;
}

// f.run<DMAX, DVMAX>() with the backward's compile-time column buckets (64
// or 256) of D and Dv
template <class F>
inline int dispatch_bwd(int d, int dv, const F& f) {
  if (d <= 64) return dv <= 64 ? f.template run<64, 64>() : f.template run<64, 256>();
  return dv <= 64 ? f.template run<256, 64>() : f.template run<256, 256>();
}

// K3a (DKV = false): dq of the BR = bwd_rows(DMAX, DVMAX) query rows of
// block (x, y) = (row tile, batch * head); K3b (DKV = true): dk and dv of
// its BR key rows. DMAX, DVMAX: the column buckets of D, Dv; BT =
// bwd_tile(DMAX, DVMAX).
template <typename T, bool DKV, int DMAX, int DVMAX, int BT>
__device__ inline void flash_bwd_body(const BwdParams<T>& p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int SIDES = bwd_sides(DMAX, DVMAX), RG = 8 / SIDES, BR = 16 * RG;
  constexpr int NT = BT / 8;                // 8-row steps of a streamed tile
  constexpr int NXD = DMAX / (8 * SIDES);   // 8-column steps of D a warp takes
  constexpr int NXV = DVMAX / (8 * SIDES);  // of Dv
  // element types of the resident Y (dO | V) and the streamed B (V | dO);
  // the resident X (Q | K) and the streamed A (K | Q) are T
  using TY = typename std::conditional<DKV, T, float>::type;
  using TB = typename std::conditional<DKV, float, T>::type;
  constexpr bool LO_T = F32, LO_Y = !DKV || F32, LO_B = DKV || F32;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp % RG, side = warp / RG, g = lane / 4, t = lane % 4;
  const int d = p.d, dv = p.dv;
  constexpr int ldx = DMAX + 4, ldy = DVMAX + 4;  // ld_f32 of the buckets
  const bool one_pass = p.fault == kFaultOneTf32Pass;
  // this warp's share of the 8-column steps of D and of Dv
  const int d0 = side * NXD, v0 = side * NXV;

  float* sX = reinterpret_cast<float*>(smem_raw);
  float* sY = sX + BR * ldx;
  float* ring = sY + BR * ldy;
  const int stage_floats = BT * (ldx + ldy);
  float* xch = ring + p.stages * stage_floats;
  int* list = reinterpret_cast<int*>(xch + bwd_xch_floats(BT));

  const size_t bh = blockIdx.y;
  const int r0 = blockIdx.x * BR;
  const int nres = DKV ? p.nk : p.nq, nstr = DKV ? p.nq : p.nk;
  const int nvalid = min(BR, nres - r0);
  const BwdKeys keys{p.bias != nullptr ? p.bias + bh * p.nk : nullptr, p.nk};
  const T* X = (DKV ? p.k : p.q) + (bh * nres + r0) * d;
  const TY* Y;
  const T* A;
  const TB* B;
  if constexpr (DKV) {
    Y = p.v + (bh * p.nk + r0) * dv;
    A = p.q + bh * p.nq * d;
    B = p.dout + bh * p.nq * dv;
  } else {
    Y = p.dout + (bh * p.nq + r0) * dv;
    A = p.k + bh * p.nk * d;
    B = p.v + bh * p.nk * dv;
  }

  // this thread's resident rows 16 rg + g + 8 rr: K3a the query rows' lse and
  // delta, K3b the key rows' bias
  float row_a[2], row_b[2];
  bool row_live[2];
  int out_block = blockIdx.x;
  if constexpr (DKV) {
    const TileBias tb = keys.tile_bias(r0);
    bool any = false;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      row_a[rr] = tb.at(16 * rg + g + 8 * rr);
      any |= row_a[rr] > kSkipThreshold;
    }
    bool live = __syncthreads_or(any) != 0;
    if (p.fault == kFaultSkipTile && blockIdx.x == 1) live = false;
    if (p.fault == kFaultDvWrongTile) out_block = (blockIdx.x + 1) % gridDim.x;
    const int nvalid_out = min(nvalid, p.nk - out_block * BR);
    if (!live) {  // a dead key block: dk = dv = 0, as the TPU kernel's init leaves them
      T* gk = p.gk + (bh * p.nk + r0) * d;
      T* gv = p.gv + (bh * p.nk + (size_t)out_block * BR) * dv;
      for (int i = threadIdx.x; i < nvalid * d; i += kBwdThreads) gk[i] = from_float<T>(0.0f);
      for (int i = threadIdx.x; i < nvalid_out * dv; i += kBwdThreads)
        gv[i] = from_float<T>(0.0f);
      return;
    }
  } else {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = 16 * rg + g + 8 * rr;
      const size_t at = bh * p.nq + r0 + r;
      row_a[rr] = r < nvalid ? p.lse[at] : kDeadLse;
      row_b[rr] = r < nvalid && p.fault != kFaultNoDelta ? p.delta[at] : 0.0f;
      row_live[rr] = row_a[rr] > kSkipThreshold || p.fault == kFaultUnsafeP;
    }
  }

  stage_rows<T, BR, DMAX>(sX, ldx, X, d, nvalid);
  stage_rows<TY, BR, DVMAX>(sY, ldy, Y, dv, nvalid);
  cp_async_commit();
  // K3a: the live key tiles, in order (a dead tile is never copied); K3b:
  // every query tile
  int ntiles;
  if constexpr (DKV)
    ntiles = (nstr + BT - 1) / BT;
  else
    ntiles = build_live_list<BT>(keys, list);
  auto first_row = [&](int i) { return (DKV ? i : list[i]) * BT; };
  auto fetch = [&](int i) {
    const int s0 = first_row(i);
    float* st = ring + (i % p.stages) * stage_floats;
    const int n = min(BT, nstr - s0);
    stage_rows<T, BT, DMAX>(st, ldx, A + (size_t)s0 * d, d, n);
    stage_rows<TB, BT, DVMAX>(st + BT * ldx, ldy, B + (size_t)s0 * dv, dv, n);
  };

  float acc1[NXD][4], acc2[DKV ? NXV : 1][4];
#pragma unroll
  for (int n = 0; n < NXD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[n][e] = 0.0f;
#pragma unroll
  for (int n = 0; n < (DKV ? NXV : 1); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc2[n][e] = 0.0f;
  // the exchange buffer of warp (side j, row group rg): [S, dP][NT][4][32]
  auto part = [&](int j) { return xch + (j * RG + rg) * 2 * NT * 128; };

  for (int s = 0; s < p.stages - 1; ++s) {
    if (s < ntiles) fetch(s);
    cp_async_commit();
  }
  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait_upto(p.stages - 2);  // tile i is in
    __syncthreads();                   // for every warp; all are done with tile i - 1
    if (i + p.stages - 1 < ntiles) fetch(i + p.stages - 1);  // into tile i - 1's stage
    cp_async_commit();
    const float* sA = ring + (i % p.stages) * stage_floats;
    const float* sB = sA + BT * ldx;
    const int s0 = first_row(i);
    // this thread's streamed rows 8n + 2t + e of the tile: K3a the keys'
    // bias, K3b the queries' lse and delta
    float col_a[NT][2], col_b[NT][2];
    if constexpr (DKV) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qr = s0 + 8 * n + 2 * t + e;
          col_a[n][e] = qr < p.nq ? p.lse[bh * p.nq + qr] : kDeadLse;
          col_b[n][e] = qr < p.nq ? p.delta[bh * p.nq + qr] : 0.0f;
        }
    } else {
      const TileBias tb = keys.tile_bias(s0);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) col_a[n][e] = tb.at(8 * n + 2 * t + e);
    }

    // S = X A^T and dP = Y B^T over this warp's share of D and of Dv, then
    // the sums of all shares, taken in the same order by every warp of the
    // row group (so all hold the same bits)
    float s[NT][4], dp[NT][4];
    auto scores = [&](auto one) {
      constexpr bool ONE = decltype(one)::value;
      mm_nt_3xtf32<NT, NXD, LO_T, LO_T, ONE>(s, sX + 16 * rg * ldx, ldx, sA, ldx, d0);
      mm_nt_3xtf32<NT, NXV, LO_Y, LO_B, ONE>(dp, sY + 16 * rg * ldy, ldy, sB, ldy, v0);
    };
    if (one_pass)
      scores(std::true_type{});
    else
      scores(std::false_type{});
    float* mine = part(side);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[(n * 4 + e) * 32 + lane] = s[n][e];
        mine[((NT + n) * 4 + e) * 32 + lane] = dp[n][e];
      }
    named_bar_sync(1 + rg, 32 * SIDES);  // the warps of the row group
    if constexpr (SIDES == 2) {  // a + b = b + a: the other share is enough
      const float* other = part(1 - side);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] += other[(n * 4 + e) * 32 + lane];
          dp[n][e] += other[((NT + n) * 4 + e) * 32 + lane];
        }
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int is = (n * 4 + e) * 32 + lane, ip = ((NT + n) * 4 + e) * 32 + lane;
          s[n][e] = (part(0)[is] + part(1)[is]) + (part(2)[is] + part(3)[is]);
          dp[n][e] = (part(0)[ip] + part(1)[ip]) + (part(2)[ip] + part(3)[ip]);
        }
    }

    // P and dS: element e of step n is resident row 16 rg + g + 8 (e / 2),
    // streamed row 8n + 2t + e % 2
    float pm[NT][4], ds[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e / 2, c = e % 2;
        float l, b, dl;
        bool live;
        if constexpr (DKV) {
          l = col_a[n][c];
          dl = col_b[n][c];
          b = row_a[rr];
          live = l > kSkipThreshold || p.fault == kFaultUnsafeP;
        } else {
          l = row_a[rr];
          dl = row_b[rr];
          b = col_a[n][c];
          live = row_live[rr];
        }
        const float pv = live ? expf(s[n][e] * p.scale + b - l) : 0.0f;
        pm[n][e] = pv;
        ds[n][e] = round_to<T>(pv * (dp[n][e] - dl));
      }
    // K3a: dq += dS K; K3b: dk += dS^T Q, dv += P^T dO (this warp's share
    // of the columns)
    auto grads = [&](auto one) {
      constexpr bool ONE = decltype(one)::value;
      mm_cn_3xtf32<NT, NXD, LO_T, LO_T, ONE>(acc1, ds, sA, ldx, d0);
      if constexpr (DKV) mm_cn_3xtf32<NT, NXV, true, true, ONE>(acc2, pm, sB, ldy, v0);
    };
    if (one_pass)
      grads(std::true_type{});
    else
      grads(std::false_type{});
  }
  cp_async_wait<0>();

  if constexpr (DKV) {
    store_acc(p.gk + (bh * p.nk + r0) * d, d, acc1, 16 * rg, d0, nvalid, p.scale);
    store_acc(p.gv + (bh * p.nk + (size_t)out_block * BR) * dv, dv, acc2, 16 * rg, v0,
              min(nvalid, p.nk - out_block * BR), 1.0f);
  } else {
    store_acc(p.gq + (bh * p.nq + r0) * d, d, acc1, 16 * rg, d0, nvalid, p.scale);
  }
}

}  // namespace flash
