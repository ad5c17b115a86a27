// K1: flash-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel det_sam2_tpu/ops/attention.py:_flash_kernel (and
// _flash_kernel_nobias), launched there by _flash_call. Computes
//   out = softmax(q k^T / sqrt(D) + bias) v,   lse = logsumexp of the row,
// for q, k [BH, N, D], v [BH, Nk, Dv] (Dv may differ from D), an optional
// fp32 additive key bias [BH, Nk] of 0 / -1e30, bf16 or fp32 inputs with fp32
// accumulation. Key tiles whose bias is all below -1e29 are never read, and a
// row with no live key comes out as zeros (not NaN).
//
// What bounds it on the H100: at the main path's shapes (Nq = 4096, Nk = 4096
// or 28736, D = 96 or 256) the two products do ~2 * Nq * Nk * (D + Dv) FLOPs
// on a few MB of input, so the tensor cores (989 TFLOP/s bf16), and in the
// fp32 training step the CUDA cores (67 TFLOP/s), not the 3.35 TB/s of memory.
// What the design does about it (flash_common.cuh): bf16 keeps the tensor
// cores fed from a TMA ring filled by a producer warp while a consumer
// warpgroup runs both products as wgmma with scores, P and O in registers,
// overlapping each tile's softmax with the previous tile's P V product.
// 64 query rows a block, so the serving shapes launch 128-256 blocks for the
// 132 SMs: two blocks an SM where the grid exceeds the SMs, else two
// consumer warpgroups a block that split its key tiles (no key split across
// blocks, so no combine pass). fp32 runs exact FMAs in register micro-tiles
// over a cp.async double buffer: 128 query rows a block where two such
// blocks fit an SM (the hiera-b+ shape), else 64 rows with the key tile (64
// or 32) that lets the most blocks share an SM. Dead tiles cost neither
// copies nor FLOPs.
#include "flash_common.cuh"

namespace {

using flash::bf16;

struct DenseSrc {
  const float* bias;  // this row's [Nk] or nullptr
  int nk, row;        // row: the (batch * head) index
  const CUtensorMap* tm_k;  // bf16: [BH, Nk, D]
  const CUtensorMap* tm_v;  // bf16: [BH, Nk, Dv]
  const float* k;     // fp32: this row's [Nk, D]
  const float* v;     // fp32: this row's [Nk, Dv]
  int d, dv;

  __device__ int num_tiles(int bk) const { return (nk + bk - 1) / bk; }
  __device__ bool has_bias() const { return bias != nullptr; }
  __device__ flash::TileBias tile_bias(int key0) const {
    return {bias != nullptr ? bias + key0 : nullptr, nk - key0};
  }
  // bf16: the TMA copies of tile `tile` (64 keys) into the ring stage
  __device__ void load_tile(int tile, unsigned char* sk, unsigned char* sv, int np, int nvp,
                            uint64_t* bar) const {
    for (int p = 0; p < np; ++p)
      flash::tma_load_3d(sk + p * flash::kPanelBytes, tm_k, bar, 64 * p, tile * 64, row);
    for (int p = 0; p < nvp; ++p)
      flash::tma_load_3d(sv + p * flash::kPanelBytes, tm_v, bar, 64 * p, tile * 64, row);
  }
  // fp32: the K and V rows of tile `tile` of bk keys and how many are valid
  __device__ void rows(int tile, int bk, const float*& kp, const float*& vp, int& nk_valid,
                       int& nv_valid) const {
    const int k0 = tile * bk;
    kp = k + (size_t)k0 * d;
    vp = v + (size_t)k0 * dv;
    nk_valid = nv_valid = min(bk, nk - k0);
  }
};

template <int KS, int NVP, int NWG>
__global__ void __launch_bounds__(flash::threads_bf16(NWG), NVP <= 2 && NWG == 1 ? 2 : 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ bias,
               bf16* __restrict__ out, float* __restrict__ lse, int nq, int nk, int dv,
               float scale, int stages, int fault) {
  DenseSrc src{};
  src.row = blockIdx.y;
  src.nk = nk;
  src.bias = bias != nullptr ? bias + (size_t)blockIdx.y * nk : nullptr;
  src.tm_k = &tm_k;
  src.tm_v = &tm_v;
  flash::flash_body_bf16<KS, NVP, NWG>(src, &tm_q, out, lse, nq, dv, scale, stages, fault);
}

template <int DVMAX, int BK, int BQ>
__global__ void __launch_bounds__(flash::kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              float* __restrict__ out, float* __restrict__ lse, int nq, int nk, int d, int dv,
              float scale, int fault) {
  DenseSrc src{};
  src.row = blockIdx.y;
  src.nk = nk;
  src.bias = bias != nullptr ? bias + (size_t)blockIdx.y * nk : nullptr;
  src.k = k + (size_t)blockIdx.y * nk * d;
  src.v = v + (size_t)blockIdx.y * nk * dv;
  src.d = d;
  src.dv = dv;
  flash::flash_body_f32<DVMAX, BK, BQ>(src, q, out, lse, nq, d, dv, scale, fault);
}

// the launch of the bf16 kernel with the compile-time shape <KS, NVP, NWG>
struct LaunchBf16 {
  dim3 grid;
  size_t smem;
  cudaStream_t st;
  const CUtensorMap &tq, &tk, &tv;
  const float* bias;
  bf16* out;
  float* lse;
  int nq, nk, dv;
  float scale;
  int stages, fault;
  template <int KS, int NVP, int NWG>
  int run() const {
    return flash::launch_kernel_n(flash_fwd_bf16<KS, NVP, NWG>, grid, flash::threads_bf16(NWG),
                                  smem, st, tq, tk, tv, bias, out, lse, nq, nk, dv, scale, stages,
                                  fault);
  }
};

int launch_bf16(const void* q, const void* k, const void* v, const float* bias, void* out,
                float* lse, int bh, int nq, int nk, int d, int dv, float scale, int fault,
                cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  const uint64_t dq[3] = {(uint64_t)d, (uint64_t)nq, (uint64_t)bh};
  const uint64_t sq[2] = {2ull * d, 2ull * nq * d};
  const uint64_t dk[3] = {(uint64_t)d, (uint64_t)nk, (uint64_t)bh};
  const uint64_t sk[2] = {2ull * d, 2ull * nk * d};
  const uint64_t dvv[3] = {(uint64_t)dv, (uint64_t)nk, (uint64_t)bh};
  const uint64_t svv[2] = {2ull * dv, 2ull * nk * dv};
  int err = flash::encode_bf16_map(&tq, q, 3, dq, sq);
  if (!err) err = flash::encode_bf16_map(&tk, k, 3, dk, sk);
  if (!err) err = flash::encode_bf16_map(&tv, v, 3, dvv, svv);
  if (err) return err;
  const dim3 grid((nq + flash::kBQ - 1) / flash::kBQ, bh);
  const long long blocks = (long long)grid.x * grid.y;
  const int nwg = flash::consumer_groups(dv, blocks);
  const int ntiles = (nk + flash::kBK16 - 1) / flash::kBK16;
  const int stages = flash::ring_stages(d, dv, ntiles, blocks, nwg);
  if (stages < 2) return flash::kErrSmem;
  const size_t smem = flash::smem_bytes_bf16(d, dv, stages, ntiles);
  return flash::dispatch_bf16(d, dv, nwg,
                              LaunchBf16{grid, smem, st, tq, tk, tv, bias, static_cast<bf16*>(out),
                                         lse, nq, nk, dv, scale, stages, fault});
}

template <int DVMAX>
int launch_f32_dv(const float* q, const float* k, const float* v, const float* bias, float* out,
                  float* lse, int bh, int nq, int nk, int d, int dv, float scale, int fault,
                  cudaStream_t st) {
  const flash::F32Tile tile = flash::f32_tile(d, dv, nk);
  if (tile.bk == 0) return flash::kErrSmem;
  const dim3 grid((nq + tile.bq - 1) / tile.bq, bh);
  const int ntiles = (nk + tile.bk - 1) / tile.bk;
  const size_t smem = flash::smem_bytes_f32(d, dv, tile.bq, tile.bk, ntiles);
  if constexpr (DVMAX <= 128)  // f32_tile takes 128 rows only where Dv <= 128
    if (tile.bq == 128)
      return flash::launch_kernel(flash_fwd_f32<DVMAX, 32, 128>, grid, smem, st, q, k, v, bias,
                                  out, lse, nq, nk, d, dv, scale, fault);
  if (tile.bk == 64)
    return flash::launch_kernel(flash_fwd_f32<DVMAX, 64, 64>, grid, smem, st, q, k, v, bias,
                                out, lse, nq, nk, d, dv, scale, fault);
  return flash::launch_kernel(flash_fwd_f32<DVMAX, 32, 64>, grid, smem, st, q, k, v, bias, out,
                              lse, nq, nk, d, dv, scale, fault);
}

}  // namespace

// C entry for ctypes. dtype: 0 = fp32, 1 = bf16. bias and lse may be null.
// fault: 0, or a planted fault of flash_common.cuh (checks only). Returns 0
// when launched, else the CUDA error code of the launch or one of
// flash_common.cuh's kErr* codes.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* bias,
                         void* out, void* lse, int bh, int nq, int nk, int d, int dv,
                         int dtype, float scale, int fault, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* l = static_cast<float*>(lse);
  if (dtype == 1) return launch_bf16(q, k, v, b, out, l, bh, nq, nk, d, dv, scale, fault, st);
  const float *qq = static_cast<const float*>(q), *kk = static_cast<const float*>(k),
              *vv = static_cast<const float*>(v);
  float* oo = static_cast<float*>(out);
  const int dvr = flash::round_up(dv, 32);
  if (dvr <= 64)
    return launch_f32_dv<64>(qq, kk, vv, b, oo, l, bh, nq, nk, d, dv, scale, fault, st);
  if (dvr <= 128)
    return launch_f32_dv<128>(qq, kk, vv, b, oo, l, bh, nq, nk, d, dv, scale, fault, st);
  return launch_f32_dv<256>(qq, kk, vv, b, oo, l, bh, nq, nk, d, dv, scale, fault, st);
}
