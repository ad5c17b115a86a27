// K2: bank-indirect memory cross-attention forward for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel det_sam2_tpu/ops/attention.py:_flash_banked_kernel,
// launched there by _flash_banked_call, together with its pre-pass
// (flash_banked_keys.cu). Single-head attention of q [B, Nq, D] over T
// memory tiles of S keys each: tile t's keys are the pre-pass's corrected
// keys, keys[b, t, :S] = round(mem_k[slots[t], b, layer] + corr_t) laid out
// [B, T, S_pad, D] with S_pad = S rounded up to the 64-key tile, and its
// values are read straight from the bank, mem_v[slots[t], b] (V stays
// bank-indirect). The bias [B, T*S] (0 / -1e30) skips dead key tiles; keys
// past S in a tile and the tiles of an out-of-range slot are dead; an object
// with no live key gets zeros. No lse, no backward: inference only, as on
// the TPU.
//
// What bounds it on the H100: at the slice (Nq = 4096, T = 8 tiles of
// S = 4096 keys, D = 256, Cm = 64) it does 2 * Nq * T*S * (D + Cm) FLOPs per
// object, ~86 GFLOP, over ~20 MB of bank rows: the tensor cores. The TPU
// kernel added the RoPE correction to every K block it fetched, with the
// tables resident in VMEM; a Hopper block that did so would rebuild every key
// once per 64-row query tile (64 times a launch, ~5 GB of L2 traffic). Here
// the keys are built once a launch by the pre-pass, and this kernel is K1's
// body (flash_common.cuh: TMA ring, wgmma, live-tile list) over them, with a
// 4-D tensor map that fetches each V tile from bank row slots[t] at a run-time
// row offset. fp32 runs K1's fp32 body over the same sources.
#include "flash_common.cuh"

namespace {

using flash::bf16;

struct BankSrc {
  const float* bias;  // this object's [T*S]
  const int* slots;   // [T]
  int b, nb, s, s_pad, ktot, ntile, row;
  const CUtensorMap* tm_k;  // bf16: keys [B, T*S_pad, D]
  const CUtensorMap* tm_v;  // bf16: mem_v [Ktot, B, S, Cm]
  const float* keys;        // fp32: this object's [T*S_pad, D]
  const float* mem_v;       // fp32: [Ktot, B, S, Cm]
  int d, cm;

  __device__ int num_tiles(int bk) const { return ntile * s_pad / bk; }
  __device__ bool has_bias() const { return true; }
  // key0: the tile's first key in the object's T*S_pad padded keys (a tile
  // never straddles two bank tiles: S_pad is a multiple of the tile)
  __device__ flash::TileBias tile_bias(int key0) const {
    const int t = key0 / s_pad, j0 = key0 - t * s_pad;
    const int slot = slots[t];
    if (slot < 0 || slot >= ktot) return {nullptr, 0};
    return {bias + (size_t)t * s + j0, s - j0};
  }
  __device__ void load_tile(int tile, unsigned char* sk, unsigned char* sv, int np, int nvp,
                            uint64_t* bar) const {
    const int key0 = tile * 64, t = key0 / s_pad, j0 = key0 - t * s_pad;
    const int slot = slots[t];
    for (int p = 0; p < np; ++p)
      flash::tma_load_3d(sk + p * flash::kPanelBytes, tm_k, bar, 64 * p, key0, b);
    for (int p = 0; p < nvp; ++p)
      flash::tma_load_4d(sv + p * flash::kPanelBytes, tm_v, bar, 64 * p, j0, b, slot);
  }
  __device__ void rows(int tile, int bk, const float*& kp, const float*& vp, int& nk_valid,
                       int& nv_valid) const {
    const int key0 = tile * bk, t = key0 / s_pad, j0 = key0 - t * s_pad;
    kp = keys + (size_t)key0 * d;
    vp = mem_v + (((size_t)slots[t] * nb + b) * s + j0) * cm;
    nk_valid = bk;
    nv_valid = min(bk, s - j0);
  }
};

__device__ inline BankSrc bank_src(const float* bias, const int* slots, int nb, int s, int s_pad,
                                   int ktot, int ntile) {
  BankSrc src{};
  src.b = src.row = blockIdx.y;
  src.bias = bias + (size_t)blockIdx.y * ntile * s;
  src.slots = slots;
  src.nb = nb;
  src.s = s;
  src.s_pad = s_pad;
  src.ktot = ktot;
  src.ntile = ntile;
  return src;
}

template <int KS, int NVP, int NWG>
__global__ void __launch_bounds__(flash::threads_bf16(NWG), NVP <= 2 && NWG == 1 ? 2 : 1)
flash_banked_bf16(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ slots,
                  const float* __restrict__ bias, bf16* __restrict__ out, int nb, int nq, int cm,
                  int ktot, int s, int s_pad, int ntile, float scale, int stages) {
  BankSrc src = bank_src(bias, slots, nb, s, s_pad, ktot, ntile);
  src.tm_k = &tm_k;
  src.tm_v = &tm_v;
  flash::flash_body_bf16<KS, NVP, NWG>(src, &tm_q, out, nullptr, nq, cm, scale, stages, 0);
}

template <int DVMAX, int BK, int BQ>
__global__ void __launch_bounds__(flash::kThreads)
flash_banked_f32(const float* __restrict__ q, const float* __restrict__ keys,
                 const float* __restrict__ mem_v, const int* __restrict__ slots,
                 const float* __restrict__ bias, float* __restrict__ out, int nb, int nq, int d,
                 int cm, int ktot, int s, int s_pad, int ntile, float scale) {
  BankSrc src = bank_src(bias, slots, nb, s, s_pad, ktot, ntile);
  src.keys = keys + (size_t)blockIdx.y * ntile * s_pad * d;
  src.mem_v = mem_v;
  src.d = d;
  src.cm = cm;
  flash::flash_body_f32<DVMAX, BK, BQ>(src, q, out, nullptr, nq, d, cm, scale, 0);
}

// the launch of the bf16 kernel with the compile-time shape <KS, NVP, NWG>
struct LaunchBf16 {
  dim3 grid;
  size_t smem;
  cudaStream_t st;
  const CUtensorMap &tq, &tk, &tv;
  const int* slots;
  const float* bias;
  bf16* out;
  int nb, nq, cm, ktot, s, s_pad, ntile;
  float scale;
  int stages;
  template <int KS, int NVP, int NWG>
  int run() const {
    return flash::launch_kernel_n(flash_banked_bf16<KS, NVP, NWG>, grid,
                                  flash::threads_bf16(NWG), smem, st, tq, tk, tv, slots, bias,
                                  out, nb, nq, cm, ktot, s, s_pad, ntile, scale, stages);
  }
};

int launch_bf16(const void* q, const void* keys, const void* mem_v, const int* slots,
                const float* bias, void* out, int nb, int nq, int d, int cm, int ktot, int s,
                int s_pad, int ntile, float scale, cudaStream_t st) {
  CUtensorMap tq, tk, tv;
  const uint64_t dq[3] = {(uint64_t)d, (uint64_t)nq, (uint64_t)nb};
  const uint64_t sq[2] = {2ull * d, 2ull * nq * d};
  const uint64_t nkeys = (uint64_t)ntile * s_pad;
  const uint64_t dk[3] = {(uint64_t)d, nkeys, (uint64_t)nb};
  const uint64_t sk[2] = {2ull * d, 2ull * nkeys * d};
  const uint64_t dv4[4] = {(uint64_t)cm, (uint64_t)s, (uint64_t)nb, (uint64_t)ktot};
  const uint64_t sv4[3] = {2ull * cm, 2ull * s * cm, 2ull * nb * s * cm};
  int err = flash::encode_bf16_map(&tq, q, 3, dq, sq);
  if (!err) err = flash::encode_bf16_map(&tk, keys, 3, dk, sk);
  if (!err) err = flash::encode_bf16_map(&tv, mem_v, 4, dv4, sv4);
  if (err) return err;
  const dim3 grid((nq + flash::kBQ - 1) / flash::kBQ, nb);
  const long long blocks = (long long)grid.x * grid.y;
  const int nwg = flash::consumer_groups(cm, blocks);
  const int ntiles = ntile * s_pad / flash::kBK16;
  const int stages = flash::ring_stages(d, cm, ntiles, blocks, nwg);
  if (stages < 2) return flash::kErrSmem;
  const size_t smem = flash::smem_bytes_bf16(d, cm, stages, ntiles);
  return flash::dispatch_bf16(d, cm, nwg,
                              LaunchBf16{grid, smem, st, tq, tk, tv, slots, bias,
                                         static_cast<bf16*>(out), nb, nq, cm, ktot, s, s_pad,
                                         ntile, scale, stages});
}

template <int DVMAX>
int launch_f32(const float* q, const float* keys, const float* mem_v, const int* slots,
               const float* bias, float* out, int nb, int nq, int d, int cm, int ktot, int s,
               int s_pad, int ntile, float scale, cudaStream_t st) {
  const int nkeys = ntile * s_pad;
  const flash::F32Tile tile = flash::f32_tile(d, cm, nkeys);
  if (tile.bk == 0) return flash::kErrSmem;
  const dim3 grid((nq + tile.bq - 1) / tile.bq, nb);
  const size_t smem = flash::smem_bytes_f32(d, cm, tile.bq, tile.bk, nkeys / tile.bk);
  if constexpr (DVMAX <= 128)  // f32_tile takes 128 rows only where Dv <= 128
    if (tile.bq == 128)
      return flash::launch_kernel(flash_banked_f32<DVMAX, 32, 128>, grid, smem, st, q, keys,
                                  mem_v, slots, bias, out, nb, nq, d, cm, ktot, s, s_pad, ntile,
                                  scale);
  if (tile.bk == 64)
    return flash::launch_kernel(flash_banked_f32<DVMAX, 64, 64>, grid, smem, st, q, keys, mem_v,
                                slots, bias, out, nb, nq, d, cm, ktot, s, s_pad, ntile, scale);
  return flash::launch_kernel(flash_banked_f32<DVMAX, 32, 64>, grid, smem, st, q, keys, mem_v,
                              slots, bias, out, nb, nq, d, cm, ktot, s, s_pad, ntile, scale);
}

}  // namespace

// C entry for ctypes. dtype: 0 = fp32, 1 = bf16 (q, keys, mem_v and out);
// keys [B, T, S_pad, D] from flash_banked_keys; slots int32 [T]; bias fp32
// [B, T*S]; S_pad a multiple of 64; D, Cm multiples of 8 (D of 16). Returns
// 0 when launched, else the CUDA error code of the launch or one of
// flash_common.cuh's kErr* codes.
extern "C" int flash_banked_fwd(const void* q, const void* keys, const void* mem_v,
                                const void* slots, const void* bias, void* out, int nb, int nq,
                                int d, int cm, int ktot, int s, int s_pad, int ntile, int dtype,
                                float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slots);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == 1)
    return launch_bf16(q, keys, mem_v, sl, bi, out, nb, nq, d, cm, ktot, s, s_pad, ntile, scale,
                       st);
  const float *qq = static_cast<const float*>(q), *kk = static_cast<const float*>(keys),
              *vv = static_cast<const float*>(mem_v);
  float* oo = static_cast<float*>(out);
  const int cmr = flash::round_up(cm, 32);
  if (cmr <= 64)
    return launch_f32<64>(qq, kk, vv, sl, bi, oo, nb, nq, d, cm, ktot, s, s_pad, ntile, scale, st);
  if (cmr <= 128)
    return launch_f32<128>(qq, kk, vv, sl, bi, oo, nb, nq, d, cm, ktot, s, s_pad, ntile, scale,
                           st);
  return launch_f32<256>(qq, kk, vv, sl, bi, oo, nb, nq, d, cm, ktot, s, s_pad, ntile, scale, st);
}
