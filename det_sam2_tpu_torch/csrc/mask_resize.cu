// cv2.resize(INTER_LINEAR) of float32 mask logits, bit for bit, for Hopper
// (sm_90a), CUDA C++.
//
// The JAX package's host resize of masks to video or image resolution
// (det_sam2_tpu/utils/misc.py:resize_masks_np) calls cv2.resize on the masks
// as the channels of one image, 128 at a time (its video predictor also
// resizes single objects' rows, one mask a call). It is host code there, not
// a TPU kernel; this kernel is how the port computes the same bits on the
// card. Mask m of n lies in group m / G (G masks a cv2 call: 128, or 1), as
// channel m % G of a group of cs = min(G, n - G * (m / G)) channels, and
// cv2 picks the path by cs:
//   * IPP at cs in {1, 3, 4}: p + t * (q - p) as one FMA, horizontal pass
//     first, the fractions from float64 rounded to float32 and zeroed where
//     the index is clamped. IPP's border rule: in the clamped columns that
//     the host flags (utils/cv2_resize.ipp_border) the vertical pass rounds
//     twice, p + round(t * (q - p)): flag 1 in channels 0-1 at cs = 3 and
//     in all at cs = 4, flag 2 at cs = 4 only;
//   * cv2's generic path otherwise: round(S0 * a0) + round(S1 * a1) in each
//     pass, no FMA; S[w - 1] copied where the index reaches the last
//     column; the vertical weights kept at the top and bottom edges. At an
//     exact 2x downscale on both axes cv2 takes INTER_AREA's fast path
//     instead: ((a + b) + c) + d, times 0.25.
// nvcc contracts a * b + c into an FMA by default, so every rounding is
// written out: __fmaf_rn where IPP fuses, __fmul_rn / __fadd_rn /
// __fsub_rn everywhere else (none of them is ever contracted). The taps
// come from the host (ops/mask_resize.py), computed as the plain version
// computes them.
//
// What bounds it on the H100: it writes N*H*W*4 bytes and reads the
// N*h*w*4 bytes of low-res logits (L2-resident, each read by many
// outputs): bytes, ~0.04 ms for 4 masks at 2160x3840 at 3.35 TB/s. The
// design follows the stores:
//   * a block is one mask's tile of `rows` output rows (8 to 32, the
//     wrapper's choice) by 256 columns, so the path (IPP, generic,
//     INTER_AREA) and the group are uniform in a block;
//   * a thread owns 4 adjacent columns and walks the tile's rows: its
//     x-taps are loaded once (16-byte loads), the block's y-taps once into
//     shared memory, and each row goes out as one 16-byte streaming store
//     where the row is 16-byte aligned (two 8-byte stores at 8 bytes, four
//     scalar ones otherwise; the last partial group column by column);
//   * the horizontal pass depends only on (source row, column), and the
//     rows' y0 and y1 never decrease down a tile, so a thread keeps the
//     horizontal values of the last two source rows (cv2's own row buffer)
//     and computes a source row's only when y0 or y1 moves on to it: once a
//     source row a tile instead of once an output row (an upscale from 256
//     to 720-2160 rows shares each among 3-8 output rows). The same
//     operations on the same inputs: the same bits;
//   * INTER_AREA at 2x reads the 8 source floats of its 4 columns a row as
//     two 16-byte loads.
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

// planted faults, for the checks that must catch them; production passes 0
constexpr int kFaultContract = 1;  // the generic path written as a * b + c * d
constexpr int kFaultNoBorder = 2;  // IPP's border rule ignored
constexpr int kFaultWrongPath = 3;  // the first group on the other path
constexpr int kFaultStaleRow = 4;  // the row cache not moved on when y0 reaches y1's row

constexpr int kThreads = 64;  // a block: 64 threads x 4 columns
constexpr int kMaxRows = 32;  // the tallest row tile

__device__ __forceinline__ void load4i(const int* p, int v[4]) {
  const int4 a = __ldg(reinterpret_cast<const int4*>(p));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}

__device__ __forceinline__ void load4f(const float* p, float v[4]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}

// o[0, cnt) = v[0, cnt), o at float offset off of a 16-byte aligned base;
// streaming stores (the output is written once and outgrows the L2)
__device__ __forceinline__ void store4(float* o, size_t off, int cnt, const float v[4]) {
  if (cnt == 4 && (off & 3) == 0) {
    __stcs(reinterpret_cast<float4*>(o), make_float4(v[0], v[1], v[2], v[3]));
  } else if (cnt == 4 && (off & 1) == 0) {
    __stcs(reinterpret_cast<float2*>(o), make_float2(v[0], v[1]));
    __stcs(reinterpret_cast<float2*>(o + 2), make_float2(v[2], v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < cnt) __stcs(o + j, v[j]);
  }
}

// the horizontal pass of source row r at the thread's 4 columns
__device__ __forceinline__ void hrow_ipp(const float* r, const int x0[4], const int x1[4],
                                         const float tx[4], float v[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float p = __ldg(r + x0[j]), q = __ldg(r + x1[j]);
    v[j] = __fmaf_rn(tx[j], __fsub_rn(q, p), p);
  }
}

__device__ __forceinline__ void hrow_generic(const float* r, const int x0[4], const int x1[4],
                                             const float a0[4], const float a1[4],
                                             unsigned copy, bool contract, float v[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float p = __ldg(r + x0[j]), q = __ldg(r + x1[j]);
    // plain operators under the planted fault: nvcc fuses p * a0 + q * a1
    // into fma(p, a0, q * a1)
    const float s = contract ? p * a0[j] + q * a1[j]
                             : __fadd_rn(__fmul_rn(p, a0[j]), __fmul_rn(q, a1[j]));
    v[j] = (copy >> j & 1u) ? p : s;
  }
}

__global__ void __launch_bounds__(kThreads)
mask_resize_kernel(const float* __restrict__ src, float* __restrict__ dst,
                   const int* __restrict__ idx, const float* __restrict__ wt, int n,
                   int group, int h, int w, int oh, int ow, int rows, int fault) {
  __shared__ int sy0[kMaxRows], sy1[kMaxRows];
  __shared__ float sb0[kMaxRows], sb1[kMaxRows];
  const int ow4 = (ow + 3) & ~3;
  const int x = 4 * (blockIdx.x * kThreads + threadIdx.x);
  const int ybeg = blockIdx.y * rows, nrows = min(rows, oh - ybeg);
  const int m = blockIdx.z;
  const int g = m / group, c = m - g * group;
  const int cs = min(group, n - g * group);
  bool ipp = cs == 1 || cs == 3 || cs == 4;
  if (fault == kFaultWrongPath && g == 0) ipp = !ipp;
  const bool area = !ipp && 2 * ow == w && 2 * oh == h;
  const float* s = src + (size_t)m * h * w;
  const int cnt = min(4, ow - x);  // columns of this thread (<= 0: none)
  // idx: [gx0, gx1, ix0, ix1, copy, border] (ow4 each), then [gy0, gy1,
  // iy0, iy1] (oh each); wt: [ga0, ga1, itx] (ow4 each), then [gb0, gb1,
  // ity] (oh each)
  if (!area) {
    const int t = threadIdx.x;
    if (t < nrows) {
      const int y = ybeg + t;
      const int* yi = idx + 6 * ow4 + (ipp ? 2 * oh : 0);
      const float* yw = wt + 3 * ow4 + (ipp ? 2 * oh : 0);
      sy0[t] = yi[y];
      sy1[t] = yi[oh + y];
      sb0[t] = yw[y];
      sb1[t] = ipp ? 0.f : yw[oh + y];
    }
    __syncthreads();
  }
  if (cnt <= 0) return;
  float* o = dst + ((size_t)m * oh + ybeg) * ow + x;
  size_t off = ((size_t)m * oh + ybeg) * ow + x;

  if (area) {
    for (int r = 0; r < nrows; ++r, o += ow, off += ow) {
      const float* r0 = s + (size_t)(2 * (ybeg + r)) * w + 2 * x;
      const float* r1 = r0 + w;
      float v[4];
      if (cnt == 4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(r0));
        const float4 b = __ldg(reinterpret_cast<const float4*>(r0 + 4));
        const float4 e = __ldg(reinterpret_cast<const float4*>(r1));
        const float4 f = __ldg(reinterpret_cast<const float4*>(r1 + 4));
        v[0] = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(a.x, a.y), e.x), e.y), 0.25f);
        v[1] = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(a.z, a.w), e.z), e.w), 0.25f);
        v[2] = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(b.x, b.y), f.x), f.y), 0.25f);
        v[3] = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(b.z, b.w), f.z), f.w), 0.25f);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = j < cnt ? __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(
                               __ldg(r0 + 2 * j), __ldg(r0 + 2 * j + 1)), __ldg(r1 + 2 * j)),
                               __ldg(r1 + 2 * j + 1)), 0.25f)
                         : 0.f;
        }
      }
      store4(o, off, cnt, v);
    }
    return;
  }

  // the thread's x-taps, once; padded columns (x >= ow) repeat the last
  // column's taps, so every load stays in the source row
  int x0[4], x1[4];
  float a0[4], a1[4];
  unsigned flag = 0;  // IPP: the columns that round twice; generic: copy
  int f[4];
  if (ipp) {
    load4i(idx + 2 * ow4 + x, x0);
    load4i(idx + 3 * ow4 + x, x1);
    load4f(wt + 2 * ow4 + x, a0);
    load4i(idx + 5 * ow4 + x, f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int border = fault == kFaultNoBorder ? 0 : f[j];
      const bool twice = (cs == 3 && c < 2 && border == 1) || (cs == 4 && border != 0);
      flag |= (unsigned)twice << j;
    }
  } else {
    load4i(idx + x, x0);
    load4i(idx + ow4 + x, x1);
    load4f(wt + x, a0);
    load4f(wt + ow4 + x, a1);
    load4i(idx + 4 * ow4 + x, f);
#pragma unroll
    for (int j = 0; j < 4; ++j) flag |= (unsigned)(f[j] != 0) << j;
  }
  const bool contract = fault == kFaultContract;

  // the horizontal values of source rows ca (the last y0) and cb (the
  // last y1)
  float pa[4], pb[4];
  int ca = -1, cb = -1;
  for (int r = 0; r < nrows; ++r, o += ow, off += ow) {
    const int y0 = sy0[r], y1 = sy1[r];
    if (y0 != ca) {
      if (y0 == cb) {
        if (fault != kFaultStaleRow) {
#pragma unroll
          for (int j = 0; j < 4; ++j) pa[j] = pb[j];
        }
      } else if (ipp) {
        hrow_ipp(s + (size_t)y0 * w, x0, x1, a0, pa);
      } else {
        hrow_generic(s + (size_t)y0 * w, x0, x1, a0, a1, flag, contract, pa);
      }
      ca = y0;
    }
    if (y1 != cb) {
      if (y1 == y0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) pb[j] = pa[j];
      } else if (ipp) {
        hrow_ipp(s + (size_t)y1 * w, x0, x1, a0, pb);
      } else {
        hrow_generic(s + (size_t)y1 * w, x0, x1, a0, a1, flag, contract, pb);
      }
      cb = y1;
    }
    float v[4];
    const float b0 = sb0[r], b1 = sb1[r];
    if (ipp) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = __fsub_rn(pb[j], pa[j]);
        v[j] = (flag >> j & 1u) ? __fadd_rn(pa[j], __fmul_rn(b0, d)) : __fmaf_rn(b0, d, pa[j]);
      }
    } else if (contract) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = pa[j] * b0 + pb[j] * b1;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = __fadd_rn(__fmul_rn(pa[j], b0), __fmul_rn(pb[j], b1));
    }
    store4(o, off, cnt, v);
  }
}

}  // namespace

// C entry for ctypes. src fp32 [n, h, w], dst fp32 [n, oh, ow], both
// 16-byte aligned; group: the masks of one cv2 call (1 to 128); idx int32
// [6 * ow4 + 4 * oh] and wt fp32 [3 * ow4 + 3 * oh] (ow4 = ow rounded up
// to 4), 16-byte aligned, the taps laid out as
// ops/mask_resize.py:mask_resize_taps packs them; rows: the row tile, 1 to
// 32. The grid is (ceil(ceil(ow / 4) / 64), ceil(oh / rows), n): so n <=
// 65535 and ceil(oh / rows) <= 65535, and the taps' offsets fit in int32.
// Returns the CUDA error code of the launch (0 = launched), or
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" int mask_resize(const void* src, void* dst, const void* idx, const void* wt, int n,
                           int group, int h, int w, int oh, int ow, int rows, int fault,
                           void* stream) {
  const long long ow4 = ((long long)ow + 3) / 4 * 4;
  const bool aligned = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
                         reinterpret_cast<uintptr_t>(idx) | reinterpret_cast<uintptr_t>(wt)) &
                        15) == 0;
  if (!aligned || n < 1 || n > 65535 || group < 1 || h < 1 || w < 1 || oh < 1 || ow < 1 ||
      rows < 1 || rows > kMaxRows || (oh + (long long)rows - 1) / rows > 65535 ||
      6 * ow4 + 4LL * oh > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((ow4 / 4 + kThreads - 1) / kThreads), (oh + rows - 1) / rows, n);
  mask_resize_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), static_cast<const int*>(idx),
      static_cast<const float*>(wt), n, group, h, w, oh, ow, rows, fault);
  return (int)cudaGetLastError();
}
