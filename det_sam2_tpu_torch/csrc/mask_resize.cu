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
// outputs): bytes, ~0.04 ms for 4 masks at 2160x3840 at 3.35 TB/s. One
// thread per output value, neighbouring threads on neighbouring columns so
// that the stores coalesce; each recomputes the two horizontal values it
// needs (exact: the same operations on the same inputs).
#include <cuda_runtime.h>

namespace {

// planted faults, for the checks that must catch them; production passes 0
constexpr int kFaultContract = 1;  // the generic path written as a * b + c * d
constexpr int kFaultNoBorder = 2;  // IPP's border rule ignored
constexpr int kFaultWrongPath = 3;  // the first group on the other path

__global__ void __launch_bounds__(256)
mask_resize_kernel(const float* __restrict__ src, float* __restrict__ dst,
                   const int* __restrict__ idx, const float* __restrict__ wt, int n,
                   int group, int h, int w, int oh, int ow, int fault) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y, m = blockIdx.z;
  if (x >= ow) return;
  const int g = m / group, c = m - g * group;
  const int cs = min(group, n - g * group);
  bool ipp = cs == 1 || cs == 3 || cs == 4;
  if (fault == kFaultWrongPath && g == 0) ipp = !ipp;
  const float* s = src + (size_t)m * h * w;
  float out;
  if (ipp) {
    // idx: ix0, ix1 at [2ow, 4ow), border at [5ow, 6ow), iy0, iy1 at
    // 6ow + [2oh, 4oh); wt: itx at [2ow, 3ow), ity at 3ow + [2oh, 3oh)
    const int x0 = idx[2 * ow + x], x1 = idx[3 * ow + x];
    const int y0 = idx[6 * ow + 2 * oh + y], y1 = idx[6 * ow + 3 * oh + y];
    const float tx = wt[2 * ow + x], ty = wt[3 * ow + 2 * oh + y];
    const float* r0 = s + (size_t)y0 * w;
    const float* r1 = s + (size_t)y1 * w;
    const float p = __fmaf_rn(tx, __fsub_rn(r0[x1], r0[x0]), r0[x0]);
    const float q = __fmaf_rn(tx, __fsub_rn(r1[x1], r1[x0]), r1[x0]);
    const float d = __fsub_rn(q, p);
    const int border = fault == kFaultNoBorder ? 0 : idx[5 * ow + x];
    const bool twice = (cs == 3 && c < 2 && border == 1) || (cs == 4 && border != 0);
    out = twice ? __fadd_rn(p, __fmul_rn(ty, d)) : __fmaf_rn(ty, d, p);
  } else if (2 * ow == w && 2 * oh == h) {
    const float* r0 = s + (size_t)(2 * y) * w + 2 * x;
    const float* r1 = r0 + w;
    out = __fmul_rn(__fadd_rn(__fadd_rn(__fadd_rn(r0[0], r0[1]), r1[0]), r1[1]), 0.25f);
  } else {
    // idx: gx0, gx1 at [0, 2ow), copy at [4ow, 5ow), gy0, gy1 at
    // 6ow + [0, 2oh); wt: ga0, ga1 at [0, 2ow), gb0, gb1 at 3ow + [0, 2oh)
    const int x0 = idx[x], x1 = idx[ow + x];
    const bool copy = idx[4 * ow + x] != 0;
    const int y0 = idx[6 * ow + y], y1 = idx[6 * ow + oh + y];
    const float a0 = wt[x], a1 = wt[ow + x];
    const float b0 = wt[3 * ow + y], b1 = wt[3 * ow + oh + y];
    const float* r0 = s + (size_t)y0 * w;
    const float* r1 = s + (size_t)y1 * w;
    if (fault == kFaultContract) {
      // plain operators: nvcc fuses each a * b + c * d into fma(a, b, c * d)
      const float p = copy ? r0[x0] : r0[x0] * a0 + r0[x1] * a1;
      const float q = copy ? r1[x0] : r1[x0] * a0 + r1[x1] * a1;
      out = p * b0 + q * b1;
    } else {
      const float p = copy ? r0[x0] : __fadd_rn(__fmul_rn(r0[x0], a0), __fmul_rn(r0[x1], a1));
      const float q = copy ? r1[x0] : __fadd_rn(__fmul_rn(r1[x0], a0), __fmul_rn(r1[x1], a1));
      out = __fadd_rn(__fmul_rn(p, b0), __fmul_rn(q, b1));
    }
  }
  dst[((size_t)m * oh + y) * ow + x] = out;
}

}  // namespace

// C entry for ctypes. src fp32 [n, h, w], dst fp32 [n, oh, ow]; group: the
// masks of one cv2 call (1 to 128); idx int32
// [6 * ow + 4 * oh] and wt fp32 [3 * ow + 3 * oh], the taps laid out as
// ops/mask_resize.py:mask_resize_taps packs them; oh, n <= 65535. Returns
// the CUDA error code of the launch (0 = launched).
extern "C" int mask_resize(const void* src, void* dst, const void* idx, const void* wt, int n,
                           int group, int h, int w, int oh, int ow, int fault,
                           void* stream) {
  const dim3 grid((ow + 255) / 256, oh, n);
  mask_resize_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst), static_cast<const int*>(idx),
      static_cast<const float*>(wt), n, group, h, w, oh, ow, fault);
  return (int)cudaGetLastError();
}
