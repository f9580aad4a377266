// Per-row phase moments on one merged stream, for the narrowband fits.
//
// Replaces the Pallas kernel of scripts/tpu_moments_layout.py
// (make_merged_kernel / merged_call): the phase-moments reduction of
// moments.cu, reading Gr and Gi from ONE buffer g (rows, 2 nh) with
// g[:, :nh] = Gr and g[:, nh:] = Gi, harmonics in natural order.  For
// each row:
//
//   C   =          sum_k Re(G_k e^{2 pi i phi k})
//   Cp  = -2 pi    sum_k k   Im(G_k e^{2 pi i phi k})
//   Cpp = -4 pi^2  sum_k k^2 Re(G_k e^{2 pi i phi k})
//
// The narrowband fits (fitters/phase_shift.py, fitters/arrival_time.py)
// build their cross-spectrum once into this layout and launch this kernel
// once per Newton step.
//
// Bound on the H100: the 8 bytes of g per harmonic plus one sincosf.  At
// one subint (4096 rows, nh = 1025) that is 34 MB, ~10 us of HBM time:
// launch-latency sized.
// Design: one warp per row; the TPU kernel's rotated 128-lane phasor is
// not carried over, each element takes the double-single phasor of
// phase_trig.cuh.  With nh a multiple of 4 and a 16-byte aligned base each
// half is read by 128-bit loads (lane q takes harmonics 4q..4q+3, then
// strides 128); otherwise lanes stride single harmonics exactly as
// moments.cu does, and the sums come out in its order.
//
// Numerics: as moments.cu (the wrapper refuses nharm above 2^24).

#include <cstdint>

#include <cuda_runtime.h>

#include "phase_trig.cuh"

namespace {

constexpr int kWarps = 8;                       // rows per block
constexpr float kNegTwoPi = -6.28318530717958647692f;
constexpr float kNegFourPi2 = -39.4784176043574344753f;

__device__ __forceinline__ void accumulate(const pp::PhaseSplit& ph, int k,
                                           float x, float y, float* c0,
                                           float* c1, float* c2) {
  const float kf = static_cast<float>(k);
  float s, c;
  pp::phase_trig(ph, kf, &s, &c);
  const float zr = x * c - y * s;
  const float zi = x * s + y * c;
  *c0 += zr;
  *c1 += kf * zi;
  *c2 += (kf * kf) * zr;
}

template <bool kVec4>
__global__ void phase_moments_merged_kernel(const float* __restrict__ phis,
                                            const float* __restrict__ g,
                                            float* __restrict__ out,
                                            long long rows, int nh) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const pp::PhaseSplit ph = pp::phase_split(phis[row]);
  const float* a = g + row * 2 * nh;
  const float* b = a + nh;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  if (kVec4) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* b4 = reinterpret_cast<const float4*>(b);
    for (int q = lane; q < nh / 4; q += 32) {
      const float4 x = a4[q];
      const float4 y = b4[q];
      accumulate(ph, 4 * q, x.x, y.x, &c0, &c1, &c2);
      accumulate(ph, 4 * q + 1, x.y, y.y, &c0, &c1, &c2);
      accumulate(ph, 4 * q + 2, x.z, y.z, &c0, &c1, &c2);
      accumulate(ph, 4 * q + 3, x.w, y.w, &c0, &c1, &c2);
    }
  } else {
    for (int k = lane; k < nh; k += 32) {
      accumulate(ph, k, a[k], b[k], &c0, &c1, &c2);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c0 += __shfl_xor_sync(0xffffffffu, c0, off);
    c1 += __shfl_xor_sync(0xffffffffu, c1, off);
    c2 += __shfl_xor_sync(0xffffffffu, c2, off);
  }
  if (lane == 0) {
    out[row] = c0;
    out[rows + row] = kNegTwoPi * c1;
    out[2 * rows + row] = kNegFourPi2 * c2;
  }
}

}  // namespace

// phis (rows,), g (rows, 2 nh) f32 contiguous; out (3, rows) f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int pp_phase_moments_merged(const float* phis, const float* g,
                                       float* out, long long rows, int nh,
                                       cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  const bool vec4 =
      nh % 4 == 0 && reinterpret_cast<std::uintptr_t>(g) % 16 == 0;
  if (vec4) {
    phase_moments_merged_kernel<true>
        <<<blocks, kWarps * 32, 0, stream>>>(phis, g, out, rows, nh);
  } else {
    phase_moments_merged_kernel<false>
        <<<blocks, kWarps * 32, 0, stream>>>(phis, g, out, rows, nh);
  }
  return static_cast<int>(cudaGetLastError());
}
