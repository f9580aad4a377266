// Per-channel phase moments for the (phi, DM) Newton loop.
//
// Replaces pulseportraiture_tpu/ops/pallas_moments.py: _phase_kernel,
// _phase_kernel_kvec and _make_phase_kernel_ct (one kernel: the port keeps
// harmonics in natural order).  For each row (item, channel):
//
//   C   =          sum_k Re(G_k e^{2 pi i phi k})
//   Cp  = -2 pi    sum_k k   Im(G_k e^{2 pi i phi k})
//   Cpp = -4 pi^2  sum_k k^2 Re(G_k e^{2 pi i phi k})
//
// Bound on the H100: the 8 bytes of Gr/Gi per harmonic plus one sincosf.
// Design: one warp per row; lanes stride over harmonics (coalesced, each
// element read once), f32 accumulation, one warp-shuffle reduction.
//
// Numerics: the double-single phasor of phase_trig.cuh (the steps of
// fitters/stats.py _phase_trig, exact in hi*k at any k; the wrapper refuses
// nharm above 2^24, where k stops being exact in f32).

#include <cuda_runtime.h>

#include "phase_trig.cuh"

namespace {

constexpr int kWarps = 8;                       // rows per block
constexpr float kNegTwoPi = -6.28318530717958647692f;
constexpr float kNegFourPi2 = -39.4784176043574344753f;

__global__ void phase_moments_kernel(const float* __restrict__ phis,
                                     const float* __restrict__ gr,
                                     const float* __restrict__ gi,
                                     float* __restrict__ out,
                                     long long rows, int nh) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const pp::PhaseSplit ph = pp::phase_split(phis[row]);
  const float* a = gr + row * nh;
  const float* b = gi + row * nh;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  for (int k = lane; k < nh; k += 32) {
    const float kf = static_cast<float>(k);
    float s, c;
    pp::phase_trig(ph, kf, &s, &c);
    const float x = a[k];
    const float y = b[k];
    const float zr = x * c - y * s;
    const float zi = x * s + y * c;
    c0 += zr;
    c1 += kf * zi;
    c2 += (kf * kf) * zr;
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

// phis (rows,), gr/gi (rows, nh) f32 contiguous; out (3, rows) f32.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int pp_phase_moments(const float* phis, const float* gr,
                                const float* gi, float* out, long long rows,
                                int nh, cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  phase_moments_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                         stream>>>(phis, gr, gi, out, rows, nh);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
