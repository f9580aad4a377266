// Per-channel scattering moments for the (phi, DM, tau[, alpha]) Newton loop.
//
// Replaces pulseportraiture_tpu/ops/pallas_moments.py: _scat_kernel,
// _scat_kernel_kvec and _make_scat_kernel_ct (one kernel: the port keeps
// harmonics in natural order).  For each row (item, channel) with phase
// phi, scattering time tau [rot], cross-spectrum G = Gr + i Gi and template
// power M2 (one row per channel, shared by every item):
//
//   P = e^{2 pi i phi k},  B = 1/(1 + 2 pi i k tau),
//   f = dB/dtau = -2 pi i k B^2,  g = d2B/dtau2 = -8 pi^2 k^2 B^3,
//   GP = G P,  z = GP conj(B),  zf = GP conj(f),  zg = GP conj(g)
//
//   C   = sum Re z          S   = sum |B|^2 M2
//   Cp  = -2 pi sum k Im z  Rf  = sum Re zf     S1 = sum 2 Re(B conj f) M2
//   Cpp = -4 pi^2 sum k^2 Re z                  If1 = -2 pi sum k Im zf
//   Rg  = sum Re zg         S2  = sum 2 (|f|^2 + Re(B conj g)) M2
//
// (pallas_moments.py _scat_terms_ref; every sum accumulates in f32.)
//
// Bound on the H100: the 8 bytes of Gr/Gi per harmonic (M2 rows are read
// by every item of the batch and stay in L2), against one precise sincosf,
// one IEEE division and ~60 FP32 operations per harmonic.
// Design: as moments.cu, one warp per row; lanes stride over harmonics
// (coalesced, each element read once), nine f32 accumulators, one
// warp-shuffle reduction each.  The phasor is phase_trig.cuh's
// double-single one (the wrapper refuses nharm > 4097).

#include <cuda_runtime.h>

#include "phase_trig.cuh"

namespace {

constexpr int kWarps = 8;                       // rows per block
constexpr float kNegTwoPi = -6.28318530717958647692f;
constexpr float kNegFourPi2 = -39.4784176043574344753f;
constexpr float kNegEightPi2 = -78.9568352087148689506f;

__global__ void scat_moments_kernel(const float* __restrict__ phis,
                                    const float* __restrict__ taus,
                                    const float* __restrict__ gr,
                                    const float* __restrict__ gi,
                                    const float* __restrict__ m2,
                                    float* __restrict__ out, long long rows,
                                    long long m2_rows, int nh) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const pp::PhaseSplit ph = pp::phase_split(phis[row]);
  const float tau = taus[row];
  const float* a = gr + row * nh;
  const float* b = gi + row * nh;
  const float* m = m2 + (row % m2_rows) * nh;
  float acc[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) acc[j] = 0.0f;
  for (int k = lane; k < nh; k += 32) {
    const float kf = static_cast<float>(k);
    float s, c;
    pp::phase_trig(ph, kf, &s, &c);
    const float x = a[k];
    const float y = b[k];
    const float mm = m[k];
    const float ck = pp::kTwoPi * kf;           // 2 pi k
    const float ct = ck * tau;
    const float br = 1.0f / (1.0f + ct * ct);  // IEEE division
    const float bi = -ct * br;
    const float gpr = x * c - y * s;            // G P
    const float gpi = x * s + y * c;
    const float zr = gpr * br + gpi * bi;       // G P conj(B)
    const float zi = gpi * br - gpr * bi;
    const float cb2r = br * br - bi * bi;       // conj(B)^2
    const float cb2i = -2.0f * br * bi;
    const float cfr = -ck * cb2i;               // conj(f) = 2 pi i k conj(B)^2
    const float cfi = ck * cb2r;
    const float zfr = gpr * cfr - gpi * cfi;
    const float zfi = gpr * cfi + gpi * cfr;
    const float u1 = 2.0f * (br * cfr - bi * cfi);
    const float cb3r = cb2r * br + cb2i * bi;   // conj(B)^3
    const float cb3i = -cb2r * bi + cb2i * br;
    const float w2k2 = kNegEightPi2 * kf * kf;  // conj(g) = w2k2 conj(B)^3
    const float cgr = w2k2 * cb3r;
    const float cgi = w2k2 * cb3i;
    const float zgr = gpr * cgr - gpi * cgi;
    const float u2 = 2.0f * ((cfr * cfr + cfi * cfi) + (br * cgr - bi * cgi));
    acc[0] += zr;
    acc[1] += (br * br + bi * bi) * mm;
    acc[2] += kf * zi;
    acc[3] += zfr;
    acc[4] += u1 * mm;
    acc[5] += (kf * kf) * zr;
    acc[6] += kf * zfi;
    acc[7] += zgr;
    acc[8] += u2 * mm;
  }
#pragma unroll
  for (int j = 0; j < 9; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  }
  if (lane == 0) {
    out[row] = acc[0];
    out[rows + row] = acc[1];
    out[2 * rows + row] = kNegTwoPi * acc[2];
    out[3 * rows + row] = acc[3];
    out[4 * rows + row] = acc[4];
    out[5 * rows + row] = kNegFourPi2 * acc[5];
    out[6 * rows + row] = kNegTwoPi * acc[6];
    out[7 * rows + row] = acc[7];
    out[8 * rows + row] = acc[8];
  }
}

}  // namespace

// phis/taus (rows,), gr/gi (rows, nh), m2 (m2_rows, nh) f32 contiguous, row
// r reading m2 row r % m2_rows; out (9, rows) f32 in the order C, S, Cp,
// Rf, S1, Cpp, If1, Rg, S2.  Returns cudaGetLastError() after the launch.
extern "C" int pp_scat_moments(const float* phis, const float* taus,
                               const float* gr, const float* gi,
                               const float* m2, float* out, long long rows,
                               long long m2_rows, int nh,
                               cudaStream_t stream) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  scat_moments_kernel<<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                        stream>>>(phis, taus, gr, gi, m2, out, rows, m2_rows,
                                  nh);
  return static_cast<int>(cudaGetLastError());
}
