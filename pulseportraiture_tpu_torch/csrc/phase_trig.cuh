// Phasors e^{2 pi i phi k} in float32 for the moments kernels: the
// double-single phase_trig (moments.cu, moments_merged.cu) and the
// once-rounded phase_trig_rn (the factors of scat_moments.cu).
//
// Matches fitters/stats.py _phase_trig step for step:
//   * built WITHOUT --use_fast_math: sincosf is the precise libdevice
//     routine, never __sinf/__cosf;
//   * rounding is rintf (half-to-even, like torch.round/jnp.round), never
//     roundf (half-away);
//   * the double-single steps use __fmul_rn/__fadd_rn/__fsub_rn so nvcc
//     cannot contract them into FMAs;
//   * hi = rint(8192 p)/8192 with |p| <= 1/2, so 8192*hi is an integer of
//     at most 12 bits plus sign and hi*k is exact in f32 while
//     |8192 hi| * k <= 2^24, i.e. k <= 4096.  nbin 4096 gives k <= 2048
//     (2^23): exact.  The wrappers (ops/moments.py) refuse nharm > 4097.
#pragma once

namespace pp {

constexpr float kTwoPi = 6.28318530717958647692f;

// phi split into hi (13-bit multiple of 1/8192) and lo, after wrapping
// phi to [-1/2, 1/2].
struct PhaseSplit {
  float hi;
  float lo;
};

__device__ __forceinline__ PhaseSplit phase_split(float phi) {
  const float p = __fsub_rn(phi, rintf(phi));
  const float hi = rintf(__fmul_rn(p, 8192.0f)) * (1.0f / 8192.0f);
  return {hi, __fsub_rn(p, hi)};
}

// sin/cos of 2 pi phi k: hi*k reduced mod 1 exactly, plus lo*k.
__device__ __forceinline__ void phase_trig(const PhaseSplit& ph, float kf,
                                           float* s, float* c) {
  const float prod = __fmul_rn(ph.hi, kf);
  const float frac = __fsub_rn(prod, rintf(prod));
  const float ang = __fmul_rn(kTwoPi, __fadd_rn(frac, __fmul_rn(ph.lo, kf)));
  sincosf(ang, s, c);
}

// phi wrapped to [-1/2, 1/2] (exact).
__device__ __forceinline__ float phase_wrap(float phi) {
  return __fsub_rn(phi, rintf(phi));
}

// sin/cos of 2 pi p k for a wrapped p (phase_wrap) with the angle rounded
// once to float32: p k (24 x 14 bits) and its reduction mod 1 are exact in
// float64, then 2 pi times it is rounded.  The factors of the scattering
// kernel's phasor (scat_moments.cu); twin: ops/moments._phase_trig_rn.
// phase_trig's angle carries the float32 2 pi and two more roundings, and
// a product of three such factors strays further from e^{2 pi i phi k}
// than the direct phasor does.
__device__ __forceinline__ void phase_trig_rn(float p, float kf, float* s,
                                              float* c) {
  const double x = __dmul_rn(static_cast<double>(p), static_cast<double>(kf));
  const double f = __dsub_rn(x, rint(x));
  sincosf(static_cast<float>(__dmul_rn(6.283185307179586476925, f)), s, c);
}

}  // namespace pp
