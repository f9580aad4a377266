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
//   * hi = rint(8192 p)/8192 with |p| <= 1/2, so n = 8192*hi is an integer
//     of at most 12 bits plus sign.  hi*k is formed with k reduced mod 8192
//     into [-4096, 4096]: k' = k - 8192 rint(k/8192), exact in f32 for
//     |k| <= 2^24 (k/8192 and 8192 rint(.) are exact, and so is the
//     difference).  hi*k - hi*k' = n rint(k/8192) is an integer, so the
//     fraction of the turn is unchanged, and |n k'| <= 2^24 keeps hi*k'
//     exact in f32 at any k.  lo*k keeps the true k.  For |k| <= 4096,
//     k' = k: the same bits as the plain double-single split.  Chosen over
//     a wider hi (more bits of n) because that would cut the range of k at
//     which hi*k is exact, and over a float64 product because the moments
//     kernels take one sincosf a harmonic and an f64 multiply on top of it
//     costs more than three exact f32 steps.
//   * worst angle error, from the roundings of lo*k (|lo k| <= 2^-14 k
//     turns), of frac + lo*k and of the f32 2 pi times it: about 6e-7 rad
//     at k <= 4096 and 1.3e-6 rad at k = 16384 (2^-23 turn, measured over
//     a grid of phases; tests/test_torch_stats.py holds it to 2e-6 rad
//     there).  The wrappers (ops/moments.py) refuse nharm above 2^24,
//     where k itself stops being exact in f32.
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

// k reduced mod 8192 into [-4096, 4096] (exact; k itself for |k| <= 4096).
__device__ __forceinline__ float harmonic_mod8192(float kf) {
  return __fsub_rn(kf, __fmul_rn(8192.0f,
                                 rintf(__fmul_rn(kf, 1.0f / 8192.0f))));
}

// sin/cos of 2 pi phi k: hi*k reduced mod 1 exactly (through k mod 8192),
// plus lo*k.
__device__ __forceinline__ void phase_trig(const PhaseSplit& ph, float kf,
                                           float* s, float* c) {
  const float prod = __fmul_rn(ph.hi, harmonic_mod8192(kf));
  const float frac = __fsub_rn(prod, rintf(prod));
  const float ang = __fmul_rn(kTwoPi, __fadd_rn(frac, __fmul_rn(ph.lo, kf)));
  sincosf(ang, s, c);
}

// phi wrapped to [-1/2, 1/2] (exact).
__device__ __forceinline__ float phase_wrap(float phi) {
  return __fsub_rn(phi, rintf(phi));
}

// sin/cos of 2 pi p k for a wrapped p (phase_wrap) with the angle rounded
// once to float32: p k (24 x 24 bits at most, any k exact in f32) and its
// reduction mod 1 are exact in float64, then 2 pi times it is rounded.
// The factors of the scattering kernel's phasor (scat_moments.cu); twin:
// ops/moments._phase_trig_rn.
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
