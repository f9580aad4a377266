// Register-resident passes of a Stockham autosort FFT of NZ = 2^LG complex
// points (64 <= NZ <= 2048), for csrc/setup_fft.cu.
//
// NZ/16 threads share one transform and each holds 16 points in registers
// in every pass.  The passes are radix 16, then radix 16 again while 16
// divides what is left, then one pass of radix 2, 4 or 8 (NZ = 1024: 16,
// 16, 4): two or three trips through shared memory instead of the five or
// six of a radix-4 walk.  A pass of radix R with p the product of the
// earlier radices takes, for butterfly i < NZ/R, the points i + r NZ/R,
// twiddles point r by e^{-2 pi i r k/(R p)} (k = i mod p), transforms them
// in registers and writes result m to (i - k) R + k + m p.  Thread l takes
// the butterflies l + (NZ/16) b, b < 16/R.
//
// Twiddles come from a table (ops/setup_dft._fft_tables_np): per twiddled
// pass the runs r = 1 .. R-1 of p entries each.  The first pass has p = 1
// and no twiddles; its 16 results are neighbours, so it writes a padded
// layout (one float2 of padding after every 16) that keeps the 16 threads
// of a half-warp on different banks; the second pass reads that layout.
// Every later access has neighbouring threads on neighbouring points.

#pragma once

namespace ppfft {

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
// a * (-i)
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}

// In-register forward DFTs, natural order in and out:
// a[m] <- sum_r a[r] e^{-2 pi i r m/R}.
template <int R>
__device__ __forceinline__ void dft(float2* a);

template <>
__device__ __forceinline__ void dft<2>(float2* a) {
  const float2 u = a[0], v = a[1];
  a[0] = cadd(u, v);
  a[1] = csub(u, v);
}

template <>
__device__ __forceinline__ void dft<4>(float2* a) {
  const float2 v0 = cadd(a[0], a[2]), v1 = csub(a[0], a[2]);
  const float2 v2 = cadd(a[1], a[3]), v3 = mul_mi(csub(a[1], a[3]));
  a[0] = cadd(v0, v2);
  a[1] = cadd(v1, v3);
  a[2] = csub(v0, v2);
  a[3] = csub(v1, v3);
}

// n = 2 n1 + n2, m = m1 + 4 m2: 4-point DFTs over n1, the twiddle
// e^{-2 pi i n2 m1/8}, 2-point DFTs over n2.
template <>
__device__ __forceinline__ void dft<8>(float2* a) {
  constexpr float H = 0.70710678118654752440f;
  float2 e[4] = {a[0], a[2], a[4], a[6]};
  float2 o[4] = {a[1], a[3], a[5], a[7]};
  dft<4>(e);
  dft<4>(o);
  o[1] = make_float2(H * (o[1].x + o[1].y), H * (o[1].y - o[1].x));
  o[2] = mul_mi(o[2]);
  o[3] = make_float2(H * (o[3].y - o[3].x), -H * (o[3].x + o[3].y));
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    a[m] = cadd(e[m], o[m]);
    a[m + 4] = csub(e[m], o[m]);
  }
}

// n = 4 n1 + n2, m = m1 + 4 m2: 4-point DFTs over n1, the twiddle
// e^{-2 pi i n2 m1/16}, 4-point DFTs over n2.
template <>
__device__ __forceinline__ void dft<16>(float2* a) {
  constexpr float H = 0.70710678118654752440f;   // cos(pi/4)
  constexpr float C = 0.92387953251128675613f;   // cos(pi/8)
  constexpr float S = 0.38268343236508977173f;   // sin(pi/8)
  float2 b[4][4];                                // b[n2][m1]
#pragma unroll
  for (int n2 = 0; n2 < 4; ++n2) {
    b[n2][0] = a[n2];
    b[n2][1] = a[4 + n2];
    b[n2][2] = a[8 + n2];
    b[n2][3] = a[12 + n2];
    dft<4>(b[n2]);
  }
  // e^{-2 pi i e/16} for e = n2 m1: 1, 2, 3 / 2, 4, 6 / 3, 6, 9
  b[1][1] = cmul(b[1][1], make_float2(C, -S));
  b[1][2] = make_float2(H * (b[1][2].x + b[1][2].y),
                        H * (b[1][2].y - b[1][2].x));
  b[1][3] = cmul(b[1][3], make_float2(S, -C));
  b[2][1] = make_float2(H * (b[2][1].x + b[2][1].y),
                        H * (b[2][1].y - b[2][1].x));
  b[2][2] = mul_mi(b[2][2]);
  b[2][3] = make_float2(H * (b[2][3].y - b[2][3].x),
                        -H * (b[2][3].x + b[2][3].y));
  b[3][1] = cmul(b[3][1], make_float2(S, -C));
  b[3][2] = make_float2(H * (b[3][2].y - b[3][2].x),
                        -H * (b[3][2].x + b[3][2].y));
  b[3][3] = cmul(b[3][3], make_float2(-C, S));
#pragma unroll
  for (int m1 = 0; m1 < 4; ++m1) {
    float2 c[4] = {b[0][m1], b[1][m1], b[2][m1], b[3][m1]};
    dft<4>(c);
#pragma unroll
    for (int m2 = 0; m2 < 4; ++m2) a[m1 + 4 * m2] = c[m2];
  }
}

// The passes of an NZ = 2^LG point transform.
template <int LG>
struct Plan {
  static_assert(LG >= 6 && LG <= 11, "64 <= NZ <= 2048");
  static constexpr int NZ = 1 << LG;
  static constexpr int NA = NZ / 16;             // threads with work
  static constexpr int R2 = LG >= 8 ? 16 : 1 << (LG - 4);   // second pass
  static constexpr int R3 = LG > 8 ? 1 << (LG - 8) : 1;     // third, or none
  static constexpr int TW2 = 0;                  // table offsets (float2)
  static constexpr int TW3 = (R2 - 1) * 16;
  static constexpr int NTW = TW3 + (R3 > 1 ? (R3 - 1) * 256 : 0);
  static constexpr int WSZ = NZ + NZ / 16;       // padded buffer, float2
};

// points read as they lie (a buffer after the second pass, or a float row)
struct Plain {
  const float2* p;
  __device__ __forceinline__ float2 operator()(int i) const { return p[i]; }
};
// the first pass's padded layout
struct Padded {
  const float2* p;
  __device__ __forceinline__ float2 operator()(int i) const {
    return p[i + (i >> 4)];
  }
};
// a raw int16 row
struct FromI16 {
  const short2* p;
  __device__ __forceinline__ float2 operator()(int i) const {
    const short2 s = p[i];
    return make_float2(static_cast<float>(s.x), static_cast<float>(s.y));
  }
};

// thread l's 16 points of a radix-R pass: v[b R + r] = src(i_b + r NZ/R)
template <int R, int NZ, class Src>
__device__ __forceinline__ void pass_load(float2* v, const Src& src, int l) {
  constexpr int NB = 16 / R, T = NZ / R;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int r = 0; r < R; ++r) v[b * R + r] = src(l + (NZ / 16) * b + r * T);
}

// twiddle, transform and write thread l's butterflies of a radix-R pass
// with stride P (tw: this pass's table; PAD: write the padded layout)
template <int R, int NZ, int P, bool PAD>
__device__ __forceinline__ void pass_store(float2* v, float2* dst,
                                           const float2* tw, int l) {
  constexpr int NB = 16 / R;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    const int i = l + (NZ / 16) * b;
    const int k = i & (P - 1);
    float2* a = v + b * R;
    if (P > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r) a[r] = cmul(a[r], tw[(r - 1) * P + k]);
    }
    dft<R>(a);
    const int base = (i - k) * R + k;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int idx = base + m * P;
      dst[PAD ? idx + (idx >> 4) : idx] = a[m];
    }
  }
}

// The transform of one row by its NA threads, in phases; the caller puts a
// barrier of those threads between two phases.  v: the thread's 16
// registers, carried from a load phase to the store phase after it.
// phase 0: raw row -> first pass -> buf (padded)
// phase 1: load for the second pass         phase 2: second pass -> buf
// phase 3: load for the third pass          phase 4: third pass -> buf
// (phases 3 and 4 only when Plan<LG>::R3 > 1).  buf then holds Z in
// natural order, unpadded.
template <int LG, class Raw>
__device__ __forceinline__ void fft_phase0(float2* v, const Raw& raw,
                                           float2* buf, int l) {
  constexpr int NZ = Plan<LG>::NZ;
  pass_load<16, NZ>(v, raw, l);
  pass_store<16, NZ, 1, true>(v, buf, nullptr, l);
}
template <int LG>
__device__ __forceinline__ void fft_phase1(float2* v, const float2* buf,
                                           int l) {
  pass_load<Plan<LG>::R2, Plan<LG>::NZ>(v, Padded{buf}, l);
}
template <int LG>
__device__ __forceinline__ void fft_phase2(float2* v, float2* buf,
                                           const float2* tw, int l) {
  pass_store<Plan<LG>::R2, Plan<LG>::NZ, 16, false>(
      v, buf, tw + Plan<LG>::TW2, l);
}
template <int LG>
__device__ __forceinline__ void fft_phase3(float2* v, const float2* buf,
                                           int l) {
  pass_load<Plan<LG>::R3, Plan<LG>::NZ>(v, Plain{buf}, l);
}
template <int LG>
__device__ __forceinline__ void fft_phase4(float2* v, float2* buf,
                                           const float2* tw, int l) {
  pass_store<Plan<LG>::R3, Plan<LG>::NZ, 256, false>(
      v, buf, tw + Plan<LG>::TW3, l);
}

}  // namespace ppfft
