// Register-resident passes of a Stockham autosort FFT of NZ = M 2^LG2
// complex points, M odd in 1..15 and 32 <= 2^LG2 <= 4096 (2^LG2 >= 128
// when M > 1), for csrc/setup_fft.cu and csrc/load_stats.cu.
//
// NZ/16 threads share one transform and each holds 16 points in registers
// in every power-of-two pass.  The passes are radix 16, then radix 16 again
// while 16 divides what is left of 2^LG2, then one pass of radix 2, 4, 8 or
// 16 (2^LG2 = 32: 16, 2; 1024: 16, 16, 4; 4096: 16, 16, 16): two or three
// trips through shared memory instead of the five or six of a radix-4
// walk.  A pass of radix R with p
// the product of the earlier radices takes, for butterfly i < NZ/R, the
// points i + r NZ/R, twiddles point r by e^{-2 pi i r k/(R p)} (k = i mod
// p), transforms them in registers and writes result m to (i - k) R + k +
// m p.  Thread l takes the butterflies l + (NZ/16) b, b < 16/R.  Nothing
// in those passes needs NZ to be a power of two, only p.
//
// When M > 1 a last pass of radix M closes the transform (p = 2^LG2, so
// k = i and result m lands at i + m 2^LG2: natural order).  16 points a
// thread do not split into M-point butterflies, so that pass has a thread
// layout of its own: the worker's WT threads (a power of two, WT <= 2^LG2)
// take the 2^LG2 butterflies i = l + WT j, j < 2^LG2/WT, M points each
// (at most 15), one after another in place.  Its M-point DFT pairs the points r and M - r
// and takes cos and sin of 2 pi j/M from a table of float64 values rounded
// once (kOddTrig).
//
// Twiddles come from a table (ops/setup_dft._fft_tables_np), in shared or
// global memory: per twiddled
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

// cos and sin of 2 pi j/M, j = 1 .. (M-1)/2, for odd M = 3 .. 15 (row
// (M-3)/2): the float64 values rounded once to float32
static __constant__ float2 kOddTrig[7][7] = {
    {{-0.5f, 0.8660254f}},
    {{0.309017f, 0.95105654f}, {-0.809017f, 0.58778524f}},
    {{0.6234898f, 0.7818315f}, {-0.22252093f, 0.9749279f},
     {-0.90096885f, 0.43388373f}},
    {{0.76604444f, 0.64278764f}, {0.17364818f, 0.9848077f},
     {-0.5f, 0.8660254f}, {-0.9396926f, 0.34202015f}},
    {{0.8412535f, 0.54064083f}, {0.41541502f, 0.90963197f},
     {-0.14231484f, 0.98982143f}, {-0.65486073f, 0.7557496f},
     {-0.959493f, 0.28173256f}},
    {{0.885456f, 0.46472317f}, {0.56806475f, 0.82298386f},
     {0.12053668f, 0.99270886f}, {-0.3546049f, 0.9350162f},
     {-0.7485108f, 0.66312265f}, {-0.97094184f, 0.23931566f}},
    {{0.9135454f, 0.40673664f}, {0.6691306f, 0.7431448f},
     {0.309017f, 0.95105654f}, {-0.104528464f, 0.9945219f},
     {-0.5f, 0.8660254f}, {-0.809017f, 0.58778524f},
     {-0.9781476f, 0.20791169f}}};

// The forward DFT of odd length M in registers, natural order in and out,
// from the pairs p_r = a_r + a_{M-r}, q_r = a_r - a_{M-r} (r <= (M-1)/2):
//   a[k], a[M-k] = a_0 + sum_r p_r cos(2 pi r k/M) -/+ i sum_r q_r sin(.)
template <int M>
__device__ __forceinline__ void dft_odd(float2* a) {
  constexpr int H = (M - 1) / 2, T = (M - 3) / 2;
  float2 p[H], q[H];
  float2 s = a[0];
#pragma unroll
  for (int r = 0; r < H; ++r) {
    p[r] = cadd(a[r + 1], a[M - 1 - r]);
    q[r] = csub(a[r + 1], a[M - 1 - r]);
    s = cadd(s, p[r]);
  }
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    float2 re = a[0], im = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      const int j = (r * k) % M;                 // angle 2 pi j/M
      const float c = j == 0   ? 1.0f               // M = 9, 15: r k = M
                      : j <= H ? kOddTrig[T][j - 1].x
                               : kOddTrig[T][M - j - 1].x;
      const float sn = j == 0   ? 0.0f
                       : j <= H ? kOddTrig[T][j - 1].y
                                : -kOddTrig[T][M - j - 1].y;
      re.x = fmaf(p[r - 1].x, c, re.x);
      re.y = fmaf(p[r - 1].y, c, re.y);
      im.x = fmaf(q[r - 1].x, sn, im.x);
      im.y = fmaf(q[r - 1].y, sn, im.y);
    }
    a[k] = make_float2(re.x + im.y, re.y - im.x);          // re - i im
    a[M - k] = make_float2(re.x - im.y, re.y + im.x);      // re + i im
  }
  a[0] = s;
}

// The passes of an NZ = M 2^LG2 point transform.
template <int M_, int LG2>
struct Plan {
  static_assert(LG2 >= 5 && LG2 <= 12, "32 <= 2^LG2 <= 4096");
  static_assert(M_ == 1 || (M_ % 2 == 1 && M_ <= 15 && LG2 >= 7),
                "M odd in 3..15 over at least 128 points");
  static constexpr int M = M_;
  static constexpr int N2 = 1 << LG2;            // the power-of-two factor
  static constexpr int NZ = M_ * N2;
  static constexpr int NA = NZ / 16;             // threads with work
  static constexpr int R2 = LG2 >= 8 ? 16 : 1 << (LG2 - 4);  // second pass
  static constexpr int R3 = LG2 > 8 ? 1 << (LG2 - 8) : 1;    // third, or none
  static constexpr int TW2 = 0;                  // table offsets (float2)
  static constexpr int TW3 = (R2 - 1) * 16;
  static constexpr int TWM = TW3 + (R3 > 1 ? (R3 - 1) * 256 : 0);
  static constexpr int NTW = TWM + (M_ - 1) * N2;
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
// (phases 3 and 4 only when P::R3 > 1).  With P = Plan<1, LG2> buf then
// holds Z in natural order, unpadded; with M > 1, after the odd pass.
template <class P, class Raw>
__device__ __forceinline__ void fft_phase0(float2* v, const Raw& raw,
                                           float2* buf, int l) {
  pass_load<16, P::NZ>(v, raw, l);
  pass_store<16, P::NZ, 1, true>(v, buf, nullptr, l);
}
template <class P>
__device__ __forceinline__ void fft_phase1(float2* v, const float2* buf,
                                           int l) {
  pass_load<P::R2, P::NZ>(v, Padded{buf}, l);
}
template <class P>
__device__ __forceinline__ void fft_phase2(float2* v, float2* buf,
                                           const float2* tw, int l) {
  pass_store<P::R2, P::NZ, 16, false>(v, buf, tw + P::TW2, l);
}
template <class P>
__device__ __forceinline__ void fft_phase3(float2* v, const float2* buf,
                                           int l) {
  pass_load<P::R3, P::NZ>(v, Plain{buf}, l);
}
template <class P>
__device__ __forceinline__ void fft_phase4(float2* v, float2* buf,
                                           const float2* tw, int l) {
  pass_store<P::R3, P::NZ, 256, false>(v, buf, tw + P::TW3, l);
}

// The odd pass (P::M > 1), by all WT threads of the worker: thread l's
// butterflies i = l + WT j, j < N2/WT.  Butterfly i reads the points i +
// r N2 and writes its result m to i + m N2 (natural order): the same
// points, which no other butterfly touches, so each is loaded,
// twiddled, transformed and written in turn with no barrier between its
// loads and its stores, and only its M points are held in registers.
// seen(j, u) is called with each transformed butterfly.
template <class P, int WT, class Seen>
__device__ __forceinline__ void odd_pass(float2* buf, const float2* tw,
                                         int l, Seen&& seen) {
  const float2* twm = tw + P::TWM;
#pragma unroll
  for (int j = 0; j < P::N2 / WT; ++j) {
    const int i = l + WT * j;
    float2 u[P::M];
#pragma unroll
    for (int r = 0; r < P::M; ++r) u[r] = buf[i + r * P::N2];
#pragma unroll
    for (int r = 1; r < P::M; ++r)
      u[r] = cmul(u[r], twm[(r - 1) * P::N2 + i]);
    dft_odd<P::M>(u);
#pragma unroll
    for (int m = 0; m < P::M; ++m) buf[i + m * P::N2] = u[m];
    seen(j, u);
  }
}

}  // namespace ppfft

// Every plan (M, LG2), nbin = 2 M 2^LG2: the powers of two 64 .. 8192,
// then 256 q for odd q = M 2^(LG2 - 7) <= 16 (nbin 768 .. 3840).  X(M, LG2)
// is called with each; ops/setup_dft.setup_route mirrors the list.
#define PP_FFT_PLANS(X)                                                  \
  X(1, 5) X(1, 6) X(1, 7) X(1, 8) X(1, 9) X(1, 10) X(1, 11) X(1, 12)    \
  X(3, 7) X(3, 8) X(3, 9) X(5, 7) X(5, 8) X(7, 7) X(7, 8) X(9, 7)       \
  X(11, 7) X(13, 7) X(15, 7)
