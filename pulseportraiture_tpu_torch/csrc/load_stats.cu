// The per-profile statistics of an int16 archive at load, from its raw
// samples and DAT_SCL: each profile's windowed-minimum baseline, its
// power-spectrum noise, and the sum and maximum of the baseline-removed
// profile.  Computes what ops/load_stats.profile_stats_reference computes.
//
// Replaces no TPU kernel: the JAX package (io/archive.py's load_data) and
// the port's host route compute these in numpy on the decoded float32 cube
// (Archive.remove_baseline, ops/noise.get_noise_PS(chans=True), get_SNR).
// get_TOAs' float32 fits on the card take it instead, so that a campaign's
// load does not spend its time in host passes over that cube (about 60% of
// a pptoas call at 512 x 2048 x 8 subints).
//
// Bound on the H100: bytes.  A profile needs its 2 nbin bytes of int16
// read once against ~2.5 (nbin/2) log2(nbin/2) flops of its FFT and ~10
// integer operations a sample of its window sums; 4 floats a profile out.
//
// Design:
//   * One block a profile, nbin/8 threads (at least a warp).  The row
//     arrives in shared memory once, as int16, in 16-byte loads.
//   * The noise: sqrt of the mean over k >= int(0.75 (nbin/2 + 1)) of
//     |X_k|^2 / nbin.  The row's spectrum is an nbin/2-point complex FFT of
//     z_j = raw_2j + i raw_2j+1 through csrc/fft_passes.cuh (setup_fft.cu's
//     passes: nbin/32 threads x 16 points in registers, the odd pass of a
//     mixed-radix plan by a power of two of the block's threads), in the
//     bytes of the work buffer that the window sums take afterwards.  Only
//     the top quarter's harmonics are untangled, X_{N/2-k} = conj(E + i
//     W^k O) from the pair (Z_k, Z_{N/2-k}), and DAT_SCL multiplies the
//     result: |scl X(raw)| is the spectrum of x = scl raw within rounding.
//   * The baseline, as Archive.remove_baseline picks it: S_i the sum of the
//     wlen = max(1, int(0.15 nbin)) samples after i (wrapped), the window
//     of the first minimum of the sums of wlen consecutive S_i, its mean
//     subtracted.  Exactly: x_j = fl32(scl raw_j) is a multiple of ulp(scl)
//     = 2^(e - 24) (scl = m 2^e, 1/2 <= m < 1) below 2^39 of them, so x_j /
//     ulp(scl) is an int64 and every prefix sum of both levels is an exact
//     integer (|sum| < (nbin + wlen) wlen 2^39 < 2^63 up to nbin 8192): the
//     window picked is the first minimum of exact arithmetic, whatever the
//     order of summation, as in the twin.  Prefix sums by a block scan of 8
//     samples a thread (warp shuffles, then the warps' totals in shared
//     memory), one int64 array of nbin + 1 in shared memory for both levels
//     (the window sums S stay in the registers that computed them while the
//     second level's prefix overwrites the first).
//   * DAT_OFFS is not read: it moves the DC harmonic, which the noise
//     leaves out, and the baseline by itself; the caller adds it back where
//     it subtracts the baseline from the decoded cube.
//   * No atomics, fixed reduction orders: the same bits on every run.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "fft_passes.cuh"

namespace {

constexpr int SAMPLES = 8;           // samples a thread in the window sums

constexpr int pow2_floor(int n) {
  int p = 1;
  while (2 * p <= n) p *= 2;
  return p;
}

// The block of the plan P (nbin = 2 P::NZ): its threads, and the threads of
// the odd pass (a power of two that divides P::N2)
template <class P>
struct Shape {
  static constexpr int NBIN = 2 * P::NZ;
  static constexpr int NT = NBIN / SAMPLES > 32 ? NBIN / SAMPLES : 32;
  static constexpr int CP = NBIN / NT;                // samples a thread
  static constexpr int NW = NT / 32;
  static constexpr int WTO = pow2_floor(NT) < P::N2 ? pow2_floor(NT) : P::N2;
  // dynamic shared memory: the int16 row, then the work buffer (the FFT's
  // padded float2 buffer, then the nbin + 1 int64 prefix sums)
  static constexpr size_t WORK = (P::WSZ > NBIN + 1 ? P::WSZ : NBIN + 1) * 8;
  static constexpr size_t SMEM = 2 * NBIN + WORK;
  static_assert(NT % 32 == 0 && NT <= 1024 && NT >= P::NA, "block");
  static_assert(NBIN % NT == 0 && (2 * NBIN) % 16 == 0, "row split");
};

// exclusive prefix of v over the block's threads in order, and the block's
// total; ws: NW slots.  Ends before a barrier: the caller's next barrier
// must come before ws is written again.
template <int NW>
__device__ __forceinline__ long long scan_block(long long v, long long* ws,
                                                long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long t = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += t;
  }
  if (lane == 31) ws[warp] = inc;
  __syncthreads();
  long long before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const long long s = ws[w];
    before += w < warp ? s : 0;
    all += s;
  }
  *total = all;
  return before + inc - v;
}

// The prefix array A = C[0 .. nbin] read at j in 0 .. nbin + wlen: past
// nbin the sums wrap, C[j] = C[j - nbin] + C[nbin].
__device__ __forceinline__ long long wrapped(const long long* A, int j,
                                             int nbin) {
  return j <= nbin ? A[j] : A[j - nbin] + A[nbin];
}

// out (4, nprof): baseline, noise, sum and max of the baseline-removed
// profile, float32
template <int M, int LG2>
__global__ void __launch_bounds__(Shape<ppfft::Plan<M, LG2>>::NT)
load_stats_kernel(const short* __restrict__ raw,
                  const float* __restrict__ scale,
                  const float2* __restrict__ tw, float* __restrict__ out,
                  long long nprof, int wlen) {
  using P = ppfft::Plan<M, LG2>;
  using S = Shape<P>;
  constexpr int NBIN = S::NBIN, NT = S::NT, CP = S::CP, NW = S::NW;
  constexpr int NZ = P::NZ;
  constexpr int KC = (3 * (NZ + 1)) / 4;         // first noise harmonic
  constexpr int K2 = NZ - KC;                    // pairs k = 0 .. K2

  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long ws[NW];
  __shared__ float wpw[NW], wmax[NW];
  __shared__ long long wbest[NW];
  __shared__ int wib[NW];

  short* row = reinterpret_cast<short*>(smem);
  float2* buf = reinterpret_cast<float2*>(smem + 2 * NBIN);
  long long* A = reinterpret_cast<long long*>(smem + 2 * NBIN);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;
  const float scl = scale[b];

  // the row, 16 bytes a thread at a time
  {
    const int4* src = reinterpret_cast<const int4*>(raw + b * NBIN);
    int4* dst = reinterpret_cast<int4*>(row);
    for (int i = tid; i < NBIN / 8; i += NT) dst[i] = src[i];
  }
  __syncthreads();

  // the packed spectrum Z, natural order, in buf
  {
    float2 v[16];
    if (tid < P::NA)
      ppfft::fft_phase0<P>(
          v, ppfft::FromI16{reinterpret_cast<const short2*>(row)}, buf, tid);
    __syncthreads();
    if (tid < P::NA) ppfft::fft_phase1<P>(v, buf, tid);
    __syncthreads();
    if (tid < P::NA) ppfft::fft_phase2<P>(v, buf, tw, tid);
    if constexpr (P::R3 > 1) {
      __syncthreads();
      if (tid < P::NA) ppfft::fft_phase3<P>(v, buf, tid);
      __syncthreads();
      if (tid < P::NA) ppfft::fft_phase4<P>(v, buf, tw, tid);
    }
    if constexpr (M > 1) {
      __syncthreads();
      if (tid < S::WTO)
        ppfft::odd_pass<P, S::WTO>(buf, tw, tid, [](int, const float2*) {});
    }
  }
  __syncthreads();

  // the top quarter's power, X_{NZ-k} for k = 0 .. K2 (k = 0: the Nyquist
  // term a - b of Z_0 = a + i b)
  float pw = 0.0f;
  {
    const float2* untw = tw + P::NTW;            // W^k, k <= NZ/2
    for (int k = tid; k <= K2; k += NT) {
      if (k == 0) {
        const float ny = buf[0].x - buf[0].y;
        pw += ny * ny;
      } else {
        const float2 zk = buf[k], zq = buf[NZ - k];
        const float er = 0.5f * (zk.x + zq.x), ei = 0.5f * (zk.y - zq.y);
        const float o_r = 0.5f * (zk.x - zq.x), o_i = 0.5f * (zk.y + zq.y);
        const float2 wk = untw[k];
        const float tr = wk.x * o_r - wk.y * o_i;
        const float ti = wk.x * o_i + wk.y * o_r;
        const float xr = er - ti, xi = ei + tr;
        pw += xr * xr + xi * xi;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    pw += __shfl_xor_sync(0xffffffffu, pw, off);
  if (lane == 0) wpw[warp] = pw;
  __syncthreads();                               // buf is free

  // the samples in units of ulp(scl), and the largest x
  int e;
  frexpf(scl, &e);
  const double toq = ldexp(1.0, 24 - e);
  const int j0 = tid * CP;
  long long q[CP];
  long long t = 0;
  float xmax = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < CP; ++i) {
    const float x = __fmul_rn(scl, static_cast<float>(row[j0 + i]));
    xmax = fmaxf(xmax, x);
    q[i] = static_cast<long long>(static_cast<double>(x) * toq);
    t += q[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    xmax = fmaxf(xmax, __shfl_xor_sync(0xffffffffu, xmax, off));
  if (lane == 0) wmax[warp] = xmax;

  // first level: C[j] = sum of q below j; S_i = C[i + 1 + wlen] - C[i + 1]
  long long tot;
  long long c = scan_block<NW>(t, ws, &tot);
#pragma unroll
  for (int i = 0; i < CP; ++i) {
    A[j0 + i] = c;
    c += q[i];
  }
  if (tid == NT - 1) A[NBIN] = tot;
  __syncthreads();
  long long s[CP];
  long long st = 0;
#pragma unroll
  for (int i = 0; i < CP; ++i) {
    const int a = j0 + i + 1;
    s[i] = wrapped(A, a + wlen, NBIN) - A[a];
    st += s[i];
  }
  // second level, over A: Cs[j] = sum of S below j
  long long stot;
  c = scan_block<NW>(st, ws, &stot);             // after every read of C
#pragma unroll
  for (int i = 0; i < CP; ++i) {
    A[j0 + i] = c;
    c += s[i];
  }
  if (tid == NT - 1) A[NBIN] = stot;
  __syncthreads();
  // the first minimum of the smoothed sums Cs[i + 1 + wlen] - Cs[i + 1]
  long long best = 0;
  int ibest = NBIN;
#pragma unroll
  for (int i = 0; i < CP; ++i) {
    const int a = j0 + i + 1;
    const long long sel = wrapped(A, a + wlen, NBIN) - A[a];
    if (ibest == NBIN || sel < best) {
      best = sel;
      ibest = j0 + i;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, ibest, off);
    if (ob < best || (ob == best && oi < ibest)) {
      best = ob;
      ibest = oi;
    }
  }
  if (lane == 0) {
    wbest[warp] = best;
    wib[warp] = ibest;
  }
  __syncthreads();

  if (tid == 0) {
    float pwt = 0.0f, mx = -CUDART_INF_F;
    long long bb = wbest[0];
    int ib = wib[0];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      pwt += wpw[w];
      mx = fmaxf(mx, wmax[w]);
      if (wbest[w] < bb || (wbest[w] == bb && wib[w] < ib)) {
        bb = wbest[w];
        ib = wib[w];
      }
    }
    const double ulp = 1.0 / toq;
    const long long sw = A[ib + 1] - A[ib];      // S at the window
    const float base = static_cast<float>(static_cast<double>(sw) * ulp /
                                          static_cast<double>(wlen));
    const double ss = static_cast<double>(scl);
    out[b] = base;
    out[nprof + b] = static_cast<float>(
        sqrt(static_cast<double>(pwt) * ss * ss /
             (static_cast<double>(NBIN) * (K2 + 1))));
    out[2 * nprof + b] = static_cast<float>(
        static_cast<double>(tot) * ulp -
        static_cast<double>(NBIN) * static_cast<double>(base));
    out[3 * nprof + b] = __fsub_rn(mx, base);
  }
}

template <int M, int LG2>
cudaError_t run(const short* raw, const float* scale, const float2* tw,
                int ntw, float* out, long long nprof, int wlen,
                cudaStream_t stream) {
  using P = ppfft::Plan<M, LG2>;
  using S = Shape<P>;
  if (ntw != P::NTW + P::NZ / 2 + 1) return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      load_stats_kernel<M, LG2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::SMEM));
  if (e != cudaSuccess) return e;
  load_stats_kernel<M, LG2>
      <<<static_cast<unsigned>(nprof), S::NT, S::SMEM, stream>>>(
          raw, scale, tw, out, nprof, wlen);
  return cudaGetLastError();
}

}  // namespace

// raw (nprof, nbin) int16, 16-byte aligned, nbin a plan of PP_FFT_PLANS
// (any other nbin returns cudaErrorInvalidValue); scale (nprof) float32;
// tw (ntw, 2) float32, ops/setup_dft._fft_tables_np(nbin); wlen the
// baseline's window, 1 <= wlen < nbin; out (4, nprof) float32: baseline,
// noise, sum and max of the baseline-removed profile.
// All contiguous.  Returns cudaGetLastError() after the launch.
extern "C" int pp_load_stats(const short* raw, const float* scale,
                             const float* tw, int ntw, float* out,
                             long long nprof, int nbin, int wlen,
                             cudaStream_t stream) {
  const int nz = nbin / 2;
  if (nbin < 64 || (nbin & 1) || nprof < 1 || nprof > 0x7fffffffLL ||
      wlen < 1 || wlen >= nbin ||
      (reinterpret_cast<uintptr_t>(raw) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const int lg2 = __builtin_ctz(nz);             // nz = m 2^lg2, m odd
  const int m = nz >> lg2;
  const float2* t = reinterpret_cast<const float2*>(tw);
#define PP_LOAD_STATS_CASE(M, LG2)                                  \
  if (m == M && lg2 == LG2)                                        \
    return static_cast<int>(                                       \
        run<M, LG2>(raw, scale, t, ntw, out, nprof, wlen, stream));
  PP_FFT_PLANS(PP_LOAD_STATS_CASE)
#undef PP_LOAD_STATS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
