// Fused fit setup: DFT of the data onto the first nh harmonics, the
// cross-spectrum against the shared model, the per-channel data power and
// the band-summed seed spectra, in one pass over the data.
//
// Replaces two Pallas TPU kernels of pulseportraiture_tpu/ops/ct_dft.py:
// pallas_direct_setup (_direct_kernel_factory; the capped route, nh =
// NQ*M') and ct_setup (_ct_setup_kernel_factory; the full band, nh =
// nbin/2 + 1).  Harmonics are a natural-order prefix k < nh, so the two
// differ only in nh; the TPU's Cooley-Tukey factoring is not carried over.
//
// Bound on the H100: FP32 FMA throughput (2*nbin*2*nh flops per channel);
// the data are read once.  Design: the DFT is an SGEMM X = x . E against a
// host-built (f64 -> f32) trig slab E (nbin, ncolp) whose columns
// interleave cos and sin of each harmonic, tiled 64 channels x 64 columns
// x 16 bins per block with 4x4 register micro-tiles.  A thread then holds
// (cos, sin) of two harmonics for four channels, so the epilogue (scale,
// Gr/Gi, DC zeroing, seed partial sums) needs no exchange.  FP32 FMA is
// the f32-class DFT the fit needs: TF32 or a single bf16 pass is not.
//
// Data power: sd = 1/2 (nbin sum x^2 - X0^2) + 1/2 X_ny^2 (Parseval over
// k = 1..nbin/2; the Nyquist term only for even nbin; + X0^2 with
// f0_fact), from sum x, sum x^2 and sum (-1)^j x accumulated while the
// data tile is staged, so it covers every harmonic even when nh is capped.
// int16 data are dequantized after the DFT (X*scale, sum x^2 * scale^2).
//
// Seed sums gs[b, kk, h] = sum_c w[b, c, kk] G[b, c, h]: CUDA blocks run
// in no order and the seed is an argmax on a 512-point grid, so there are
// no float atomics.  Each block writes its channel tile's partial sum to
// scratch and a second kernel adds the tiles in a fixed order: the result
// is the same on every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // channels per block
constexpr int BN = 64;   // slab columns per block (32 harmonics)
constexpr int BK = 16;   // bins per k-step

template <typename T>
__global__ void __launch_bounds__(256)
setup_kernel(const T* __restrict__ x, const float* __restrict__ slab,
             int ncolp, const float* __restrict__ mr,
             const float* __restrict__ mi, const float* __restrict__ scale,
             const float* __restrict__ w, int kseed, float* __restrict__ gr,
             float* __restrict__ gi, float* __restrict__ sd,
             float* __restrict__ part, int nchan, int nbin, int nh,
             int f0_fact) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float red[16][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int b = blockIdx.z;
  const int c0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const bool stats = blockIdx.y == 0;

  // data tile: thread loads 4 consecutive bins of one channel row
  const int lrow = tid >> 2;
  const int lcol = (tid & 3) * 4;
  const int gc = c0 + lrow;
  const bool row_ok = gc < nchan;
  const T* xrow = x + (static_cast<size_t>(b) * nchan + (row_ok ? gc : 0)) *
                          static_cast<size_t>(nbin);
  // slab tile: thread loads 4 consecutive columns of one bin row
  const int brow = tid >> 4;
  const int bcol = (tid & 15) * 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  float sx = 0.0f, sx2 = 0.0f, sny = 0.0f;

  for (int j0 = 0; j0 < nbin; j0 += BK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + lcol + q;
      const float v = (row_ok && j < nbin) ? static_cast<float>(xrow[j])
                                           : 0.0f;
      As[lcol + q][lrow] = v;
      if (stats) {
        sx += v;
        sx2 = fmaf(v, v, sx2);
        sny += (j & 1) ? -v : v;
      }
    }
    {
      const int j = j0 + brow;
      float4 e = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (j < nbin)
        e = *reinterpret_cast<const float4*>(
            slab + static_cast<size_t>(j) * ncolp + n0 + bcol);
      *reinterpret_cast<float4*>(&Bs[brow][bcol]) = e;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 e = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float ev[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], ev[j], acc[i][j]);
    }
    __syncthreads();
  }

  // per-channel data power (column-tile 0 only; the branch is block-wide)
  if (stats) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sx += __shfl_xor_sync(0xffffffffu, sx, off);
      sx2 += __shfl_xor_sync(0xffffffffu, sx2, off);
      sny += __shfl_xor_sync(0xffffffffu, sny, off);
    }
    if ((tid & 3) == 0 && row_ok) {
      const size_t ic = static_cast<size_t>(b) * nchan + gc;
      const float s = scale ? scale[ic] : 1.0f;
      const float x0 = sx * s;
      const float ny = sny * s;
      float v = 0.5f * (static_cast<float>(nbin) * (sx2 * s * s) - x0 * x0);
      if ((nbin & 1) == 0) v += 0.5f * ny * ny;
      if (f0_fact) v += x0 * x0;
      sd[ic] = v;
    }
  }

  // epilogue: thread owns harmonics h0, h0+1 of channels c0+ty*4+i
  const int h0 = (n0 >> 1) + tx * 2;
  float gR[4][2], gI[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    const size_t ic = static_cast<size_t>(b) * nchan + c;
    const float s = (scale && c < nchan) ? scale[ic] : 1.0f;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int h = h0 + q;
      const float xr = acc[i][2 * q] * s;
      const float xi = -acc[i][2 * q + 1] * s;
      float m_r = 0.0f, m_i = 0.0f;
      const bool ok = c < nchan && h < nh;
      if (ok) {
        m_r = mr[static_cast<size_t>(c) * nh + h];
        m_i = mi[static_cast<size_t>(c) * nh + h];
      }
      float g_r = xr * m_r + xi * m_i;
      float g_i = xi * m_r - xr * m_i;
      if (h == 0 && !f0_fact) {
        g_r = 0.0f;
        g_i = 0.0f;
      }
      gR[i][q] = g_r;
      gI[i][q] = g_i;
      if (ok) {
        gr[ic * nh + h] = g_r;
        gi[ic * nh + h] = g_i;
      }
    }
  }

  // seed partial sums over this block's channel tile
  for (int kk = 0; kk < kseed; ++kk) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + ty * 4 + i;
      const float wv =
          c < nchan ? w[(static_cast<size_t>(b) * nchan + c) * kseed + kk]
                    : 0.0f;
      s[0] = fmaf(wv, gR[i][0], s[0]);
      s[1] = fmaf(wv, gI[i][0], s[1]);
      s[2] = fmaf(wv, gR[i][1], s[2]);
      s[3] = fmaf(wv, gI[i][1], s[3]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) red[ty][tx * 4 + q] = s[q];
    __syncthreads();
    if (tid < BN) {
      float t = 0.0f;
#pragma unroll
      for (int r = 0; r < 16; ++r) t += red[r][tid];
      const size_t base =
          ((static_cast<size_t>(b) * gridDim.x + blockIdx.x) * kseed + kk) *
          ncolp;
      part[base + n0 + tid] = t;
    }
    __syncthreads();
  }
}

// gs[b, kk, h] = sum over channel tiles t (in order) of part[b, t, kk, 2h(+1)]
__global__ void seed_reduce_kernel(const float* __restrict__ part,
                                   float* __restrict__ gsr,
                                   float* __restrict__ gsi, long long total,
                                   int ntile, int kseed, int ncolp, int nh) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int h = static_cast<int>(idx % nh);
  const long long bk = idx / nh;
  const int kk = static_cast<int>(bk % kseed);
  const long long b = bk / kseed;
  float sr = 0.0f, si = 0.0f;
  for (int t = 0; t < ntile; ++t) {
    const size_t base = ((static_cast<size_t>(b) * ntile + t) * kseed + kk) *
                        static_cast<size_t>(ncolp);
    sr += part[base + 2 * h];
    si += part[base + 2 * h + 1];
  }
  gsr[idx] = sr;
  gsi[idx] = si;
}

}  // namespace

// x (B, nchan, nbin) int16 (x_is_i16 != 0) or f32; slab (nbin, ncolp) f32
// with ncolp % 64 == 0 and ncolp >= 2 nh; mr/mi (nchan, nh); scale (B,
// nchan) or null; w (B, nchan, kseed) or null (kseed = 0); outputs gr/gi
// (B, nchan, nh), sd (B, nchan); with kseed > 0: scratch part (B,
// ceil(nchan/64), kseed, ncolp) and gsr/gsi (B, kseed, nh).  All
// contiguous.  Returns cudaGetLastError() after the launches.
extern "C" int pp_fused_setup(const void* x, int x_is_i16, const float* slab,
                              int ncolp, const float* mr, const float* mi,
                              const float* scale, const float* w, int kseed,
                              float* gr, float* gi, float* sd, float* part,
                              float* gsr, float* gsi, int B, int nchan,
                              int nbin, int nh, int f0_fact,
                              cudaStream_t stream) {
  const int ntile = (nchan + BM - 1) / BM;
  const dim3 grid(ntile, ncolp / BN, B);
  if (x_is_i16)
    setup_kernel<int16_t><<<grid, 256, 0, stream>>>(
        static_cast<const int16_t*>(x), slab, ncolp, mr, mi, scale, w, kseed,
        gr, gi, sd, part, nchan, nbin, nh, f0_fact);
  else
    setup_kernel<float><<<grid, 256, 0, stream>>>(
        static_cast<const float*>(x), slab, ncolp, mr, mi, scale, w, kseed,
        gr, gi, sd, part, nchan, nbin, nh, f0_fact);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || kseed == 0) return static_cast<int>(err);
  const long long total = static_cast<long long>(B) * kseed * nh;
  const int threads = 256;
  seed_reduce_kernel<<<static_cast<unsigned>((total + threads - 1) / threads),
                       threads, 0, stream>>>(part, gsr, gsi, total, ntile,
                                             kseed, ncolp, nh);
  return static_cast<int>(cudaGetLastError());
}
