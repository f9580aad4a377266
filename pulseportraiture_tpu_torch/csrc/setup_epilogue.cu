// The fit setup's epilogue on a data spectrum: the cross-spectrum against
// the shared model, the per-channel data power over every harmonic and the
// band-summed seed spectra, in one pass over X = rfft(x).
//
// fused_setup's second route (ops/setup_dft.py `_launch_rfft`): every nbin
// csrc/setup_fft.cu has no plan for (odd nbin, 1000, 256 q for q in
// 17..31, nbin above 8192).  There the JAX package runs no Pallas kernel:
// pulseportraiture_tpu/fitters/portrait.py `_use_ct_setup` takes the TPU
// setup kernels (ops/ct_dft.py `pallas_direct_setup`, `ct_setup`) only at
// 256 q with q <= 16, and sets every other width up with stats.make_setup
// on a plain XLA transform.  So the transform here is torch.fft.rfft
// (cuFFT), as the JAX package's is jnp.fft, and this kernel is what
// follows it, fused: for item b, channel c and harmonic k of the spectrum
// X (B, nchan, nhf), nhf = nbin/2 + 1, X dequantized by scale[b, c]:
//
//   Gr + i Gi = X conj(M) for k < nh (k = 0 zeroed unless f0_fact)
//   sd        = sum_{k >= 1} |X_k|^2 over all nhf harmonics (+ |X_0|^2
//               with f0_fact; odd nbin has no Nyquist term, and X has
//               none to count)
//   gs[b, kk, k] = sum_c w[b, c, kk] G[b, c, k]
//
// Bound on the H100: bytes.  X is read once (8 bytes a harmonic), Gr/Gi
// written once (8 bytes a harmonic of the prefix), the model (nchan, nh)
// read once per batch from L2 at best; ~20 float32 operations a harmonic
// against 16 bytes.
//
// Design:
//  * A block takes one item and a tile of `rows` consecutive channels
//    (grid: items fastest, so the B blocks of one tile run together and
//    share the tile's model rows in L2).  Its 256 threads are groups of
//    tpr (32..256) threads, each group a row at a time; a thread owns the
//    harmonic pair (2q, 2q + 1), q = lane + tpr j, read by one 128-bit
//    load where the row starts on a 16-byte boundary (nhf even, or an even
//    row) and by two 64-bit loads where it does not.  Chunks of tpr pairs
//    are the outer loop and the tile's rows the inner one, so a thread
//    keeps its pair's seed partial sums in registers over the tile.
//  * sd rides on the same sweep: each (row, chunk) power is summed over a
//    warp by shuffles and added into that warp's slot of the row in
//    shared memory; the slots are added in a fixed order at the end.
//  * The tile's seed partial sums go to scratch (the FFT route's layout,
//    (B, ntile, K, 2, nh)); a second kernel adds the tiles in a fixed
//    order.  No float atomics: the same bits on every run.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSeeds = 2;
constexpr int kMaxRows = 64;           // channels a tile
constexpr int kWarpsPerRow = kThreads / 32;
constexpr int kReduceGroups = 8;       // row groups of the seed reduction
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float2* X;
  const float* mr;
  const float* mi;
  const float* scale;
  const float* w;
  float* gr;
  float* gi;
  float* sd;
  float* part;
  int nchan, nhf, nh, f0_fact, rows, tpr;
};

// X[k], X[k + 1] of a row, zero past nhf.
__device__ __forceinline__ void load_pair(const float2* __restrict__ xr,
                                          int k, int nhf, bool vec,
                                          float2* v0, float2* v1) {
  if (k + 1 < nhf) {
    if (vec) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(xr + k));
      *v0 = make_float2(v.x, v.y);
      *v1 = make_float2(v.z, v.w);
    } else {
      *v0 = __ldg(xr + k);
      *v1 = __ldg(xr + k + 1);
    }
  } else {
    *v0 = k < nhf ? __ldg(xr + k) : make_float2(0.0f, 0.0f);
    *v1 = make_float2(0.0f, 0.0f);
  }
}

// G = X conj(M) at harmonic k of a row, stored where k < nh; zero at
// k = 0 unless f0_fact and past nh.
__device__ __forceinline__ float2 cross(float2 v, const float* __restrict__ mr,
                                        const float* __restrict__ mi,
                                        float* __restrict__ gr,
                                        float* __restrict__ gi, int k, int nh,
                                        int f0_fact) {
  if (k >= nh) return make_float2(0.0f, 0.0f);
  const float a = __ldg(mr + k);
  const float m = __ldg(mi + k);
  float2 g = make_float2(v.x * a + v.y * m, v.y * a - v.x * m);
  if (k == 0 && !f0_fact) g = make_float2(0.0f, 0.0f);
  gr[k] = g.x;
  gi[k] = g.y;
  return g;
}

template <int KS>
__global__ void __launch_bounds__(kThreads)
    setup_epilogue_kernel(const Args a) {
  __shared__ float sdacc[kMaxRows][kWarpsPerRow];
  __shared__ float2 red[KS > 0 ? kThreads : 1][KS > 0 ? 2 * KS : 1];
  const int tpr = a.tpr;
  const int groups = kThreads / tpr;
  const int g = threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  const int b = blockIdx.x;
  const int tile = blockIdx.y;
  const int c0 = tile * a.rows;
  const int nrows = min(a.rows, a.nchan - c0);
  const int nhf = a.nhf, nh = a.nh;
  for (int i = threadIdx.x; i < kMaxRows * kWarpsPerRow; i += kThreads)
    sdacc[i / kWarpsPerRow][i % kWarpsPerRow] = 0.0f;
  __syncthreads();

  const int npairs = (nhf + 1) / 2;
  for (int q0 = 0; q0 < npairs; q0 += tpr) {
    const int k = 2 * (q0 + lane);
    float2 acc[KS > 0 ? KS : 1][2];
#pragma unroll
    for (int s = 0; s < KS; ++s) acc[s][0] = acc[s][1] = make_float2(0, 0);
#pragma unroll 4
    for (int r = g; r < nrows; r += groups) {
      const size_t row = static_cast<size_t>(b) * a.nchan + c0 + r;
      const float2* xr = a.X + row * nhf;
      const bool vec = (reinterpret_cast<uintptr_t>(xr) & 15) == 0;
      float2 v0, v1;
      load_pair(xr, k, nhf, vec, &v0, &v1);
      if (a.scale != nullptr) {
        const float s = __ldg(a.scale + row);
        v0.x *= s;
        v0.y *= s;
        v1.x *= s;
        v1.y *= s;
      }
      float p = (k > 0 || a.f0_fact) ? v0.x * v0.x + v0.y * v0.y : 0.0f;
      p += v1.x * v1.x + v1.y * v1.y;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        p += __shfl_xor_sync(kFull, p, off);
      if ((lane & 31) == 0) sdacc[r][lane >> 5] += p;
      const size_t mo = static_cast<size_t>(c0 + r) * nh;
      const size_t go = row * nh;
      const float2 g0 = cross(v0, a.mr + mo, a.mi + mo, a.gr + go, a.gi + go,
                              k, nh, a.f0_fact);
      const float2 g1 = cross(v1, a.mr + mo, a.mi + mo, a.gr + go, a.gi + go,
                              k + 1, nh, a.f0_fact);
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const float wv = __ldg(a.w + row * KS + s);
        acc[s][0].x = fmaf(wv, g0.x, acc[s][0].x);
        acc[s][0].y = fmaf(wv, g0.y, acc[s][0].y);
        acc[s][1].x = fmaf(wv, g1.x, acc[s][1].x);
        acc[s][1].y = fmaf(wv, g1.y, acc[s][1].y);
      }
    }
    if (KS > 0) {
      // the groups' partial sums of this chunk, added in group order
      if (groups > 1) {
        __syncthreads();
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          red[threadIdx.x][2 * s] = acc[s][0];
          red[threadIdx.x][2 * s + 1] = acc[s][1];
        }
        __syncthreads();
        if (g == 0) {
          for (int h = 1; h < groups; ++h) {
#pragma unroll
            for (int s = 0; s < KS; ++s) {
              const float2 u = red[h * tpr + lane][2 * s];
              const float2 v = red[h * tpr + lane][2 * s + 1];
              acc[s][0].x += u.x;
              acc[s][0].y += u.y;
              acc[s][1].x += v.x;
              acc[s][1].y += v.y;
            }
          }
        }
      }
      if (g == 0) {
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          float* pr = a.part + ((static_cast<size_t>(b) * gridDim.y + tile) *
                                    KS + s) * 2 * static_cast<size_t>(nh);
          if (k < nh) {
            pr[k] = acc[s][0].x;
            pr[nh + k] = acc[s][0].y;
          }
          if (k + 1 < nh) {
            pr[k + 1] = acc[s][1].x;
            pr[nh + k + 1] = acc[s][1].y;
          }
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < nrows) {
    float t = 0.0f;
    for (int w = 0; w < (tpr + 31) / 32; ++w) t += sdacc[threadIdx.x][w];
    a.sd[static_cast<size_t>(b) * a.nchan + c0 + threadIdx.x] = t;
  }
}

// gs[b, kk, h] = sum over tiles t of part[b, t, kk, :, h], in tile order
// (kReduceGroups strided partial sums, then the groups in order).
__global__ void __launch_bounds__(32 * kReduceGroups)
    seed_reduce_epilogue_kernel(const float* __restrict__ part,
                                float* __restrict__ gsr,
                                float* __restrict__ gsi, int ntile, int nh) {
  __shared__ float2 acc[kReduceGroups][33];
  const int lane = threadIdx.x, g = threadIdx.y;
  const int h = blockIdx.x * 32 + lane;
  const int kk = blockIdx.y, kseed = gridDim.y;
  const size_t b = blockIdx.z;
  float sr = 0.0f, si = 0.0f;
  if (h < nh)
    for (int t = g; t < ntile; t += kReduceGroups) {
      const size_t base = (((b * ntile + t) * kseed + kk) * 2) *
                          static_cast<size_t>(nh);
      sr += part[base + h];
      si += part[base + nh + h];
    }
  acc[g][lane] = make_float2(sr, si);
  __syncthreads();
  if (g == 0 && h < nh) {
    sr = 0.0f;
    si = 0.0f;
#pragma unroll
    for (int q = 0; q < kReduceGroups; ++q) {
      sr += acc[q][lane].x;
      si += acc[q][lane].y;
    }
    const size_t o = (b * kseed + kk) * nh + h;
    gsr[o] = sr;
    gsi[o] = si;
  }
}

}  // namespace

// X (B, nchan, nhf) complex64 (float (re, im) pairs), 8-byte aligned;
// mr/mi (nchan, nh), scale (B, nchan) or null, w (B, nchan, kseed) or
// null, all float32 contiguous; gr/gi (B, nchan, nh), sd (B, nchan),
// part (B, ntile, kseed, 2, nh) scratch and gsr/gsi (B, kseed, nh) with
// ntile = ceil(nchan / rows_per_tile).  tpr: threads a row (32, 64, 128
// or 256).  Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int pp_setup_epilogue(const float* X, int nhf, const float* mr,
                                 const float* mi, const float* scale,
                                 const float* w, int kseed, float* gr,
                                 float* gi, float* sd, float* part,
                                 float* gsr, float* gsi, int B, int nchan,
                                 int nh, int f0_fact, int rows_per_tile,
                                 int tpr, cudaStream_t stream) {
  if (kseed < 0 || kseed > kMaxSeeds || nhf < 1 || nh < 1 || nh > nhf ||
      B < 1 || nchan < 1 || rows_per_tile < 1 ||
      rows_per_tile > kMaxRows ||
      (tpr != 32 && tpr != 64 && tpr != 128 && tpr != 256) ||
      (reinterpret_cast<uintptr_t>(X) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntile = (nchan + rows_per_tile - 1) / rows_per_tile;
  if (ntile > 65535 || (kseed > 0 && B > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.X = reinterpret_cast<const float2*>(X);
  a.mr = mr;
  a.mi = mi;
  a.scale = scale;
  a.w = w;
  a.gr = gr;
  a.gi = gi;
  a.sd = sd;
  a.part = part;
  a.nchan = nchan;
  a.nhf = nhf;
  a.nh = nh;
  a.f0_fact = f0_fact;
  a.rows = rows_per_tile;
  a.tpr = tpr;
  const dim3 grid(B, ntile);
  switch (kseed) {
    case 0:
      setup_epilogue_kernel<0><<<grid, kThreads, 0, stream>>>(a);
      break;
    case 1:
      setup_epilogue_kernel<1><<<grid, kThreads, 0, stream>>>(a);
      break;
    default:
      setup_epilogue_kernel<2><<<grid, kThreads, 0, stream>>>(a);
      break;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || kseed == 0) return static_cast<int>(err);
  seed_reduce_epilogue_kernel<<<dim3((nh + 31) / 32, kseed, B),
                                dim3(32, kReduceGroups), 0, stream>>>(
      part, gsr, gsi, ntile, nh);
  return static_cast<int>(cudaGetLastError());
}
