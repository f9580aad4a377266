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
// Design (scripts/torch_epilogue_variants.py timed the first form of this
// kernel with its stores, its loads and its data power cut out: the
// scalar Gr/Gi stores two floats apart cost half its time):
//  * A thread owns groups of 4 consecutive harmonics k = h0 + 4 g + m of
//    a row.  h0 = -(the Gr row's offset mod 4), in -3..0, puts every group
//    on a 16-byte boundary of Gr and Gi, so a group inside 0..nh-1 is
//    written by two 128-bit stores and its model read by two 128-bit
//    loads; X, 8 bytes a harmonic, by two 128-bit loads where the group
//    starts on a 16-byte boundary of X too.  The head group (k < 0), the
//    tail, and rows at another offset mod 16 use masked 32- or 64-bit
//    accesses.  Rows four channels apart start at one offset mod 16 (4 nh
//    floats, 4 nhf complex), so a block takes a tile of the channels c =
//    a mod 4 of one item (a its class): one h0 for all its rows.
//  * A row is cut into nslice slices of `slice` groups, sized to the row
//    (no slice runs nearly empty); `lanes` threads (`tpr` rounded up to a
//    warp) take a slice's groups g = lane + lanes j, j < steps, and walk
//    the tile's rows one after another, `groups` rows at once where a row
//    is short.  A step issues its four 128-bit loads before it uses any;
//    at most 64 registers a thread, so two or three blocks share an SM
//    and their warps keep the loads in flight (a pipeline of two steps a
//    thread took 95 registers, one block an SM at 16384 bins, and ran
//    slower).  Grid: (item, tile, slice), items fastest, so the blocks
//    that read one tile's model rows run together and share them through
//    L2.
//  * sd: a thread sums a row's power over its steps in a register; one
//    warp reduction a row (slice), the warps of the row added in order.
//    With several slices the slice sums go to scratch and a second pass
//    adds them in order.
//  * Seed sums: each thread keeps its groups' partial sums over the tile
//    in its own slots of shared memory (no two threads share a slot: no
//    atomics, no barrier in the loop); at the end the row groups' slots
//    are added in order and the tile's sums go to scratch ((B, ntile, K,
//    2, nh), the FFT route's layout); a second kernel adds the tiles in a
//    fixed order.  The same bits on every run.
//  * The geometry (tpr, groups, steps, lanes, slice, nslice, rows a tile)
//    comes from the host (ops/setup_dft._epilogue_geometry), which sizes
//    the tiles to fill the card (pp_setup_epilogue_blocks_per_sm).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxSeeds = 2;
constexpr int kMaxThreads = 512;
constexpr int kMaxRows = 128;          // channels a tile
constexpr int kMaxWarps = kMaxThreads / 32;
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
  float* sdpart;
  float* part;
  int nchan, nhf, nh, f0_fact, rows;
  int tpr, groups, steps, lanes, slice, nslice;
};

// What one step of a thread reads: 4 harmonics of X, of the model, and its
// row's scale and seed weights.
template <int KS>
struct Step {
  float2 x[4];
  float mr[4], mi[4];
  float sc;
  float ws[KS > 0 ? KS : 1];
};

// Tile `tile` of an item: its class cls (channels c = cls mod 4), the
// index of its first channel within the class and its row count.
__device__ __forceinline__ void tile_rows(int tile, int nchan, int rows,
                                          int* cls, int* first, int* nrows) {
  int t = tile;
  *cls = 0;
  *first = 0;
  *nrows = 0;
  for (int a = 0; a < 4; ++a) {
    const int na = nchan > a ? (nchan - a + 3) / 4 : 0;
    const int ta = (na + rows - 1) / rows;
    if (t < ta) {
      *cls = a;
      *first = t * rows;
      *nrows = min(rows, na - t * rows);
      return;
    }
    t -= ta;
  }
}

__device__ __forceinline__ void add4(float4* p, float s, const float* v) {
  float4 u = *p;
  u.x = fmaf(s, v[0], u.x);
  u.y = fmaf(s, v[1], u.y);
  u.z = fmaf(s, v[2], u.z);
  u.w = fmaf(s, v[3], u.w);
  *p = u;
}

// At most 64 registers a thread (two blocks of 512 threads an SM): the
// blocks an SM holds are set by the threads and the seed slots.
template <int KS>
__global__ void __launch_bounds__(kMaxThreads, 2)
    setup_epilogue_kernel(const Args a) {
  // slots[((grp steps + j) KS + s) 2 + ri][lane]: a thread's seed sums
  extern __shared__ float4 slots[];
  __shared__ float sdw[kMaxRows][kMaxWarps];
  const int b = blockIdx.x, tile = blockIdx.y, q = blockIdx.z;
  int cls, first, nrows;
  tile_rows(tile, a.nchan, a.rows, &cls, &first, &nrows);
  const int nhf = a.nhf, nh = a.nh, steps = a.steps, lanes = a.lanes;
  const int grp = threadIdx.x / a.tpr, lane = threadIdx.x % a.tpr;
  // row i of the tile: channel c0 + 4 i of item b; the tile's rows lie
  // within 32-bit offsets of its first (the host checks)
  const size_t c0 = cls + 4 * static_cast<size_t>(first);
  const size_t row0 = static_cast<size_t>(b) * a.nchan + c0;
  const float2* const xb = a.X + row0 * nhf;
  const float* const mrb = a.mr + c0 * nh;
  const float* const mib = a.mi + c0 * nh;
  float* const grb = a.gr + row0 * nh;
  float* const gib = a.gi + row0 * nh;
  const uintptr_t ug = reinterpret_cast<uintptr_t>(grb);
  const int h0 = -static_cast<int>((ug >> 2) & 3);
  const bool vec_g = ((ug ^ reinterpret_cast<uintptr_t>(gib)) & 15) == 0;
  const bool vec_m = ((reinterpret_cast<uintptr_t>(mrb) - ug) & 15) == 0 &&
                     ((reinterpret_cast<uintptr_t>(mib) - ug) & 15) == 0;
  const bool vec_x = ((reinterpret_cast<uintptr_t>(xb) -
                       8u * static_cast<uintptr_t>(-h0)) & 15) == 0;
  const int ng = (nhf - h0 + 3) / 4;     // this class's groups a row
  const int gbeg = q * a.slice;
  const int gend = min(gbeg + a.slice, ng);
  const int per = nrows > grp ? (nrows - grp + a.groups - 1) / a.groups : 0;
  const bool owner = lane < lanes;
  float4* const my = slots + static_cast<size_t>(grp) * steps * KS * 2 *
                                 lanes + lane;
  if (KS > 0 && owner)
    for (int e = 0; e < steps * KS * 2; ++e)
      my[e * lanes] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // step (u, j): row grp + groups u of the tile, group gbeg + lane +
  // lanes j of the row
  auto load = [&](int u, int j, Step<KS>& st) {
    const unsigned i4 = 4u * static_cast<unsigned>(grp + a.groups * u);
    const int g = gbeg + lane + lanes * j;
    const int k0 = h0 + 4 * g;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      st.x[m] = make_float2(0.0f, 0.0f);
      st.mr[m] = st.mi[m] = 0.0f;
    }
    st.sc = a.scale != nullptr ? __ldg(a.scale + row0 + i4) : 1.0f;
#pragma unroll
    for (int s = 0; s < KS; ++s)
      st.ws[s] = __ldg(a.w + (row0 + i4) * KS + s);
    if (!owner || g >= gend) return;
    const float2* xr = xb + i4 * static_cast<unsigned>(nhf);
    if (vec_x && k0 >= 0 && k0 + 4 <= nhf) {
      const float4 u0 = __ldg(reinterpret_cast<const float4*>(xr + k0));
      const float4 u1 = __ldg(reinterpret_cast<const float4*>(xr + k0 + 2));
      st.x[0] = make_float2(u0.x, u0.y);
      st.x[1] = make_float2(u0.z, u0.w);
      st.x[2] = make_float2(u1.x, u1.y);
      st.x[3] = make_float2(u1.z, u1.w);
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (k0 + m >= 0 && k0 + m < nhf) st.x[m] = __ldg(xr + k0 + m);
    }
    if (k0 >= nh) return;
    const float* pr = mrb + i4 * static_cast<unsigned>(nh);
    const float* pi = mib + i4 * static_cast<unsigned>(nh);
    if (vec_m && k0 >= 0 && k0 + 4 <= nh) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(pr + k0));
      const float4 v = __ldg(reinterpret_cast<const float4*>(pi + k0));
      st.mr[0] = u.x;
      st.mr[1] = u.y;
      st.mr[2] = u.z;
      st.mr[3] = u.w;
      st.mi[0] = v.x;
      st.mi[1] = v.y;
      st.mi[2] = v.z;
      st.mi[3] = v.w;
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (k0 + m >= 0 && k0 + m < nh) {
          st.mr[m] = __ldg(pr + k0 + m);
          st.mi[m] = __ldg(pi + k0 + m);
        }
    }
  };

  float sdp = 0.0f;
  auto compute = [&](int u, int j, const Step<KS>& st) {
    const unsigned i4 = 4u * static_cast<unsigned>(grp + a.groups * u);
    const int g = gbeg + lane + lanes * j;
    const int k0 = h0 + 4 * g;
    float gr[4], gi[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float xr = st.x[m].x * st.sc, xi = st.x[m].y * st.sc;
      const bool keep = k0 + m != 0 || a.f0_fact;
      // masked harmonics read as zero: no power, no cross-spectrum
      sdp += keep ? xr * xr + xi * xi : 0.0f;
      gr[m] = keep ? xr * st.mr[m] + xi * st.mi[m] : 0.0f;
      gi[m] = keep ? xi * st.mr[m] - xr * st.mi[m] : 0.0f;
    }
    if (owner && g < gend && k0 < nh) {
      float* pr = grb + i4 * static_cast<unsigned>(nh);
      float* pi = gib + i4 * static_cast<unsigned>(nh);
      if (vec_g && k0 >= 0 && k0 + 4 <= nh) {
        *reinterpret_cast<float4*>(pr + k0) =
            make_float4(gr[0], gr[1], gr[2], gr[3]);
        *reinterpret_cast<float4*>(pi + k0) =
            make_float4(gi[0], gi[1], gi[2], gi[3]);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (k0 + m >= 0 && k0 + m < nh) {
            pr[k0 + m] = gr[m];
            pi[k0 + m] = gi[m];
          }
      }
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        add4(my + ((j * KS + s) * 2) * lanes, st.ws[s], gr);
        add4(my + ((j * KS + s) * 2 + 1) * lanes, st.ws[s], gi);
      }
    }
  };

  for (int u = 0; u < per; ++u) {
    for (int j = 0; j < steps; ++j) {
      Step<KS> st;
      load(u, j, st);
      compute(u, j, st);
    }
    // the row's power over this slice: one reduction a row
    float t = sdp;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_xor_sync(kFull, t, off);
    if ((lane & 31) == 0) sdw[grp + a.groups * u][lane >> 5] = t;
    sdp = 0.0f;
  }
  __syncthreads();

  const int wpr = a.tpr / 32;
  for (int i = threadIdx.x; i < nrows; i += blockDim.x) {
    float t = 0.0f;
    for (int w = 0; w < wpr; ++w) t += sdw[i][w];
    const size_t row = row0 + 4 * static_cast<size_t>(i);
    if (a.nslice == 1)
      a.sd[row] = t;
    else
      a.sdpart[row * a.nslice + q] = t;
  }
  if (KS > 0) {
    // the row groups' slots added in group order, then the tile's sums
    const int per_grp = steps * KS * 2 * lanes;
    for (int e = threadIdx.x; e < per_grp; e += blockDim.x) {
      float4 v = slots[e];
      for (int h = 1; h < a.groups; ++h) {
        const float4 u = slots[static_cast<size_t>(h) * per_grp + e];
        v.x += u.x;
        v.y += u.y;
        v.z += u.z;
        v.w += u.w;
      }
      const int l = e % lanes, r = e / lanes;
      const int ri = r % 2, s = (r / 2) % KS, j = r / (2 * KS);
      const int g = gbeg + l + lanes * j;
      const int k0 = h0 + 4 * g;
      if (g >= gend || k0 >= nh) continue;
      float* pr = a.part + (((static_cast<size_t>(b) * gridDim.y + tile) *
                                 KS + s) * 2 + ri) * static_cast<size_t>(nh);
      const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (k0 + m >= 0 && k0 + m < nh) pr[k0 + m] = vv[m];
    }
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

// sd[r] = sum over slices q of sdpart[r, q], in slice order.
__global__ void __launch_bounds__(256)
    sd_reduce_epilogue_kernel(const float* __restrict__ sdpart,
                              float* __restrict__ sd, long long rows,
                              int nslice) {
  const long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (r >= rows) return;
  float t = 0.0f;
  for (int q = 0; q < nslice; ++q) t += sdpart[r * nslice + q];
  sd[r] = t;
}

// The largest head offset -h0 of any row of gr: a row needs (nhf - h0 +
// 3) / 4 groups.
int head(const float* gr, int B, int nchan, int nh) {
  const uintptr_t o = reinterpret_cast<uintptr_t>(gr) >> 2;
  int h = 0;
  for (long long r = 0; r < 4 && r < static_cast<long long>(B) * nchan; ++r)
    h = max(h, static_cast<int>((o + r * nh) & 3));
  return h;
}

template <int KS>
cudaError_t prepare(int smem) {
  return cudaFuncSetAttribute(setup_epilogue_kernel<KS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

cudaError_t prepare_for(int kseed, int smem) {
  switch (kseed) {
    case 0:
      return prepare<0>(smem);
    case 1:
      return prepare<1>(smem);
    default:
      return prepare<2>(smem);
  }
}

}  // namespace

// Blocks of `threads` threads and `smem` bytes of dynamic shared memory
// that one SM of the current device holds at once for kseed seed columns
// (the host sizes the tiles by it); a negative CUDA error on failure.
extern "C" int pp_setup_epilogue_blocks_per_sm(int kseed, int threads,
                                               int smem) {
  if (kseed < 0 || kseed > kMaxSeeds || threads < 32 ||
      threads > kMaxThreads || smem < 0)
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare_for(kseed, smem);
  int n = 0;
  if (err == cudaSuccess) {
    switch (kseed) {
      case 0:
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, setup_epilogue_kernel<0>, threads, smem);
        break;
      case 1:
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, setup_epilogue_kernel<1>, threads, smem);
        break;
      default:
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, setup_epilogue_kernel<2>, threads, smem);
        break;
    }
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// X (B, nchan, nhf) complex64 (float (re, im) pairs), 8-byte aligned;
// mr/mi (nchan, nh), scale (B, nchan) or null, w (B, nchan, kseed) or
// null, all float32 contiguous; gr/gi (B, nchan, nh), sd (B, nchan),
// sdpart (B, nchan, nslice) scratch (null when nslice = 1), part (B,
// ntile, kseed, 2, nh) scratch and gsr/gsi (B, kseed, nh), ntile the tiles
// of rows_per_tile channels of each class c mod 4.  The block geometry
// (ops/setup_dft._epilogue_geometry): tpr threads a row (a multiple of
// 32), groups rows at once (tpr groups <= 512 threads), lanes <= tpr of
// them taking steps groups of 4 harmonics each of a row slice of `slice`
// groups, nslice slices covering every group a row of gr needs.  Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for
// arguments it does not take).
extern "C" int pp_setup_epilogue(
    const float* X, int nhf, const float* mr, const float* mi,
    const float* scale, const float* w, int kseed, float* gr, float* gi,
    float* sd, float* sdpart, float* part, float* gsr, float* gsi, int B,
    int nchan, int nh, int f0_fact, int rows_per_tile, int tpr, int groups,
    int steps, int lanes, int slice, int nslice, cudaStream_t stream) {
  if (kseed < 0 || kseed > kMaxSeeds || nhf < 1 || nh < 1 || nh > nhf ||
      B < 1 || nchan < 1 || rows_per_tile < 1 ||
      rows_per_tile > kMaxRows || tpr < 32 || tpr % 32 || groups < 1 ||
      tpr * groups > kMaxThreads || lanes < 1 || lanes > tpr ||
      steps < 1 || slice < 1 ||
      static_cast<long long>(lanes) * steps < slice ||
      nslice < 1 || nslice > 65535 ||
      static_cast<long long>(slice) * nslice < (nhf + head(gr, B, nchan, nh) +
                                               3LL) / 4 ||
      (nslice > 1 && sdpart == nullptr) || (kseed > 0 && part == nullptr) ||
      4LL * rows_per_tile * nhf >= (1LL << 31) ||
      (reinterpret_cast<uintptr_t>(X) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  int ntile = 0;
  for (int c = 0; c < 4 && c < nchan; ++c)
    ntile += ((nchan - c + 3) / 4 + rows_per_tile - 1) / rows_per_tile;
  if (ntile > 65535 || (kseed > 0 && B > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = static_cast<long long>(groups) * steps * kseed * 2 *
                         lanes * sizeof(float4);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.X = reinterpret_cast<const float2*>(X);
  a.mr = mr;
  a.mi = mi;
  a.scale = scale;
  a.w = w;
  a.gr = gr;
  a.gi = gi;
  a.sd = sd;
  a.sdpart = sdpart;
  a.part = part;
  a.nchan = nchan;
  a.nhf = nhf;
  a.nh = nh;
  a.f0_fact = f0_fact;
  a.rows = rows_per_tile;
  a.tpr = tpr;
  a.groups = groups;
  a.steps = steps;
  a.lanes = lanes;
  a.slice = slice;
  a.nslice = nslice;
  cudaError_t err = prepare_for(kseed, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, ntile, nslice);
  const int threads = tpr * groups;
  const size_t bytes = static_cast<size_t>(smem);
  switch (kseed) {
    case 0:
      setup_epilogue_kernel<0><<<grid, threads, bytes, stream>>>(a);
      break;
    case 1:
      setup_epilogue_kernel<1><<<grid, threads, bytes, stream>>>(a);
      break;
    default:
      setup_epilogue_kernel<2><<<grid, threads, bytes, stream>>>(a);
      break;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nslice > 1) {
    const long long rows = static_cast<long long>(B) * nchan;
    sd_reduce_epilogue_kernel<<<static_cast<unsigned>((rows + 255) / 256),
                                256, 0, stream>>>(sdpart, sd, rows, nslice);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (kseed == 0) return static_cast<int>(err);
  seed_reduce_epilogue_kernel<<<dim3((nh + 31) / 32, kseed, B),
                                dim3(32, kReduceGroups), 0, stream>>>(
      part, gsr, gsi, ntile, nh);
  return static_cast<int>(cudaGetLastError());
}
