// Fused fit setup on a row-resident shared-memory real FFT: the spectrum of
// every channel row, the cross-spectrum against the shared model, the
// per-channel data power and the band-summed seed spectra, in one pass over
// the data.  Computes what ops/setup_dft.fused_setup_reference computes.
//
// Replaces two Pallas TPU kernels of pulseportraiture_tpu/ops/ct_dft.py:
// pallas_direct_setup (_direct_kernel_factory; the capped route, nh =
// NQ*M') and ct_setup (_ct_setup_kernel_factory; the full band, nh =
// nbin/2 + 1).  Harmonics are a natural-order prefix k < nh, so the two
// differ only in how many harmonics the epilogue reads the model for and
// writes; the transform is full either way.  It takes nbin = 64, 128,
// 8192 and every nbin = 256 q, q = 1 .. 16: every width the TPU kernels
// take (the band cap's NQ*128, NQ even) and the powers of two around them.
// (The "rfft" route, torch.fft.rfft then csrc/setup_epilogue.cu, computes
// the same function at the nbin this kernel does not take: odd nbin,
// 1000, 256 q for q in 17 .. 31, above 8192, ...)
//
// Bound on the H100: bytes.  Once the DFT is factored the function needs
// 2.5 nbin log2(nbin) flops per row against nbin * itemsize bytes read, so
// the data read (once) and the Gr/Gi written set the least time, not
// arithmetic.  Tensor cores are deliberately not used: a tensor-core DFT
// does 150x the arithmetic of the factored transform at a worse accuracy
// class (TF32 or a single bf16 pass), for a function that is byte-bound.
// (As measured on an H100 the kernel runs at 1.6-5.3x its byte bound over
// 64-8192 bins, the capped int16 cases highest, held by the rate at which
// the warps of an SM get their instructions out.)
//
// Design:
//   * One channel row lives in shared memory from its arrival to its
//     outputs.  The real nbin-point transform runs as an nbin/2-point
//     complex FFT of z_j = x_2j + i x_2j+1 (the raw row read as float2, or
//     as short2 and converted on the way: int16 ingest moves half the
//     bytes).  A worker of NA = nbin/32 threads owns a row; each thread
//     holds 16 points in registers through passes of radix 16, 16 and 2,
//     4, 8 or 16 (csrc/fft_passes.cuh: Stockham autosort, no bit reversal,
//     in place in the worker's buffer, a barrier of the worker's threads
//     between a pass's loads and its stores): two or three trips through
//     shared memory, and no block-wide barrier inside a transform.  When
//     nbin/2 = M 2^a with M odd (3 .. 15: nbin 768, 1280, ..., 3840), the
//     same passes take the power-of-two factor and one more pass of radix M
//     closes the transform in natural order, every thread of the worker
//     holding the M points of 2^a/WT butterflies (one more trip).
//   * The worker (worker_threads): below a warp (nbin 64 .. 512: 2 .. 16
//     threads) several rows share a warp, the packed worker, and its
//     barrier is a __syncwarp of its lanes: a warp-sized worker would idle
//     50-94% of its lanes there.  From a warp up it is rounded up to a
//     power of two (a named barrier counts whole warps; the idle lanes of a
//     mixed plan's worker wait at its barriers).  On the H100 the packed
//     worker was 1.3-3.7x faster than a warp-sized one at 64-256 bins and
//     faster in three of four cases at 512 (PERF.md).
//   * A block of 256 threads runs 256/WT workers, one row each: a group of
//     rows (8 at nbin 1024, 128 at 64).  At nbin 8192 a worker is 256
//     threads and the block 512, two workers: one worker a block would
//     leave an SM 8 warps to hide its latencies with.  Two workers' rows
//     and buffers fill the SM's shared memory, so that plan reads its
//     twiddle table from global memory (through L1) instead of a copy in
//     shared memory.
//   * No sincosf: pass twiddles and W^k come from a host table built in
//     float64 and cast to float32, laid out per pass so that neighbouring
//     threads read neighbouring entries, copied to shared memory once per
//     block where it fits; the radix-16 and radix-8 butterflies' inner
//     twiddles and the odd DFTs' cos and sin are constants, float64 values
//     rounded once.
//   * A block takes a tile of consecutive channels of one item, group after
//     group, through a ring of two groups of raw rows in shared memory: one
//     thread starts cp.async.bulk (the 1-D TMA bulk copy) of a whole group
//     (its rows are consecutive in memory; a 64-bin row alone is too small
//     a copy), completion on an mbarrier per ring slot, while the block
//     transforms the group before.  A slot is free again once the block
//     barrier after the transforms has passed.  (A third slot costs a
//     resident block per SM and was slower on the H100.)  Two blocks share
//     an SM where their shared memory allows (every nbin but 3840, 4096
//     and 8192).
//   * sd is the sum of |Z_k|^2 of the packed spectrum, taken by the worker
//     from its registers after the last pass, the odd one if any (the pair
//     X_k, X_{N/2-k} carries the power of Z_k, Z_{N/2-k}; Z_0 holds X_0 and
//     the Nyquist term): shuffles within the worker, then a fixed-order
//     sum of its warps' results.
//   * Fused epilogue, nothing spilled to device memory.  After a block
//     barrier all threads untangle the group's rows,
//       X_k = E - i W^k O,  E = (Z_k + conj Z_{N/2-k})/2,
//                           O = (Z_k - conj Z_{N/2-k})/2,  W = e^{-2 pi i/N}
//     for the pair (k, N/2 - k) at once, only where the model has harmonics
//     (k or N/2 - k below nh).  Thread t owns the pairs k = t, t + NT, ...,
//     so model reads and Gr/Gi writes are coalesced; where a row has fewer
//     pairs than the block threads (nbin <= 512) the block takes RC rows at
//     once, thread t the pair t mod (nbin/4) of the rows t div (nbin/4) +
//     RC i.  Each thread keeps its pairs' seed partial sums in registers
//     across the rows of the tile; at the end the RC row phases' sums are
//     added in a fixed order through shared memory, written once per tile,
//     harmonic-contiguous, and a second kernel adds the tiles in a fixed
//     order (16 threads a harmonic).  No float atomics: the same bits on
//     every run (the seed is an argmax on a 512-point grid).
//   * int16 data are dequantized after the transform (X * scale), the order
//     the plain twin uses.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_passes.cuh"

namespace {

constexpr int NSLOT = 2;       // ring slots: groups of raw rows
constexpr int MIN_NBIN = 64;
constexpr int MAX_NBIN = 8192;
constexpr int SM_SMEM = 233472;   // shared memory of an SM (228 KB)
constexpr int BLOCK_SMEM = 232448;    // the most one block may have
constexpr int BLOCK_RESERVED = 1024;  // the system's share of each block
constexpr int MAX_SEEDS = 2;   // seed columns whose sums a thread keeps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread: expect `bytes` on the barrier and start the bulk copy of a
// group's rows into its ring slot (16-byte aligned source, destination and
// size).
__device__ __forceinline__ void group_load(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  const uint32_t b = smem_u32(bar);
  // reads of the slot by the generic proxy come before this overwrite
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(b),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(b)
      : "memory");
}

// the lanes of this thread's worker of WT threads within its warp
template <int WT>
__device__ __forceinline__ unsigned worker_mask() {
  if constexpr (WT >= 32)
    return 0xffffffffu;
  else
    return ((1u << WT) - 1) << (threadIdx.x & 31 & ~(WT - 1));
}

// all threads of worker w meet: a packed worker's lanes, or its whole
// warps at named barrier w + 1
template <int WT>
__device__ __forceinline__ void worker_sync(int w) {
  if constexpr (WT < 32)
    __syncwarp(worker_mask<WT>());
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(w + 1), "r"(WT) : "memory");
}

struct Args {
  const void* x;
  const float2* tw;
  const float* mr;
  const float* mi;
  const float* scale;
  const float* w;
  float* gr;
  float* gi;
  float* sd;
  float* part;
  int x_is_i16, kseed, nchan, nh, f0_fact, rows_per_tile;
};

// One harmonic h of a row against its model value m: the cross-spectrum,
// written out, and its share of the seed sums (acc: this harmonic's K
// accumulators).
template <int KS>
__device__ __forceinline__ void emit(const Args& a, size_t ic, int h,
                                     float xr, float xi, float2 m,
                                     const float* wv, float2* acc) {
  if (h >= a.nh) return;
  float g_r = xr * m.x + xi * m.y;
  float g_i = xi * m.x - xr * m.y;
  if (h == 0 && !a.f0_fact) {
    g_r = 0.0f;
    g_i = 0.0f;
  }
  a.gr[ic * a.nh + h] = g_r;
  a.gi[ic * a.nh + h] = g_i;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    acc[kk].x = fmaf(wv[kk], g_r, acc[kk].x);
    acc[kk].y = fmaf(wv[kk], g_i, acc[kk].y);
  }
}

template <int KS>
__device__ __forceinline__ void flush(const Args& a, float* base, int h,
                                      const float2* acc) {
  if (h >= a.nh) return;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    if (kk < a.kseed) {
      base[(static_cast<size_t>(kk) * 2) * a.nh + h] = acc[kk].x;
      base[(static_cast<size_t>(kk) * 2 + 1) * a.nh + h] = acc[kk].y;
    }
}

constexpr int pow2_at_least(int n) {
  int p = 32;
  while (p < n) p *= 2;
  return p;
}

// The threads of a plan's worker: NA = nbin/32 where that is a power of
// two below a warp (a packed worker, several to a warp), else NA rounded
// up to a power of two from a warp.
constexpr int worker_threads(int na) {
  return na < 32 && (na & (na - 1)) == 0 ? na : pow2_at_least(na);
}

// The block of the plan P: threads, workers, the epilogue's share of a
// thread, shared memory (float32 rows: the larger ring) and the blocks an
// SM holds.
template <class P>
struct Layout {
  static constexpr int WT = worker_threads(P::NA);  // threads of a worker
  static constexpr int NT = WT > 128 ? 2 * WT : 256;  // threads of a block
  static constexpr int WPB = NT / WT;            // workers = rows per group
  static constexpr int NWARP = WT < 32 ? 1 : WT / 32;  // warps of a worker
  static constexpr int HP = P::NZ / 2;           // harmonic pairs of a row
  // rows whose pairs the epilogue takes at once, pairs a thread of a row,
  // rows a thread untangles in a group
  static constexpr int RC = HP < NT ? (NT / HP < WPB ? NT / HP : WPB) : 1;
  static constexpr int PP = RC > 1 ? 1 : (HP + NT - 1) / NT;
  static constexpr int NQ = WPB / RC;
  static_assert(RC == 1 || (NT % HP == 0 && WPB % RC == 0), "row phases");
  static_assert(WT < 32 || WPB <= 15, "named barriers 1 .. 15");
  // the work buffers (at least the room of the seed sums' last reduction)
  static constexpr size_t WORK_ROWS = static_cast<size_t>(WPB) * P::WSZ * 8;
  static constexpr size_t WORK_RED =
      RC > 1 ? static_cast<size_t>(2 * MAX_SEEDS) * NT * 8 : 0;
  static constexpr size_t WORK = WORK_ROWS > WORK_RED ? WORK_ROWS : WORK_RED;
  static constexpr size_t TABLE = (P::NTW + HP + 1) * 8;
  static constexpr size_t RING_F32 =
      static_cast<size_t>(NSLOT) * WPB * 8 * P::NZ;
  static constexpr size_t STATIC =
      NSLOT * 8 + WPB * NWARP * 4 + RC * MAX_SEEDS * 8;
  // the table in shared memory where it fits beside the rows
  static constexpr bool TABLE_SMEM =
      RING_F32 + WORK + TABLE + STATIC <= BLOCK_SMEM;
  static constexpr size_t BUFS = WORK + (TABLE_SMEM ? TABLE : 0);
  // two blocks where two fit, else one
  static constexpr int BLOCKS =
      2 * (RING_F32 + BUFS + STATIC + BLOCK_RESERVED) <= SM_SMEM ? 2 : 1;
  // at most 128 registers a thread
  static constexpr bool TIGHT = NT * BLOCKS >= 512;
};

// What the epilogue needs of a thread's rows rho + RC (i0 + q), q < QC, of
// a group (its first row at channel c of item b; rows at or past nrow are
// left): scale, seed weights, and the model values of the thread's
// harmonic pairs (k, NZ - k), k = kt + NT j, and of NZ/2 when kt = 0.
template <int NZ, int NT, int RC, int PP, int QC, int KSA>
__device__ __forceinline__ void fetch_rows(const Args& a, int b, int c,
                                           int i0, int nrow, int kt,
                                           int rho, float (&sc)[QC],
                                           float (&wv)[QC][KSA],
                                           float2 (&mv)[QC][2 * PP + 1]) {
#pragma unroll
  for (int q = 0; q < QC; ++q) {
    const int row = rho + RC * (i0 + q);
    if (row < nrow) {
      const int cq = c + row;
      const size_t ic = static_cast<size_t>(b) * a.nchan + cq;
      sc[q] = a.scale ? a.scale[ic] : 1.0f;
#pragma unroll
      for (int kk = 0; kk < KSA; ++kk)
        wv[q][kk] = (kk < a.kseed) ? a.w[ic * a.kseed + kk] : 0.0f;
      const float* mrow = a.mr + static_cast<size_t>(cq) * a.nh;
      const float* irow = a.mi + static_cast<size_t>(cq) * a.nh;
#pragma unroll
      for (int j = 0; j < PP; ++j) {
        const int k = kt + NT * j, kq = NZ - k;
        const bool on = k < NZ / 2;
        mv[q][2 * j] = (on && k < a.nh) ? make_float2(mrow[k], irow[k])
                                        : make_float2(0.0f, 0.0f);
        mv[q][2 * j + 1] = (on && kq < a.nh)
                               ? make_float2(mrow[kq], irow[kq])
                               : make_float2(0.0f, 0.0f);
      }
      mv[q][2 * PP] = (kt == 0 && NZ / 2 < a.nh)
                          ? make_float2(mrow[NZ / 2], irow[NZ / 2])
                          : make_float2(0.0f, 0.0f);
    }
  }
}

// Rows a thread fetches the model values of at a time: up to 4 of its nq
// rows of a group.  With budget, fewer while 2 (2 PP + 1)(ksa + q) would
// pass 56 (their model values and the seed sums of ksa columns, 2 PP
// pairs, counted with one pair of margin): the mixed-radix plans and 8192
// at 128 registers a thread; ptxas spilled the mixed plans, whose ragged
// pair sets (nbin/4 not a multiple of 256) keep guards live, at 60 and 72
// (nbin 1280, 1536, 1792; 3328, 3584) and 8192 at 72.
__host__ __device__ constexpr int rows_ahead(int nq, int pp, int ksa,
                                             bool budget) {
  int q = nq < 4 ? nq : 4;
  while (budget && q > 1 && 2 * (2 * pp + 1) * (ksa + q) > 56) q /= 2;
  return q;
}

__device__ __forceinline__ float zpower(float2 z) {
  return z.x * z.x + z.y * z.y;
}

// Plan<M, LG2>: nbin/2 = M 2^LG2; KS: seed accumulators per harmonic
// (kseed <= KS).
template <int M, int LG2, int KS>
__global__ void __launch_bounds__(Layout<ppfft::Plan<M, LG2>>::NT,
                                  Layout<ppfft::Plan<M, LG2>>::BLOCKS)
setup_fft_kernel(const Args a) {
  using P = ppfft::Plan<M, LG2>;
  using L = Layout<P>;
  constexpr int NZ = P::NZ;                      // complex points
  constexpr int NT = L::NT, WT = L::WT, WPB = L::WPB;
  constexpr int HP = L::HP, RC = L::RC, PP = L::PP, NQ = L::NQ;
  constexpr int KSA = KS > 0 ? KS : 1;
  constexpr int QC = rows_ahead(NQ, PP, KSA, L::TIGHT && (M > 1 || PP > 2));

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[NSLOT];
  __shared__ float wred[WPB][L::NWARP];          // L::STATIC bytes with bars
  __shared__ float2 mid[RC][KSA];                // and the middle's sums

  const int tid = threadIdx.x;
  const int w = tid / WT, l = tid % WT;
  const unsigned rowbytes = 2 * NZ * (a.x_is_i16 ? 2u : 4u);
  const unsigned groupbytes = WPB * rowbytes;

  // ring[slot]: a group's raw rows; bufs[w]: worker w's padded work
  // buffer; then the table, where it is kept in shared memory
  unsigned char* ring = smem;
  float2* bufs = reinterpret_cast<float2*>(smem + NSLOT * groupbytes);
  float2* tws = reinterpret_cast<float2*>(
      reinterpret_cast<unsigned char*>(bufs) + L::WORK);
  const float2* tw = L::TABLE_SMEM ? tws : a.tw;
  const float2* untw = tw + P::NTW;              // W^k, k = 0 .. NZ/2
  float2* mybuf = bufs + w * P::WSZ;

  // worker w transforms the rows w, w + WPB, ... of the block's tile
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * a.rows_per_tile;
  const int rows = min(a.rows_per_tile, a.nchan - c0);
  const int ngroups = (rows + WPB - 1) / WPB;
  const unsigned char* xrow0 =
      static_cast<const unsigned char*>(a.x) +
      (static_cast<size_t>(b) * a.nchan + c0) * rowbytes;

  if (tid == 0) {
    for (int s = 0; s < NSLOT; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (L::TABLE_SMEM)
    for (int i = tid; i < P::NTW + HP + 1; i += NT) tws[i] = a.tw[i];
  __syncthreads();
  if (tid == 0)
    for (int s = 0; s < NSLOT && s < ngroups; ++s)
      group_load(ring + s * groupbytes,
                 xrow0 + static_cast<size_t>(s) * groupbytes,
                 min(WPB, rows - s * WPB) * rowbytes, &bars[s]);

  // the epilogue's share of this thread: the pairs k = kt + NT j of the
  // rows rho + RC i of each group
  const int kt = RC > 1 ? tid % HP : tid;
  const int rho = RC > 1 ? tid / HP : 0;
  float2 acc[2 * PP][KSA];
#pragma unroll
  for (int s = 0; s < 2 * PP; ++s)
#pragma unroll
    for (int kk = 0; kk < KSA; ++kk) acc[s][kk] = make_float2(0.0f, 0.0f);
  // the seed sums of k = NZ/2, kept by its thread (kt = 0) of each row
  // phase in shared memory: four registers fewer a thread (the mixed
  // plans at 128 registers spill without)
  if (kt == 0 && rho < RC)
#pragma unroll
    for (int kk = 0; kk < KSA; ++kk) mid[rho][kk] = make_float2(0.0f, 0.0f);

  for (int g = 0; g < ngroups; ++g) {
    const int nrow = min(WPB, rows - g * WPB);   // rows of this group
    const int slot = g % NSLOT;
    if (w < nrow) {
      mbar_wait(&bars[slot], (g / NSLOT) & 1);
      const unsigned char* raw = ring + slot * groupbytes + w * rowbytes;
      float2 v[16];
      if (l < P::NA) {
        if (a.x_is_i16)
          ppfft::fft_phase0<P>(
              v, ppfft::FromI16{reinterpret_cast<const short2*>(raw)}, mybuf,
              l);
        else
          ppfft::fft_phase0<P>(
              v, ppfft::Plain{reinterpret_cast<const float2*>(raw)}, mybuf,
              l);
      }
      worker_sync<WT>(w);
      if (l < P::NA) ppfft::fft_phase1<P>(v, mybuf, l);
      worker_sync<WT>(w);
      if (l < P::NA) ppfft::fft_phase2<P>(v, mybuf, tw, l);
      if constexpr (P::R3 > 1) {
        worker_sync<WT>(w);
        if (l < P::NA) ppfft::fft_phase3<P>(v, mybuf, l);
        worker_sync<WT>(w);
        if (l < P::NA) ppfft::fft_phase4<P>(v, mybuf, tw, l);
      }
      // Data power from the thread's points of Z, still in registers: the
      // pair (X_k, X_{NZ-k}) carries the power of (Z_k, Z_{NZ-k}), and Z_0
      // = a + i b (thread 0's first point) holds X_0 = a + b and the
      // Nyquist term a - b.
      float pw = 0.0f;
      float2 z0 = make_float2(0.0f, 0.0f);
      if constexpr (M > 1) {
        worker_sync<WT>(w);
        ppfft::odd_pass<P, WT>(mybuf, tw, l, [&](int j, const float2* u) {
          if (j == 0) z0 = u[0];
#pragma unroll
          for (int m = j == 0 ? 1 : 0; m < M; ++m) pw += zpower(u[m]);
        });
      } else if (l < P::NA) {
        z0 = v[0];
#pragma unroll
        for (int j = 1; j < 16; ++j) pw += zpower(v[j]);
      }
      if (l == 0) {
        const float ny = z0.x - z0.y, dc = z0.x + z0.y;
        pw += ny * ny + (a.f0_fact ? dc * dc : 0.0f);
      } else {
        pw += zpower(z0);
      }
#pragma unroll
      for (int off = (WT < 32 ? WT : 32) / 2; off > 0; off >>= 1)
        pw += __shfl_xor_sync(worker_mask<WT>(), pw, off);
      if ((l & 31) == 0) wred[w][l >> 5] = pw;
    }

    // The group's rows, all threads.  Scales, seed weights and model
    // values of the first QC rows are asked for before the barrier, so
    // their latency hides behind it (more rows ahead would not fit the
    // registers).
    const int mine = rho < RC ? nrow : 0;        // rows this thread takes
    float sc[QC], wv[QC][KSA];
    float2 mv[QC][2 * PP + 1];
    fetch_rows<NZ, NT, RC, PP, QC, KSA>(a, b, c0 + g * WPB, 0, mine, kt, rho,
                                         sc, wv, mv);
    __syncthreads();                             // every row's Z is written
    if (l == 0 && w < nrow) {                    // fixed order: the same bits
      const size_t ic = static_cast<size_t>(b) * a.nchan + c0 + g * WPB + w;
      const float s = a.scale ? a.scale[ic] : 1.0f;
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < L::NWARP; ++i) sum += wred[w][i];
      a.sd[ic] = sum * s * s;
    }
#pragma unroll
    for (int i0 = 0; i0 < NQ; i0 += QC) {
      if (i0 > 0)
        fetch_rows<NZ, NT, RC, PP, QC, KSA>(a, b, c0 + g * WPB, i0, mine, kt,
                                             rho, sc, wv, mv);
#pragma unroll
      for (int q = 0; q < QC; ++q) {
        const int row = rho + RC * (i0 + q);
        if (row < mine) {
          const float2* z = bufs + row * P::WSZ;
          const size_t ic =
              static_cast<size_t>(b) * a.nchan + c0 + g * WPB + row;
          const float s = sc[q];
#pragma unroll
          for (int j = 0; j < PP; ++j) {
            const int k = kt + NT * j;
            // only the harmonics the model has (k or NZ - k below nh)
            if (k < NZ / 2 && (k < a.nh || NZ - k < a.nh)) {
              const float2 zk = z[k];
              const float2 zq = z[k ? NZ - k : 0];
              const float er = 0.5f * (zk.x + zq.x);
              const float ei = 0.5f * (zk.y - zq.y);
              const float o_r = 0.5f * (zk.x - zq.x);
              const float o_i = 0.5f * (zk.y + zq.y);
              const float2 wk = untw[k];
              const float tr = wk.x * o_r - wk.y * o_i;
              const float ti = wk.x * o_i + wk.y * o_r;
              emit<KS>(a, ic, k, (er + ti) * s, (ei - tr) * s, mv[q][2 * j],
                       wv[q], acc[2 * j]);                        // X_k
              emit<KS>(a, ic, NZ - k, (er - ti) * s, (-ei - tr) * s,
                       mv[q][2 * j + 1], wv[q], acc[2 * j + 1]);  // X_{NZ-k}
            }
          }
          if (kt == 0 && NZ / 2 < a.nh) {  // k = NZ/2 pairs with itself
            const float2 zh = z[NZ / 2];
            emit<KS>(a, ic, NZ / 2, zh.x * s, -zh.y * s, mv[q][2 * PP],
                     wv[q], mid[rho]);
          }
        }
      }
    }
    __syncthreads();                             // the buffers are free
    // the slot was read before the first barrier: group g + NSLOT into it
    // (here, where the epilogue's registers are free)
    if (tid == 0 && g + NSLOT < ngroups)
      group_load(ring + slot * groupbytes,
                 xrow0 + static_cast<size_t>(g + NSLOT) * groupbytes,
                 min(WPB, rows - (g + NSLOT) * WPB) * rowbytes, &bars[slot]);
  }

  if constexpr (KS > 0) {
    if constexpr (RC > 1) {
      // the row phases' sums of each pair, added in the order of rho in
      // the (free) work buffers; the middle's in its own
      float2* red = bufs;
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) red[(s * KS + kk) * NT + tid] =
            acc[s][kk];
      __syncthreads();
      if (rho == 0) {
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            float2 t = red[(s * KS + kk) * NT + kt];
            for (int r = 1; r < RC; ++r) {
              const float2 u = red[(s * KS + kk) * NT + r * HP + kt];
              t.x += u.x;
              t.y += u.y;
            }
            acc[s][kk] = t;
          }
        if (kt == 0)
#pragma unroll
          for (int kk = 0; kk < KS; ++kk)
            for (int r = 1; r < RC; ++r) {
              mid[0][kk].x += mid[r][kk].x;
              mid[0][kk].y += mid[r][kk].y;
            }
      }
    }
    if (rho == 0) {
      float* base = a.part + (static_cast<size_t>(b) * gridDim.x +
                              blockIdx.x) * a.kseed * 2 * a.nh;
#pragma unroll
      for (int j = 0; j < PP; ++j) {
        const int k = kt + NT * j;
        if (k < NZ / 2) {
          flush<KS>(a, base, k, acc[2 * j]);
          flush<KS>(a, base, NZ - k, acc[2 * j + 1]);
        }
      }
      if (kt == 0) flush<KS>(a, base, NZ / 2, mid[0]);
    }
  }
}

// gs[b, kk, h] = sum over channel tiles t of part[b, t, kk, ., h], in a
// fixed order: thread (lane, g) adds the tiles t = g, g + RG, ... in order,
// then the RG partial sums are added in order.  Grid (ceil(nh/32), kseed, B).
constexpr int RG = 16;
__global__ void __launch_bounds__(32 * RG)
seed_reduce_fft_kernel(const float* __restrict__ part,
                       float* __restrict__ gsr, float* __restrict__ gsi,
                       int ntile, int nh) {
  __shared__ float2 acc[RG][33];
  const int lane = threadIdx.x, g = threadIdx.y;
  const int h = blockIdx.x * 32 + lane;
  const int kk = blockIdx.y, kseed = gridDim.y;
  const size_t b = blockIdx.z;
  float sr = 0.0f, si = 0.0f;
  if (h < nh)
    for (int t = g; t < ntile; t += RG) {
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
    for (int q = 0; q < RG; ++q) {
      sr += acc[q][lane].x;
      si += acc[q][lane].y;
    }
    const size_t o = (b * kseed + kk) * nh + h;
    gsr[o] = sr;
    gsi[o] = si;
  }
}

// dynamic shared memory of one block: the ring, the work buffers, the
// table where it is kept there
template <class P>
size_t smem_bytes(size_t rowbytes) {
  using L = Layout<P>;
  return L::WPB * NSLOT * rowbytes + L::BUFS;
}

template <int M, int LG2, int KS>
cudaError_t launch(const Args& a, dim3 grid, size_t rowbytes,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<ppfft::Plan<M, LG2>>(rowbytes);
  const cudaError_t e = cudaFuncSetAttribute(
      setup_fft_kernel<M, LG2, KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  setup_fft_kernel<M, LG2, KS>
      <<<grid, Layout<ppfft::Plan<M, LG2>>::NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// the plan's table size checked, the launch with kseed's accumulators
template <int M, int LG2>
cudaError_t run(const Args& a, int ntw, dim3 grid, size_t rowbytes,
                cudaStream_t stream) {
  using P = ppfft::Plan<M, LG2>;
  if (ntw != P::NTW + P::NZ / 2 + 1) return cudaErrorInvalidValue;
  if (a.kseed == 0) return launch<M, LG2, 0>(a, grid, rowbytes, stream);
  return launch<M, LG2, MAX_SEEDS>(a, grid, rowbytes, stream);
}

cudaError_t dispatch(int m, int lg2, const Args& a, int ntw, dim3 grid,
                     size_t rowbytes, cudaStream_t stream) {
#define PP_FFT_CASE(M, LG2) \
  if (m == M && lg2 == LG2) return run<M, LG2>(a, ntw, grid, rowbytes, stream);
  PP_FFT_PLANS(PP_FFT_CASE)
#undef PP_FFT_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x (B, nchan, nbin) int16 (x_is_i16 != 0) or f32, 16-byte aligned, nbin
// 64, 128, 8192 or 256 q, q = 1 .. 16 (a plan of PP_FFT_PLANS, in
// fft_passes.cuh; any other nbin returns cudaErrorInvalidValue); tw (ntw,
// 2) f32: the twiddled passes' tables then W^k for k <= nbin/4
// (ops/setup_dft._fft_tables_np);
// mr/mi (nchan, nh); scale (B, nchan) or null; w (B, nchan, kseed) or null
// (kseed = 0; at most 2); outputs gr/gi (B, nchan, nh), sd (B, nchan);
// with kseed > 0: scratch part (B, ceil(nchan/rows_per_tile), kseed, 2,
// nh) and gsr/gsi (B, kseed, nh).  All contiguous.  Returns
// cudaGetLastError() after the launches.
extern "C" int pp_fused_setup_fft(const void* x, int x_is_i16,
                                  const float* tw, int ntw, const float* mr,
                                  const float* mi, const float* scale,
                                  const float* w, int kseed, float* gr,
                                  float* gi, float* sd, float* part,
                                  float* gsr, float* gsi, int B, int nchan,
                                  int nbin, int nh, int f0_fact,
                                  int rows_per_tile,
                                  cudaStream_t stream) {
  const int nz = nbin / 2;
  if (nbin < MIN_NBIN || nbin > MAX_NBIN || (nbin & 1) || kseed < 0 ||
      kseed > MAX_SEEDS || rows_per_tile < 1 || nh < 1 || nh > nz + 1 ||
      B < 1 || B > 65535 || nchan < 1 ||
      (reinterpret_cast<uintptr_t>(x) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const int lg2 = __builtin_ctz(nz);               // nz = m 2^lg2, m odd
  const int m = nz >> lg2;
  Args a;
  a.x = x;
  a.tw = reinterpret_cast<const float2*>(tw);
  a.mr = mr;
  a.mi = mi;
  a.scale = scale;
  a.w = w;
  a.gr = gr;
  a.gi = gi;
  a.sd = sd;
  a.part = part;
  a.x_is_i16 = x_is_i16;
  a.kseed = kseed;
  a.nchan = nchan;
  a.nh = nh;
  a.f0_fact = f0_fact;
  a.rows_per_tile = rows_per_tile;
  const int ntile = (nchan + rows_per_tile - 1) / rows_per_tile;
  const dim3 grid(ntile, B);
  const size_t rowbytes = static_cast<size_t>(nbin) * (x_is_i16 ? 2 : 4);
  const cudaError_t err = dispatch(m, lg2, a, ntw, grid, rowbytes, stream);
  if (err != cudaSuccess || kseed == 0) return static_cast<int>(err);
  seed_reduce_fft_kernel<<<dim3((nh + 31) / 32, kseed, B), dim3(32, RG), 0,
                           stream>>>(part, gsr, gsi, ntile, nh);
  return static_cast<int>(cudaGetLastError());
}
