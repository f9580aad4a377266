// Per-channel scattering moments for the (phi, DM, tau[, alpha]) Newton loop.
//
// Replaces pulseportraiture_tpu/ops/pallas_moments.py: _scat_kernel,
// _scat_kernel_kvec and _make_scat_kernel_ct (one kernel: the port keeps
// harmonics in natural order).  For each row (item, channel) with phase
// phi, scattering time tau [rot], cross-spectrum G = Gr + i Gi and template
// power M2 (row r reads M2 row r % m2_rows), with P = e^{2 pi i phi k},
// c = 2 pi k tau, br = 1/(1 + c^2), bi = -c br, B = br + i bi:
//
//   z = G P conj(B),  w = z conj(B),  v = w conj(B)
//   C   = sum Re z            Cp  = -2 pi   sum k Im z
//   Rf  = -2 pi sum k Im w    Cpp = -4 pi^2 sum k^2 Re z
//   If1 = -4 pi^2 sum k^2 Re w                 Rg = -8 pi^2 sum k^2 Re v
//   S   = sum br M2           S1  = -8 pi^2 tau sum k^2 br^2 M2
//   S2  = 8 pi^2 sum k^2 br^3 (3 c^2 - 1) M2
//
// the nine sums of pallas_moments.py _scat_terms_ref in closed form
// (|B|^2 = br, conj f = 2 pi i k conj(B)^2, conj g = -8 pi^2 k^2
// conj(B)^3): one correctly rounded reciprocal a harmonic, no division,
// the constants applied once a row; every sum accumulates in f32.
//
// Bound on the H100: bytes.  Gr/Gi are 8 bytes a harmonic (M2 rows shared
// by the items of a batch can come from L2; a per-item M2 adds 4), against
// ~56 float32 operations a harmonic.  The loads set its time
// (scripts/torch_scat_variants.py times it without them and without the
// arithmetic).
//
// Design:
//  * L lanes a row (8, 16 or 32; 32/L rows a warp) and rows_per_block rows
//    a block, both chosen by shape on the host (ops/moments.scat_geometry).
//    Lane l takes groups of 4 harmonics k = h0 + 4 g + m, g = l + L j (step
//    j, m < 4; as many steps as the warp's rows need).  h0 = -(row offset
//    mod 4), in -3..0, puts every group on a 16-byte boundary, so each
//    group whose harmonics all lie in 0..nh-1 is read by 128-bit loads;
//    the head group (k < 0 masked), the tail group, and Gi or M2 rows at
//    another offset mod 16 than Gr's are read by 32-bit loads.  The first
//    step's loads are issued before the phasor factors are formed, the
//    next step's before the current step is computed.  Rows are taken in
//    row order where the M2 rows stay in L2 between two items, else in
//    tiles of 16 M2 rows, item by item (task_row, the tile from
//    scat_geometry): the items that read one M2 row then run close
//    together and find it in L1 or L2.
//  * The phasor is factored, e^{2 pi i phi k} = F_l E_m S_j with F_l =
//    e^{2 pi i phi (h0 + 4 l)} (once a lane), E_m = e^{2 pi i phi m} (lane m
//    of the row, shared by __shfl_sync; F_l E_m formed once) and S_j =
//    e^{2 pi i phi 4 L j} (lane j mod L, once every L steps, broadcast a
//    step at a time): one complex multiply an element, no sincosf in the
//    loop.  Each factor's angle is rounded once (phase_trig_rn).
//  * Nine accumulators a lane, a butterfly of shuffles inside the row's L
//    lanes and lane 0's total stored: a fixed order, no atomics, the same
//    bits every run.

#include <cuda_runtime.h>

#include <cstdint>

#include "phase_trig.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegTwoPi = -6.28318530717958647692f;
constexpr float kNegFourPi2 = -39.4784176043574344753f;
constexpr float kNegEightPi2 = -78.9568352087148689506f;
constexpr float kEightPi2 = 78.9568352087148689506f;

// Four harmonics of Gr, Gi and M2.
struct Group {
  float4 x, y, m;
};

__device__ __forceinline__ float load_at(const float* p, int k, int nh) {
  return (k >= 0 && k < nh) ? __ldg(p + k) : 0.0f;
}

__device__ __forceinline__ float4 load4(const float* p, int k0, int nh,
                                        bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(p + k0));
  return make_float4(load_at(p, k0, nh), load_at(p, k0 + 1, nh),
                     load_at(p, k0 + 2, nh), load_at(p, k0 + 3, nh));
}

// Group g of a row (harmonics h0 + 4 g .. + 3), zero outside 0..nh-1 and
// for g >= ng.
__device__ __forceinline__ Group load_group(const float* a, const float* b,
                                            const float* m, int h0, int g,
                                            int ng, int nh, bool vec_g,
                                            bool vec_m) {
  Group q;
  if (g >= ng) {
    q.x = q.y = q.m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return q;
  }
  const int k0 = h0 + 4 * g;
  const bool full = k0 >= 0 && k0 + 4 <= nh;
  q.x = load4(a, k0, nh, full && vec_g);
  q.y = load4(b, k0, nh, full && vec_g);
  q.m = load4(m, k0, nh, full && vec_m);
  return q;
}

// One harmonic k: G = x + i y, template power mm, phasor (pr, pi), tk =
// 2 pi tau.  acc: C, S, Cp, Rf, S1, Cpp, If1, Rg, S2 without their
// constant factors.
__device__ __forceinline__ void accumulate(float x, float y, float mm,
                                           float pr, float pi, float kf,
                                           float tk, float* acc) {
  const float c = tk * kf;
  const float br = __frcp_rn(fmaf(c, c, 1.0f));
  const float bi = -c * br;
  const float gpr = x * pr - y * pi;          // G P
  const float gpi = x * pi + y * pr;
  const float zr = gpr * br + gpi * bi;       // z = G P conj(B)
  const float zi = gpi * br - gpr * bi;
  const float wr = zr * br + zi * bi;         // w = z conj(B)
  const float wi = zi * br - zr * bi;
  const float vr = wr * br + wi * bi;         // Re v, v = w conj(B)
  const float k2 = kf * kf;
  acc[0] += zr;
  acc[2] = fmaf(kf, zi, acc[2]);
  acc[3] = fmaf(kf, wi, acc[3]);
  acc[5] = fmaf(k2, zr, acc[5]);
  acc[6] = fmaf(k2, wr, acc[6]);
  acc[7] = fmaf(k2, vr, acc[7]);
  const float t = br * mm;                    // |B|^2 M2
  acc[1] += t;
  const float u = k2 * (br * t);              // k^2 br^2 M2
  acc[4] += u;
  acc[8] = fmaf(u * br, fmaf(3.0f * c, c, -1.0f), acc[8]);
}

// Row r and M2 row c of task t: tiles of `tile` M2 rows, taken item by
// item, each tile's rows in order (tile = m2_rows: row order).  I is
// 32-bit where the rows allow it.
template <typename I>
__device__ __forceinline__ void task_row(long long t, long long rows,
                                         long long m2_rows, long long tile,
                                         long long* r, long long* c) {
  const I items = static_cast<I>(rows) / static_cast<I>(m2_rows);
  const I span = static_cast<I>(tile) * items;
  const I k = static_cast<I>(t) / span;
  const I w = static_cast<I>(t) - k * span;
  const I left = static_cast<I>(m2_rows) - k * static_cast<I>(tile);
  const I tt = left < static_cast<I>(tile) ? left : static_cast<I>(tile);
  const I item = w / tt;
  *c = static_cast<long long>(k) * tile + (w - item * tt);
  *r = static_cast<long long>(item) * m2_rows + *c;
}

template <int L>
__global__ void __launch_bounds__(kMaxThreads)
    scat_moments_kernel(const float* __restrict__ phis,
                        const float* __restrict__ taus,
                        const float* __restrict__ gr,
                        const float* __restrict__ gi,
                        const float* __restrict__ m2,
                        float* __restrict__ out, long long rows,
                        long long m2_rows, long long tile, int nh) {
  const int l = threadIdx.x % L;
  const long long task =
      static_cast<long long>(blockIdx.x) * (blockDim.x / L) + threadIdx.x / L;
  // a task past the end computes on the last row with nothing loaded:
  // every lane of the warp takes part in the shuffles
  const bool valid = task < rows;
  const long long t = valid ? task : rows - 1;
  long long r, c;
  if (rows <= 0xffffffffLL)
    task_row<unsigned>(t, rows, m2_rows, tile, &r, &c);
  else
    task_row<long long>(t, rows, m2_rows, tile, &r, &c);
  const float* a = gr + r * nh;
  const float* b = gi + r * nh;
  const float* m = m2 + c * nh;
  const uintptr_t ua = reinterpret_cast<uintptr_t>(a);
  const int h0 = -static_cast<int>((ua >> 2) & 3);
  const bool vec_g = ((ua ^ reinterpret_cast<uintptr_t>(b)) & 15) == 0;
  const bool vec_m = ((ua ^ reinterpret_cast<uintptr_t>(m)) & 15) == 0;
  const int ng = valid ? (nh - h0 + 3) / 4 : 0;
  // the first group's loads go out before the phasor factors are formed
  Group cur = load_group(a, b, m, h0, l, ng, nh, vec_g, vec_m);
  const float p = pp::phase_wrap(phis[r]);
  const float tau = taus[r];
  const float tk = pp::kTwoPi * tau;
  // the same count of steps for every lane of the warp (its rows may
  // differ in h0): the most any of its rows needs
  const int steps = (static_cast<int>(__reduce_max_sync(
                         kFull, static_cast<unsigned>(ng))) + L - 1) / L;

  // F_l E_m for m < 4 (E_0 = 1)
  float fs, fc, es, ec;
  pp::phase_trig_rn(p, static_cast<float>(h0 + 4 * l), &fs, &fc);
  pp::phase_trig_rn(p, static_cast<float>(l & 3), &es, &ec);
  float ler[4], lei[4];
  ler[0] = fc;
  lei[0] = fs;
#pragma unroll
  for (int e = 1; e < 4; ++e) {
    const float er = __shfl_sync(kFull, ec, e, L);
    const float ei = __shfl_sync(kFull, es, e, L);
    ler[e] = fc * er - fs * ei;
    lei[e] = fc * ei + fs * er;
  }

  float acc[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) acc[q] = 0.0f;
  float ss = 0.0f, sc = 1.0f;                 // this lane's S_{j + l}
  for (int j = 0; j < steps; ++j) {
    if (j % L == 0)
      pp::phase_trig_rn(p, static_cast<float>(4 * L * (j + l)), &ss, &sc);
    const float sr = __shfl_sync(kFull, sc, j % L, L);
    const float si = __shfl_sync(kFull, ss, j % L, L);
    const int g = l + L * j;
    const Group nxt = load_group(a, b, m, h0, g + L, ng, nh, vec_g, vec_m);
    const float kb = static_cast<float>(h0 + 4 * g);
    const float xs[4] = {cur.x.x, cur.x.y, cur.x.z, cur.x.w};
    const float ys[4] = {cur.y.x, cur.y.y, cur.y.z, cur.y.w};
    const float ms[4] = {cur.m.x, cur.m.y, cur.m.z, cur.m.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pr = ler[e] * sr - lei[e] * si;
      const float pi = ler[e] * si + lei[e] * sr;
      accumulate(xs[e], ys[e], ms[e], pr, pi, kb + static_cast<float>(e), tk,
                 acc);
    }
    cur = nxt;
  }
#pragma unroll
  for (int q = 0; q < 9; ++q) {
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1)
      acc[q] += __shfl_xor_sync(kFull, acc[q], o, L);
  }
  if (valid && l == 0) {
    out[r] = acc[0];
    out[rows + r] = acc[1];
    out[2 * rows + r] = kNegTwoPi * acc[2];
    out[3 * rows + r] = kNegTwoPi * acc[3];
    out[4 * rows + r] = (kNegEightPi2 * tau) * acc[4];
    out[5 * rows + r] = kNegFourPi2 * acc[5];
    out[6 * rows + r] = kNegFourPi2 * acc[6];
    out[7 * rows + r] = kNegEightPi2 * acc[7];
    out[8 * rows + r] = kEightPi2 * acc[8];
  }
}

template <int L>
void launch(const float* phis, const float* taus, const float* gr,
            const float* gi, const float* m2, float* out, long long rows,
            long long m2_rows, long long tile, int nh, int rows_per_block,
            cudaStream_t stream) {
  const long long blocks = (rows + rows_per_block - 1) / rows_per_block;
  scat_moments_kernel<L><<<static_cast<unsigned>(blocks), L * rows_per_block,
                           0, stream>>>(phis, taus, gr, gi, m2, out, rows,
                                        m2_rows, tile, nh);
}

}  // namespace

// phis/taus (rows,), gr/gi (rows, nh), m2 (m2_rows, nh) f32 contiguous,
// rows a multiple of m2_rows, row r reading m2 row r % m2_rows; out (9,
// rows) f32 in the order C, S, Cp,
// Rf, S1, Cpp, If1, Rg, S2.  lanes (8, 16 or 32) a row, rows_per_block rows
// a block, lanes * rows_per_block a multiple of 32 and at most 256; rows
// taken in tiles of `tile` (1..m2_rows) M2 rows, item by item.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// geometry it does not take).
extern "C" int pp_scat_moments(const float* phis, const float* taus,
                               const float* gr, const float* gi,
                               const float* m2, float* out, long long rows,
                               long long m2_rows, int nh, int lanes,
                               int rows_per_block, long long tile,
                               cudaStream_t stream) {
  const int threads = lanes * rows_per_block;
  if (rows_per_block <= 0 || threads % 32 != 0 || threads > kMaxThreads ||
      tile <= 0 || tile > m2_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (lanes) {
    case 8:
      launch<8>(phis, taus, gr, gi, m2, out, rows, m2_rows, tile, nh,
                rows_per_block, stream);
      break;
    case 16:
      launch<16>(phis, taus, gr, gi, m2, out, rows, m2_rows, tile, nh,
                 rows_per_block, stream);
      break;
    case 32:
      launch<32>(phis, taus, gr, gi, m2, out, rows, m2_rows, tile, nh,
                 rows_per_block, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
