// The trust-region subproblem of the batched Newton loop, one launch a solve.
//
// Replaces no TPU kernel: the JAX package's fitters/newton.py _tr_solve is
// plain jnp, which XLA fuses.  Added because its eager torch form
// (ops/tr_solve.py tr_solve_reference) is 676 kernel launches a solve and a
// host sync in torch.linalg.eigh's error check, twice a Newton iteration.
//
// For each item: argmin g.p + 0.5 p H p over |p| <= radius, H n x n
// symmetric (n <= 8; the portrait fits pass 5), computed in float64 whatever
// the working type T, with tr_solve_reference's arithmetic:
//   s = max(max|H|, 1), g/s and H/s (the lower triangle, as eigh reads it);
//   H/s = V diag(lam) V^T, lam ascending, by cyclic Jacobi;
//   gt = V^T g, floor = max(0, -lam_min) + eps, eps = 10 DBL_EPSILON;
//   interior: lam_min > 0 and |p(0)| <= radius, p(mu) = gt / (lam + mu);
//   boundary: 25 secular (Newton on 1/|p| - 1/radius) steps from
//   mu = floor + 1, mu kept >= floor, the step clamped to the radius, and
//   with hard_case Moré–Sorensen's hard case along V[:, 0];
//   p = -V p(mu) of the interior or boundary step; hit = not interior.
//
// Bound on the H100: latency, not bytes or operations.  A batch of 64 items
// of 5 x 5 reads 8 kB and does ~1e5 float64 operations, but each item is a
// chain of ~3000 dependent ones (the Jacobi sweeps, then 25 secular steps,
// with divisions and square roots).  Design: one thread an item, n a
// template argument so that the matrix, the eigenvectors and every loop over
// them are unrolled in registers; 32 threads a block, so a batch spreads
// over SMs.  Jacobi (Rutishauser's form: rotations applied to the diagonal
// through a separate accumulator, off-diagonal entries below the diagonal's
// rounding set to zero after the fourth sweep) runs until the off-diagonal
// part is exactly zero, at most 50 sweeps; NaN in H ends it with NaN
// eigenvalues, so the item's step is NaN, as the loop's non-finite trial
// rules expect.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;        // items a block
constexpr int kMaxSweeps = 50;
constexpr int kSecularSteps = 25;
constexpr double kEps = 10.0 * DBL_EPSILON;

// torch.maximum / torch.minimum: NaN wins
__device__ __forceinline__ double nan_max(double a, double b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

__device__ __forceinline__ double nan_min(double a, double b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

__device__ __forceinline__ void rotate(double& x, double& y, double s,
                                       double tau) {
  const double g = x;
  const double h = y;
  x = g - s * (h + g * tau);
  y = h + s * (g - h * tau);
}

// Eigenvalues d (ascending) and eigenvectors v (columns) of the symmetric
// matrix whose strict upper triangle is a[p][q], p < q, and whose diagonal
// is d on entry; a is overwritten.
template <int N>
__device__ __forceinline__ void jacobi(double (&a)[N][N], double (&d)[N],
                                       double (&v)[N][N]) {
  double b[N], z[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) v[i][j] = i == j ? 1.0 : 0.0;
    b[i] = d[i];
    z[i] = 0.0;
  }
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    double sm = 0.0;
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) sm += fabs(a[p][q]);
    }
    if (sm != sm) {
#pragma unroll
      for (int i = 0; i < N; ++i) d[i] = sm;
      break;
    }
    if (sm == 0.0) break;
    const double tresh = sweep < 3 ? 0.2 * sm / (N * N) : 0.0;
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const double apq = a[p][q];
        const double g = 100.0 * fabs(apq);
        if (sweep > 3 && fabs(d[p]) + g == fabs(d[p]) &&
            fabs(d[q]) + g == fabs(d[q])) {
          a[p][q] = 0.0;
        } else if (fabs(apq) > tresh) {
          double h = d[q] - d[p];
          double t;
          if (fabs(h) + g == fabs(h)) {
            t = apq / h;
          } else {
            const double theta = 0.5 * h / apq;
            t = 1.0 / (fabs(theta) + sqrt(1.0 + theta * theta));
            if (theta < 0.0) t = -t;
          }
          const double c = 1.0 / sqrt(1.0 + t * t);
          const double s = t * c;
          const double tau = s / (1.0 + c);
          h = t * apq;
          z[p] -= h;
          z[q] += h;
          d[p] -= h;
          d[q] += h;
          a[p][q] = 0.0;
#pragma unroll
          for (int j = 0; j < p; ++j) rotate(a[j][p], a[j][q], s, tau);
#pragma unroll
          for (int j = p + 1; j < q; ++j) rotate(a[p][j], a[j][q], s, tau);
#pragma unroll
          for (int j = q + 1; j < N; ++j) rotate(a[p][j], a[q][j], s, tau);
#pragma unroll
          for (int j = 0; j < N; ++j) rotate(v[j][p], v[j][q], s, tau);
        }
      }
    }
#pragma unroll
    for (int p = 0; p < N; ++p) {
      b[p] += z[p];
      d[p] = b[p];
      z[p] = 0.0;
    }
  }
  // ascending, as eigh returns them
#pragma unroll
  for (int i = 0; i < N - 1; ++i) {
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      if (d[j] < d[i]) {
        const double t = d[i];
        d[i] = d[j];
        d[j] = t;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const double u = v[k][i];
          v[k][i] = v[k][j];
          v[k][j] = u;
        }
      }
    }
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    tr_solve_kernel(const T* __restrict__ g, long long gs0, long long gs1,
                    const T* __restrict__ H, long long hs0, long long hs1,
                    long long hs2, const T* __restrict__ radius,
                    long long rs0, T* __restrict__ p, bool* __restrict__ hit,
                    long long items, int hard_case) {
  const long long item =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (item >= items) return;
  const T* Hi = H + item * hs0;
  double a[N][N], d[N], v[N][N], gt[N], gv[N];
  double s = 1.0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      s = nan_max(s, fabs(static_cast<double>(Hi[i * hs1 + j * hs2])));
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    d[i] = static_cast<double>(Hi[i * hs1 + i * hs2]) / s;
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      a[i][j] = static_cast<double>(Hi[j * hs1 + i * hs2]) / s;
    }
    gv[i] = static_cast<double>(g[item * gs0 + i * gs1]) / s;
  }
  const double r = static_cast<double>(radius[item * rs0]);
  jacobi<N>(a, d, v);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    double t = 0.0;
#pragma unroll
    for (int j = 0; j < N; ++j) t += v[j][i] * gv[j];
    gt[i] = t;
  }
  const double lam_min = d[0];
  const double mu_floor = nan_max(0.0, -lam_min) + kEps;
  double ss = 0.0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const double q = gt[i] / d[i];
    ss += q * q;
  }
  const bool interior = lam_min > 0.0 && sqrt(ss + kEps * kEps) <= r;
  double out[N];
  if (interior) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      double t = 0.0;
#pragma unroll
      for (int i = 0; i < N; ++i) t += v[j][i] * (gt[i] / d[i]);
      out[j] = -t;
    }
  } else {
    double mu = mu_floor + 1.0;
    for (int it = 0; it < kSecularSteps; ++it) {
      double sp = 0.0, sd = 0.0;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const double den = d[i] + mu;
        const double q = gt[i] / den;
        sp += q * q;
        sd += gt[i] * gt[i] / (den * den * den);
      }
      const double pn = sqrt(sp + kEps * kEps);
      const double phi = 1.0 / pn - 1.0 / r;
      const double dphi = sd / (pn * pn * pn);
      const double step = phi / (dphi > 0.0 ? dphi : 1.0);
      mu = nan_max(mu - step, mu_floor);
    }
    double pb = 0.0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      double t = 0.0;
#pragma unroll
      for (int i = 0; i < N; ++i) t += v[j][i] * (gt[i] / (d[i] + mu));
      out[j] = -t;
      pb += out[j] * out[j];
    }
    const double pb_norm = sqrt(pb + kEps * kEps);
    const double clamp = nan_min(r / pb_norm, 1.0);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] *= clamp;
    if (hard_case && lam_min < 0.0 && pb_norm < r) {
      // negative curvature that g barely sees: the rest of the radius
      // along the lowest eigenvector, downhill
      const double sgn = gt[0] > 0.0 ? -1.0 : 1.0;
      const double t = sgn * sqrt(nan_max(r * r - pb_norm * pb_norm, 0.0));
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] += t * v[j][0];
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) p[item * N + j] = static_cast<T>(out[j]);
  hit[item] = !interior;
}

template <typename T, int N>
void launch(const void* g, long long gs0, long long gs1, const void* H,
            long long hs0, long long hs1, long long hs2, const void* radius,
            long long rs0, void* p, void* hit, long long items,
            int hard_case, cudaStream_t stream) {
  const long long blocks = (items + kThreads - 1) / kThreads;
  tr_solve_kernel<T, N><<<static_cast<unsigned>(blocks), kThreads, 0,
                          stream>>>(
      static_cast<const T*>(g), gs0, gs1, static_cast<const T*>(H), hs0, hs1,
      hs2, static_cast<const T*>(radius), rs0, static_cast<T*>(p),
      static_cast<bool*>(hit), items, hard_case);
}

template <typename T>
int launch_n(int n, const void* g, long long gs0, long long gs1,
             const void* H, long long hs0, long long hs1, long long hs2,
             const void* radius, long long rs0, void* p, void* hit,
             long long items, int hard_case, cudaStream_t stream) {
#define PP_TR_SOLVE_CASE(NN)                                                \
  case NN:                                                                  \
    launch<T, NN>(g, gs0, gs1, H, hs0, hs1, hs2, radius, rs0, p, hit, items, \
                  hard_case, stream);                                       \
    break;
  switch (n) {
    PP_TR_SOLVE_CASE(1)
    PP_TR_SOLVE_CASE(2)
    PP_TR_SOLVE_CASE(3)
    PP_TR_SOLVE_CASE(4)
    PP_TR_SOLVE_CASE(5)
    PP_TR_SOLVE_CASE(6)
    PP_TR_SOLVE_CASE(7)
    PP_TR_SOLVE_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PP_TR_SOLVE_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// g (items, n) with element strides gs0, gs1; H (items, n, n) with strides
// hs0, hs1, hs2; radius (items,) with stride rs0 (0: one radius for all),
// all float32 (is_double 0) or float64 (1); p (items, n) contiguous, of the
// same type; hit (items,) bool.  n in 1..8.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int pp_tr_solve(const void* g, long long gs0, long long gs1,
                           const void* H, long long hs0, long long hs1,
                           long long hs2, const void* radius, long long rs0,
                           void* p, void* hit, long long items, int n,
                           int is_double, int hard_case,
                           cudaStream_t stream) {
  return is_double
             ? launch_n<double>(n, g, gs0, gs1, H, hs0, hs1, hs2, radius,
                                rs0, p, hit, items, hard_case, stream)
             : launch_n<float>(n, g, gs0, gs1, H, hs0, hs1, hs2, radius, rs0,
                               p, hit, items, hard_case, stream);
}
