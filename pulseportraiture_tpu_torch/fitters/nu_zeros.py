"""Zero-covariance reference frequencies.

Port of pulseportraiture_tpu.fitters.nu_zeros.get_nu_zeros (reference
pptoaslib.py:733-906), batched over leading axes, from the optimizer's
final moments:

  (1,1,0,0,0)  phi+DM:        weighted harmonic mean of nu^-2
  (1,0,1,0,0)  phi+GM:        its nu^-4 analogue
  (0,0,0,1,1)  tau+alpha:     log-space mean
  (1,1,0,1,0)  phi+DM+tau:    3x3 cofactor closed form
  (1,1,1,0,0)  phi+DM+GM:     even degree-6 polynomial in nu
  (1,1,0,1,1)  phi+DM+tau+a:  4x4 cofactor closed form
  (1,1,1,1,0)  no alpha:      degree-5 (option 1: 4) polynomial in nu^2
  (1,1,1,1,1)  all:           approximated by the (1,1,0,1,1) formulas

As in the JAX package, the reference's divisions of Hessian rows by the
phase/DM derivative or the log-frequency ratio are replaced by exact
identities (Hn[1,j] = phis_d[1] Hn[0,j]; the alpha row is the tau row
times dtau_a/dtau_t), so no channel at the reference frequency gives 0/0.
Flag sets without a zero-covariance frequency keep the fit references.

The polynomial (GM) branches take the nearest positive real root with
the JAX package's grid-plus-bisection solver, not np.roots (PARITY.md):
only roots bracketed by a sign change on a 1e-3..1e3 x target log grid
are found, and without one the fit reference stays.  Their coefficients
are differences of products of channel sums that cancel badly in
float32, so they are built, and the root solved, in float64 whatever the
working dtype (B x nchan values, once per fit).
"""

from __future__ import annotations

import math

import torch

from pulseportraiture_tpu_torch.config import DCONST
from pulseportraiture_tpu_torch.fitters import stats

_ROOT_GRID = 2048     # log-grid points spanning 1e-3..1e3 x target
# bisection refinements per bracketed root: a grid interval spans 0.68%
# of its lower end, so 45 halvings reach float64's spacing (the JAX
# package takes 60; the steps past that point leave lo and hi as they are)
_ROOT_BISECT = 52


def _float64(moments, setup):
    """float64 copies of a moments dict and a FitSetup."""
    def up(v):
        return v.double() if torch.is_tensor(v) and \
            v.dtype.is_floating_point else v
    return ({k: up(v) for k, v in moments.items()},
            setup._replace(**{f: up(getattr(setup, f))
                              for f in setup._fields}))


def get_nu_zeros(setup, fit_flags, moments, params=None, log10_tau=True,
                 option=0):
    """(nu_DM, nu_GM, nu_tau) output references, each (...,), from the
    optimizer's final moments; params (..., 5), the fitted point, gives
    the tau row factor of the scattering branches (as the JAX package
    takes it from the fitted point, not from the moments).  option picks
    the covariance the GM polynomials zero: 0 phi-DM, 1 phi-GM."""
    ff = tuple(int(bool(f)) for f in fit_flags)
    if ff in ((1, 0, 1, 0, 0), (1, 1, 1, 0, 0), (1, 1, 1, 1, 0)):
        dtype = setup.freqs.dtype
        out = _gm_branches(*_float64(moments, setup), ff, option)
        return tuple(v.to(dtype) for v in out)
    if ff not in ((1, 1, 0, 0, 0), (0, 0, 0, 1, 1), (1, 1, 0, 1, 0),
                  (1, 1, 0, 1, 1), (1, 1, 1, 1, 1)):
        return setup.nu_DM, setup.nu_GM, setup.nu_tau
    Hn = stats.hess_per_channel_from_moments(moments, setup,
                                             fit_flags=(1, 1, 1, 1, 1))
    freqs = setup.freqs

    def S(v):
        return v.sum(-1)

    def H(i, j):
        return Hn[..., i, j, :]

    if ff == (1, 1, 0, 0, 0):          # pptoaslib.py:746-752
        H21_n = H(0, 0)                # == Hn[0, 1]/phis_d[1]
        nu_zero_DM = (S(freqs ** -2 * H21_n) / S(H21_n)) ** -0.5
        return nu_zero_DM, setup.nu_GM, setup.nu_tau

    taus, dtau, _ = stats._taus_and_derivs(params, setup, log10_tau)
    # Hn[3, j]/ln(nu/nu_tau) == (taus/dtau_t) Hn[3, j]; 0 where dtau_t == 0
    dt0 = dtau[..., 0, :]
    nz = dt0 != 0.0
    tau_row_fact = torch.where(
        nz, taus / torch.where(nz, dt0, torch.ones_like(dt0)),
        torch.zeros_like(dt0))

    if ff == (0, 0, 0, 1, 1):          # pptoaslib.py:761-767
        H21_n = tau_row_fact * H(3, 3)
        nu_zero_tau = torch.exp(S(torch.log(freqs) * H21_n) / S(H21_n))
        return setup.nu_DM, setup.nu_GM, nu_zero_tau

    if ff == (1, 1, 0, 1, 0):          # pptoaslib.py:768-778
        H21_n, H23_n = H(0, 0), H(0, 3)
        H13, H33 = S(H(3, 0)), S(H(3, 3))
        f2 = freqs ** -2
        numer = H13 * S(f2 * H23_n) - H33 * S(f2 * H21_n)
        denom = H13 * S(H23_n) - H33 * S(H21_n)
        return (numer / denom) ** -0.5, setup.nu_GM, setup.nu_tau

    # (1,1,0,1,1) and (1,1,1,1,1): pptoaslib.py:813-836, 893-901; the
    # sub-Hessian over (phi, DM, tau, alpha)
    idx = [0, 1, 3, 4]
    Hs = Hn[..., idx, :, :][..., :, idx, :]
    H21_n, H23_n, H24_n = Hs[..., 0, 0, :], Hs[..., 0, 2, :], Hs[..., 0, 3, :]
    H41_n, H42_n, H43_n = (tau_row_fact * Hs[..., 2, 0, :],
                           tau_row_fact * Hs[..., 2, 1, :],
                           tau_row_fact * Hs[..., 2, 2, :])
    Hij = Hs.sum(-1)
    H11, H22, H33, H44 = (Hij[..., 0, 0], Hij[..., 1, 1], Hij[..., 2, 2],
                          Hij[..., 3, 3])
    H12, H13, H14 = Hij[..., 0, 1], Hij[..., 0, 2], Hij[..., 0, 3]
    H23, H24 = Hij[..., 1, 2], Hij[..., 1, 3]
    H34 = Hij[..., 2, 3]
    f2 = freqs ** -2
    numer = ((H34 * H34 - H33 * H44) * S(f2 * H21_n) +
             (H13 * H44 - H14 * H34) * S(f2 * H23_n) +
             (H14 * H33 - H13 * H34) * S(f2 * H24_n))
    denom = ((H34 * H34 - H33 * H44) * S(H21_n) +
             (H13 * H44 - H14 * H34) * S(H23_n) +
             (H14 * H33 - H13 * H34) * S(H24_n))
    nu_zero_DM = (numer / denom) ** -0.5
    lf = torch.log(freqs)
    numer_t = ((H13 * H22 - H12 * H23) * S(lf * H41_n) +
               (H11 * H23 - H12 * H13) * S(lf * H42_n) +
               (H12 * H12 - H11 * H22) * S(lf * H43_n))
    denom_t = ((H13 * H22 - H12 * H23) * S(H41_n) +
               (H11 * H23 - H12 * H13) * S(H42_n) +
               (H12 * H12 - H11 * H22) * S(H43_n))
    nu_zero_tau = torch.exp(numer_t / denom_t)
    return nu_zero_DM, setup.nu_GM, nu_zero_tau


def _gm_branches(m, setup, ff, option):
    """The three flag sets with GM fitted (float64 inputs)."""
    Hn = stats.hess_per_channel_from_moments(m, setup,
                                             fit_flags=(1, 1, 1, 1, 1))
    freqs = setup.freqs
    f2, f4 = freqs ** -2, freqs ** -4
    keep = (setup.nu_DM, setup.nu_GM, setup.nu_tau)

    def S(v):
        return v.sum(-1)

    if ff == (1, 0, 1, 0, 0):          # pptoaslib.py:753-760
        H21_n = Hn[..., 0, 0, :]       # == Hn[0, 2]/phis_d[2]
        nu_zero_GM = (S(f4 * H21_n) / S(H21_n)) ** -0.25
        return setup.nu_DM, nu_zero_GM, setup.nu_tau

    if ff == (1, 1, 1, 0, 0):          # pptoaslib.py:779-812
        # the reference divides the DM/GM rows by the full phis_deriv, so
        # Hn[1, j]/pd1 = Hn[2, j]/pd2 = Hn[0, j] exactly
        if option == 0:                # zero phi-DM covariance
            H21_n, H23_n = Hn[..., 0, 0, :], Hn[..., 0, 2, :]
            H31_n, H33_n = H21_n, H23_n
            A, B = S(H31_n * f4), S(H31_n)
            C, D = S(H23_n * f2), S(H23_n)
            E, F = S(H33_n * f4), S(H33_n)
            G, H = S(H21_n * f2), S(H21_n)
        elif option == 1:              # zero phi-GM covariance
            H21_n, H22_n = Hn[..., 0, 0, :], Hn[..., 0, 1, :]
            H31_n, H32_n = H21_n, H22_n
            A, B = S(H21_n * f4), S(H21_n)
            C, D = S(H32_n * f2), S(H32_n)
            E, F = S(H22_n * f4), S(H22_n)
            G, H = S(H31_n * f2), S(H31_n)
        else:
            return keep
        z = torch.zeros_like(A)
        coeffs = torch.stack([A * C - E * G, z, E * H - A * D, z,
                              F * G - B * C, z, B * D - F * H], dim=-1)
        nu_zero = _nearest_positive_real_root(coeffs, freqs.mean(-1),
                                              square=False)
        return nu_zero, nu_zero, setup.nu_tau

    # (1, 1, 1, 1, 0): pptoaslib.py:837-892.  The reference divides by
    # bare (nu^-2 - nu_DM^-2) etc; the identity rows carry the extra
    # Dconst/P factors explicitly
    P = setup.P[..., None] if torch.is_tensor(setup.P) else setup.P
    c1 = DCONST / P
    c2 = DCONST ** 2 / P
    Hij = Hn[..., :4, :4, :].sum(-1)
    H14, H44 = Hij[..., 3, 0], Hij[..., 3, 3]
    if option == 0:
        H21_n, H23_n, H24_n = (c1 * Hn[..., 0, 0, :], c1 * Hn[..., 0, 2, :],
                               c1 * Hn[..., 0, 3, :])
        H31_n, H33_n, H34_n = (c2 * Hn[..., 0, 0, :], c2 * Hn[..., 0, 2, :],
                               c2 * Hn[..., 0, 3, :])
        A, a = S(f4 * H34_n), S(H34_n)
        B, b = S(f2 * H21_n), S(H21_n)
        C, c = S(f4 * H31_n), S(H31_n)
        D, d = S(f2 * H23_n), S(H23_n)
        E, e = S(f4 * H33_n), S(H33_n)
        F, f = S(f2 * H24_n), S(H24_n)
        P5 = A * A * B + H44 * C * D + H14 * E * F - H44 * B * E - \
            A * C * F - H14 * A * D
        P4 = -A * A * b - H44 * C * d - H14 * E * f + H44 * b * E + \
            A * C * f + H14 * A * d
        P3 = -2 * A * a * B - H44 * c * D - H14 * e * F + H44 * B * e + \
            (A * c + a * C) * F + H14 * a * D
        P2 = 2 * A * a * b + H44 * c * d + H14 * e * f - H44 * b * e - \
            (A * c + a * C) * f - H14 * a * d
        P1 = a * a * B - a * c * F
        P0 = -a * a * b + a * c * f
        coeffs = torch.stack([P5, P4, P3, P2, P1, P0], dim=-1)
    elif option == 1:
        H21_n, H22_n, H24_n = (c1 * Hn[..., 0, 0, :], c1 * Hn[..., 0, 1, :],
                               c1 * Hn[..., 0, 3, :])
        H31_n, H32_n, H34_n = (c2 * Hn[..., 0, 0, :], c2 * Hn[..., 0, 1, :],
                               c2 * Hn[..., 0, 3, :])
        A, a = S(f2 * H24_n), S(H24_n)
        B, b = S(f4 * H31_n), S(H31_n)
        C, c = S(f2 * H21_n), S(H21_n)
        D, d = S(f4 * H32_n), S(H32_n)
        E, e = S(f2 * H22_n), S(H22_n)
        F, f = S(f4 * H34_n), S(H34_n)
        P4 = A * A * B + H44 * C * D + H14 * E * F - H44 * B * E - \
            A * C * F - H14 * A * D
        P3 = -2 * A * a * B - H44 * c * D - H14 * e * F + H44 * B * e + \
            (A * c + a * C) * F + H14 * a * D
        P2 = -(A * A * b - a * a * B) - H44 * C * d - H14 * E * f + \
            H44 * b * E + (A * C * f - a * c * F) + H14 * A * d
        P1 = 2 * A * a * b + H44 * c * d + H14 * e * f - H44 * b * e - \
            (A * c + a * C) * f - H14 * a * d
        P0 = -a * a * b + a * c * f
        coeffs = torch.stack([P4, P3, P2, P1, P0], dim=-1)
    else:
        return keep
    # roots in u = nu^2 for this branch (the reference takes roots**0.5)
    nu_zero = _nearest_positive_real_root(coeffs, freqs.mean(-1),
                                          square=True)
    return nu_zero, nu_zero, setup.nu_tau


def _nearest_positive_real_root(coeffs, target, square=False):
    """Positive real root nearest target of each polynomial, batched.

    coeffs (..., deg+1), descending, in the variable v (v = nu^2 when
    square); target (...,).  The variable is rescaled to v' = v/t (t =
    target, or its square) and the coefficients normalized, then the
    polynomial is evaluated on a 1e-3..1e3 logarithmic grid of v'; the
    sign changes are refined by masked bisection and the root nearest the
    target is returned (the reference's np.roots pick,
    pptoaslib.py:806-811, 884-890).  Without a bracketed root, or with
    non-finite coefficients, the target is returned.
    """
    dtype, dev = coeffs.dtype, coeffs.device
    target = torch.as_tensor(target, dtype=dtype, device=dev)
    t = target ** 2 if square else target
    deg = coeffs.shape[-1] - 1
    powers = t[..., None] ** torch.arange(deg, -1, -1, dtype=dtype,
                                          device=dev)
    cs = coeffs * powers
    norm = torch.amax(torch.abs(cs), dim=-1, keepdim=True)
    cs = cs / torch.where(norm > 0.0, norm, torch.ones_like(norm))
    cs_b = cs[..., None, :]                         # (..., 1, deg+1)

    def horner(v):
        acc = cs_b[..., 0].expand(v.shape)
        for j in range(1, deg + 1):
            acc = torch.addcmul(cs_b[..., j], acc, v)
        return acc

    grid = torch.exp(torch.linspace(math.log(1e-3), math.log(1e3),
                                    _ROOT_GRID, dtype=dtype, device=dev))
    grid = grid.expand(cs.shape[:-1] + (_ROOT_GRID,))
    pv = horner(grid)
    sign_change = (pv[..., :-1] == 0.0) | (
        torch.sign(pv[..., :-1]) * torch.sign(pv[..., 1:]) < 0.0)
    # a degree-deg polynomial changes sign at most deg times: bisect only
    # the (at most 2 deg, to spare rounding's extra changes) intervals
    # with a change, those nearest the target first
    near = _ROOT_GRID - torch.abs(
        torch.arange(_ROOT_GRID - 1, device=dev) - _ROOT_GRID // 2)
    _, sel = torch.topk(sign_change * near, min(2 * deg, _ROOT_GRID - 1),
                        dim=-1)
    bracketed = torch.gather(sign_change, -1, sel)
    lo = torch.gather(grid, -1, sel)
    hi = torch.gather(grid, -1, sel + 1)
    plo = torch.gather(pv, -1, sel)
    # each step is a handful of launches on the card (the values are
    # normalized: a product of two of them does not underflow)
    for _ in range(_ROOT_BISECT):
        mid = 0.5 * (lo + hi)
        pm = horner(mid)
        go_left = pm * plo > 0.0
        lo = torch.where(go_left, mid, lo)
        plo = torch.where(go_left, pm, plo)
        hi = torch.where(go_left, hi, mid)
    roots_v = 0.5 * (lo + hi) * t[..., None]
    roots_nu = torch.sqrt(roots_v) if square else roots_v
    dist = torch.where(bracketed, torch.abs(roots_nu - target[..., None]),
                       torch.full_like(roots_nu, math.inf))
    best = torch.argmin(dist, dim=-1, keepdim=True)
    any_root = bracketed.any(-1) & torch.isfinite(cs).all(-1)
    return torch.where(any_root, torch.gather(roots_nu, -1, best)[..., 0],
                       target)
