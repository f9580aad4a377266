"""Zero-covariance reference frequencies, closed-form branches.

Port of the closed-form branches of pulseportraiture_tpu.fitters.nu_zeros
get_nu_zeros, as fitters/portrait.py `_nu_zeros_closed_form` takes them
(reference pptoaslib.py:733-906), batched over leading axes:

  (1,1,0,0,0)  phi+DM:        weighted harmonic mean of nu^-2
  (0,0,0,1,1)  tau+alpha:     log-space mean
  (1,1,0,1,0)  phi+DM+tau:    3x3 cofactor closed form
  (1,1,0,1,1)  phi+DM+tau+a:  4x4 cofactor closed form
  (1,1,1,1,1)  all:           approximated by the (1,1,0,1,1) formulas

As in the JAX package, the reference's divisions of Hessian rows by the
phase/DM derivative or the log-frequency ratio are replaced by exact
identities (Hn[1,j] = phis_d[1] Hn[0,j]; the alpha row is the tau row
times dtau_a/dtau_t), so no channel at the reference frequency gives 0/0.
Flag sets without a zero-covariance frequency keep the fit references.
The polynomial GM branches (1,0,1,0,0), (1,1,1,0,0) and (1,1,1,1,0) are
not ported yet (ROADMAP, GM nu_zeros) and raise NotImplementedError.
"""

from __future__ import annotations

import torch

from pulseportraiture_tpu_torch.fitters import stats

# flag sets for which the JAX package solves a zero-covariance frequency
_SOLVED = {(1, 1, 0, 0, 0), (1, 0, 1, 0, 0), (0, 0, 0, 1, 1),
           (1, 1, 0, 1, 0), (1, 1, 0, 1, 1), (1, 1, 1, 1, 1),
           (1, 1, 1, 0, 0), (1, 1, 1, 1, 0)}
_PORTED = {(1, 1, 0, 0, 0), (0, 0, 0, 1, 1), (1, 1, 0, 1, 0),
           (1, 1, 0, 1, 1), (1, 1, 1, 1, 1)}


def require_ported(fit_flags):
    """Raise NotImplementedError for the flag sets whose zero-covariance
    frequency is not ported (checked before a fit starts)."""
    ff = tuple(int(bool(f)) for f in fit_flags)
    if ff in _SOLVED and ff not in _PORTED:
        raise NotImplementedError(
            f"zero-covariance frequency for fit_flags={ff} is not ported "
            "(ROADMAP: the GM nu_zeros branches)")


def nu_zeros_closed_form(setup, fit_flags, moments, params=None,
                         log10_tau=True):
    """(nu_DM, nu_GM, nu_tau) output references, each (...,), from the
    optimizer's final moments; params (..., 5), the fitted point, gives
    the tau row factor of the scattering branches (as the JAX package
    takes it from the fitted point, not from the moments)."""
    ff = tuple(int(bool(f)) for f in fit_flags)
    require_ported(ff)
    if ff not in _SOLVED:
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
