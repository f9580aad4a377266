"""Zero-covariance reference frequencies, closed-form (phi, DM) branch.

Port of the branch of pulseportraiture_tpu.fitters.nu_zeros that
fitters/portrait.py `_nu_zeros_closed_form` takes for fit_flags
(1, 1, 0, 0, 0) (reference pptoaslib.py:746-752):

    nu_zero_DM = (sum_n nu_n^-2 H_n / sum_n H_n)^-1/2,  H_n = Hn[0, 0, n]

Flag sets without a zero-covariance frequency keep the fit references,
as in the JAX package.  The GM and scattering branches are not ported
yet (ROADMAP queue 1, items 5 and 12) and raise NotImplementedError.
"""

from __future__ import annotations

from pulseportraiture_tpu_torch.fitters import stats

# flag sets for which the JAX package solves a zero-covariance frequency
_SOLVED = {(1, 1, 0, 0, 0), (1, 0, 1, 0, 0), (0, 0, 0, 1, 1),
           (1, 1, 0, 1, 0), (1, 1, 0, 1, 1), (1, 1, 1, 1, 1),
           (1, 1, 1, 0, 0), (1, 1, 1, 1, 0)}


def nu_zeros_closed_form(setup, fit_flags, moments):
    """(nu_DM, nu_GM, nu_tau) output references, each (...,), from the
    optimizer's final moments at the fitted point."""
    ff = tuple(int(bool(f)) for f in fit_flags)
    if ff not in _SOLVED:
        return setup.nu_DM, setup.nu_GM, setup.nu_tau
    if ff != (1, 1, 0, 0, 0):
        raise NotImplementedError(
            f"zero-covariance frequency for fit_flags={ff} is not ported "
            "(ROADMAP queue 1: item 5, the GM nu_zeros branches; item 12, "
            "the scattering fit)")
    Hn = stats.hess_per_channel_from_moments(moments, setup,
                                             fit_flags=(1, 1, 1, 1, 1))
    H21_n = Hn[..., 0, 0, :]      # == Hn[0, 1]/phis_d[1], division-free
    nu_zero_DM = (((setup.freqs ** -2 * H21_n).sum(-1) / H21_n.sum(-1))
                  ** -0.5)
    return nu_zero_DM, setup.nu_GM, setup.nu_tau
