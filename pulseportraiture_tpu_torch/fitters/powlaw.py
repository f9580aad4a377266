"""Power-law spectrum fit and DM-from-frequency-residuals fit.

Port of pulseportraiture_tpu.fitters.powlaw.  Reference: pplib.py:1048-1096,
1763-1840 (lmfit power law; weighted polyfit of residuals against nu^-2
with its zero-crossing reference frequency).
"""

from __future__ import annotations

import numpy as np

from pulseportraiture_tpu_torch.config import DCONST
from pulseportraiture_tpu_torch.models.gaussian import (_t,
                                                        levenberg_marquardt)
from pulseportraiture_tpu_torch.utils import DataBunch


def fit_powlaw(data, init_params, errs, freqs, nu_ref):
    """Fit F(nu) = A*(nu/nu_ref)**alpha by the bounded LM loop on data's
    device (host data: the CPU, float64).  The errors are
    lmfit's: the covariance scaled by the reduced chi2.  Reference:
    pplib.py:1763-1802."""
    data = _t(data)
    errs_b = _t(errs, like=data).expand(data.shape)
    freqs = _t(freqs, like=data)

    def residual(p):
        return (data - p[0] * (freqs / nu_ref) ** p[1]) / errs_b

    res, JtJ = levenberg_marquardt(residual, _t(init_params, like=data),
                                   [-np.inf, -np.inf], [np.inf, np.inf],
                                   np.ones(2))
    dof = data.shape[0] - 2
    chi2 = float(res.chi2)
    try:
        cov = np.linalg.inv(JtJ.cpu().numpy())
        perr = np.sqrt(np.clip(np.diag(cov) * chi2 / max(dof, 1), 0, None))
    except np.linalg.LinAlgError:
        perr = np.zeros(2)
    x = res.x.cpu().numpy()
    return DataBunch(alpha=float(x[1]), alpha_err=float(perr[1]),
                     amp=float(x[0]), amp_err=float(perr[0]),
                     residuals=(residual(res.x) * errs_b).cpu().numpy(),
                     nu_ref=nu_ref, chi2=chi2, dof=dof,
                     red_chi2=chi2 / max(dof, 1))


def fit_DM_to_freq_resids(freqs, frequency_residuals, errs, dconst=DCONST):
    """Weighted linear fit res = a*nu^-2 + b -> (DM, offset, nu_ref), on
    the host.  Reference: pplib.py:1804-1840."""
    freqs = np.asarray(freqs, dtype=float)
    y = np.asarray(frequency_residuals, dtype=float)
    errs = np.asarray(errs, dtype=float)
    x = freqs ** -2
    p, V = np.polyfit(x=x, y=y, deg=1, w=errs ** -2, cov=True)
    a, b = p[0], p[1]
    nu_ref = (-b / a) ** -0.5 if -b / a > 0 else np.nan
    a_err, b_err = np.sqrt(np.diag(V))
    cov = V.ravel()[1]
    nu_ref_err = (((nu_ref ** 2) / 4.0) *
                  ((a_err / a) ** 2 + (b_err / b) ** 2 -
                   2 * cov / (a * b))) ** 0.5 if np.isfinite(nu_ref) \
        else np.nan
    residuals = y - (a * x + b)
    chi2 = float(((residuals / errs) ** 2).sum())
    dof = len(y) - 2
    return DataBunch(DM=a / dconst, DM_err=a_err / dconst, offset=b,
                     offset_err=b_err, nu_ref=nu_ref,
                     nu_ref_err=nu_ref_err, ab_cov=cov,
                     residuals=residuals, chi2=chi2, dof=dof,
                     red_chi2=chi2 / max(dof, 1))


def powlaw(nu, nu_ref, A, alpha):
    """Power-law spectrum A*(nu/nu_ref)**alpha.  Reference: pplib.py:1048."""
    return A * (nu / nu_ref) ** alpha


def powlaw_integral(nu2, nu1, nu_ref, A, alpha):
    """Definite integral of the power law from nu1 to nu2 (the log form at
    alpha == -1).  Reference: pplib.py:1054-1066."""
    alpha = float(alpha)
    if alpha == -1.0:
        return A * nu_ref * np.log(nu2 / nu1)
    c = 1.0 + alpha
    return A * nu_ref ** -alpha * (nu2 ** c - nu1 ** c) / c


def powlaw_freqs(lo, hi, N, alpha, mid=False):
    """Channel-edge (or, mid=True, centre) frequencies that give equal
    flux per channel under a power-law spectrum.  Reference:
    pplib.py:1068-1096."""
    alpha = float(alpha)
    if alpha == -1.0:
        edges = np.exp(np.linspace(np.log(lo), np.log(hi), N + 1))
    else:
        c = 1.0 + alpha
        edges = np.linspace(lo ** c, hi ** c, N + 1) ** (1.0 / c)
    if mid:
        return 0.5 * (edges[:-1] + edges[1:])
    return edges
