"""Global physical constants and numerical-convention configuration.

These mirror the reference's compile-time settings (reference: pplib.py:44-83)
but are collected into one typed module instead of scattered module globals.
Every fitted DM depends on the dispersion-constant choice, so it is explicit
here and threaded through the API as a default, never hard-coded downstream.
"""

from __future__ import annotations

import dataclasses

# Exact dispersion constant e^2/(2 pi m_e c) [MHz^2 cm^3 pc^-1 s] (PRESTO).
# Reference: pplib.py:45
DCONST_EXACT = 4.148808e3

# "Traditional" dispersion constant used by PSRCHIVE/TEMPO/PINT.
# Reference: pplib.py:48
DCONST_TRAD = 1.0 / 0.000241

# The framework default matches the reference default (pplib.py:51).
DCONST = DCONST_TRAD

# Default power-law index for the scattering law tau(nu) = tau*(nu/nu_ref)**alpha.
# Reference: pplib.py:54
SCATTERING_ALPHA = -4.0

# If F0_FACT == 0 the zero-frequency (sum) Fourier harmonic is zeroed out in
# all Fourier-domain fits; 1 keeps it.  Reference: pplib.py:64-66
F0_FACT = 0

# Upper bound on Gaussian component FWHM [rot] used in model fits.
# Reference: pplib.py:70
WID_MAX = 0.25

# Default three-digit evolution code for Gaussian models: one digit per
# (loc, wid, amp); '0' = power-law evolution, '1' = linear evolution.
# Reference: pplib.py:79
DEFAULT_MODEL_CODE = "000"

# Default noise estimation method; see ops.noise.  Reference: pplib.py:62
DEFAULT_NOISE_METHOD = "PS"

# Fudge factor for scattering portrait functions; currently unused, kept for
# format compatibility.  Reference: pplib.py:83
BINSHIFT = 1.0

# SNR fudge factor matching (poorly) PSRCHIVE SNRs.  Reference: pplib.py:2296
SNR_FUDGE = 3.25


@dataclasses.dataclass(frozen=True)
class PPConfig:
    """Typed run configuration (reference tiers 1+2, SURVEY.md section 5)."""

    dconst: float = DCONST
    scattering_alpha: float = SCATTERING_ALPHA
    f0_fact: int = F0_FACT
    wid_max: float = WID_MAX
    default_model_code: str = DEFAULT_MODEL_CODE
    noise_method: str = DEFAULT_NOISE_METHOD
    snr_fudge: float = SNR_FUDGE


DEFAULT_CONFIG = PPConfig()

# Return-code strings for the trust-region/TNC-style optimizers
# (reference: pplib.py:111-119).  Our jit fitter reports:
#   0 = converged on gradient, 1 = converged on function value,
#   2 = converged on step size, 3 = max iterations reached.
RCSTRINGS = {
    0: "GCONVERGED: Converged (|grad| ~= 0).",
    1: "FCONVERGED: Converged (|f_n - f_(n-1)| ~= 0).",
    2: "XCONVERGED: Converged (|x_n - x_(n-1)| ~= 0).",
    3: "MAXITER: Maximum number of iterations reached.",
}
