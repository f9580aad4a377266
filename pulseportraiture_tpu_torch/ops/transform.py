"""Phase-delay model (port of pulseportraiture_tpu.ops.transform).

    phi_n = phi + (Dconst/P) DM (nu_n^-2 - nu_DM^-2)
                + (Dconst^2/P) GM (nu_n^-4 - nu_GM^-4)

Every function takes tensors or Python floats and broadcasts like the
JAX originals; batched callers pass per-item scalars with a trailing
singleton axis.  Floor-mod is torch.remainder (jnp `%`), never fmod.
The host helpers (phasor, guess_fit_freq) take a device for host
inputs, the card by default.  Reference: pptoaslib.py:83-238,
pplib.py:2577-2648.
"""

from __future__ import annotations

import math

import torch

from pulseportraiture_tpu_torch._device import as_tensor
from pulseportraiture_tpu_torch.config import DCONST


def _inv2(nu):
    """nu**-2 that maps inf -> 0 exactly (nu_ref = inf: no reference)."""
    if not torch.is_tensor(nu):
        return 0.0 if math.isinf(nu) else float(nu) ** -2.0
    return torch.where(torch.isinf(nu), torch.zeros_like(nu), nu ** -2.0)


def _inv4(nu):
    if not torch.is_tensor(nu):
        return 0.0 if math.isinf(nu) else float(nu) ** -4.0
    return torch.where(torch.isinf(nu), torch.zeros_like(nu), nu ** -4.0)


def mod_pm_half(x):
    """Map x to [-0.5, 0.5) with the reference's two-step where/mod
    (pptoaslib.py:209-214)."""
    if not torch.is_tensor(x):
        x = x % 1.0 if abs(x) >= 0.5 else x
        return x - 1.0 if x >= 0.5 else x
    x = torch.where(torch.abs(x) >= 0.5, torch.remainder(x, 1.0), x)
    return torch.where(x >= 0.5, x - 1.0, x)


def phase_shifts(phi, DM, GM, freqs, nu_DM=math.inf, nu_GM=math.inf, P=None,
                 mod=False, dconst=DCONST):
    """Per-frequency phase delays [rot] (or [sec] if P is None)."""
    if P is None:
        P = 1.0
        mod = False
    dispersive = dconst * DM * (_inv2(freqs) - _inv2(nu_DM)) / P
    refractive = dconst ** 2 * GM * (_inv4(freqs) - _inv4(nu_GM)) / P
    delays = phi + dispersive + refractive
    if mod:
        delays = mod_pm_half(delays)
    return delays


def phase_shifts_deriv(freqs, nu_DM=math.inf, nu_GM=math.inf, P=None,
                       dconst=DCONST):
    """Gradient of phase_shifts wrt (phi, DM, GM): (..., 3, nchan)."""
    if P is None:
        P = 1.0
    dDM = dconst * (_inv2(freqs) - _inv2(nu_DM)) / P
    dGM = dconst ** 2 * (_inv4(freqs) - _inv4(nu_GM)) / P
    dphi = torch.ones_like(dDM)
    return torch.stack(torch.broadcast_tensors(dphi, dDM, dGM), dim=-2)


def DM_delay(DM, freq, freq_ref=math.inf, P=None, dconst=DCONST):
    """Dispersive delay [sec] (or [rot] if P given) between frequencies."""
    delay = dconst * DM * (_inv2(freq) - _inv2(freq_ref))
    if P is not None:
        return delay / P
    return delay


def phase_transform(phi, DM, nu_ref1=math.inf, nu_ref2=math.inf, P=None,
                    mod=False, dconst=DCONST):
    """Transport a delay referenced at nu_ref1 to nu_ref2."""
    if P is None:
        P = 1.0
        mod = False
    phi_prime = phi + dconst * DM * (_inv2(nu_ref2) - _inv2(nu_ref1)) / P
    if mod:
        phi_prime = mod_pm_half(phi_prime)
    return phi_prime


def phasor(phis, nharm, dtype=None, device=None):
    """exp(2 pi i phis k) for harmonics k = 0..nharm-1, complex, with a
    trailing harmonic axis appended to phis' shape.  Reference:
    pptoaslib.py:233-238."""
    phis = as_tensor(phis, device)
    k = torch.arange(nharm, dtype=phis.dtype, device=phis.device)
    ang = 2.0 * math.pi * phis[..., None] * k
    out = torch.complex(torch.cos(ang), torch.sin(ang))
    return out if dtype is None else out.to(dtype)


def guess_fit_freq(freqs, SNRs=None, device=None):
    """SNR nu^-2 weighted centre-of-mass frequency: a zero-covariance
    frequency estimate before a fit exists.  Reference:
    pplib.py:2618-2632."""
    freqs = as_tensor(freqs, device)
    nu0 = (freqs.min() + freqs.max()) * 0.5
    SNRs = torch.ones_like(freqs) if SNRs is None else \
        as_tensor(SNRs, freqs.device, freqs.dtype)
    w = SNRs * freqs ** -2
    return nu0 + torch.sum((freqs - nu0) * w) / torch.sum(w)


def GM_from_DMc(DMc, D, a_perp):
    """The nu^-4 delay factor GM of a discrete cloud of dispersion measure
    DMc [pc cm^-3], at D [kpc] from the Earth, of transverse scale a_perp
    [AU] (Lam+16).  Reference: pptoaslib.py:83-96."""
    c = 3e10 / 3.1e21  # cm/s over cm/kpc
    return DMc ** 2 * (c * D) / (2.0 * (a_perp * 4.8e-9) ** 2)


def DMc_from_GM(GM, D, a_perp):
    """The exact inverse of GM_from_DMc (the reference's version,
    pptoaslib.py:98-110, misplaces a square on a_perp; PARITY.md)."""
    c = 3e10 / 3.1e21
    return (GM * 2.0 * (a_perp * 4.8e-9) ** 2 / (c * D)) ** 0.5


def calculate_TOA(epoch, P, phi, DM=0.0, nu_ref1=math.inf, nu_ref2=math.inf):
    """TOA (an io.mjd.MJD) = epoch + phase_transform(phi) P, with the
    un-Doppler-corrected DM.  Reference: pplib.py:2634-2648."""
    phi_prime = phase_transform(phi, DM, nu_ref1, nu_ref2, P, mod=False)
    return epoch.add_seconds(float(phi_prime) * P)
