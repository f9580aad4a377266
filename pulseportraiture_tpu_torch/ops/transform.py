"""Phase-delay model (port of pulseportraiture_tpu.ops.transform).

    phi_n = phi + (Dconst/P) DM (nu_n^-2 - nu_DM^-2)
                + (Dconst^2/P) GM (nu_n^-4 - nu_GM^-4)

Every function takes tensors or Python floats and broadcasts like the
JAX originals; batched callers pass per-item scalars with a trailing
singleton axis.  Floor-mod is torch.remainder (jnp `%`), never fmod.
Reference: pptoaslib.py:181-238, pplib.py:2577-2632.
"""

from __future__ import annotations

import math

import torch

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
