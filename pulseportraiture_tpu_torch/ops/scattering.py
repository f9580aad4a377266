"""Scattering law and its analytic Fourier-domain representation.

Port of pulseportraiture_tpu/ops/scattering.py.  The scattering impulse
response is a one-sided exponential with timescale tau(nu) =
tau (nu/nu_tau)^alpha; its FT at harmonic k is B_k = (1 + 2 pi i k tau)^-1
(tau in [rot]).  Torch has complex tensors on the card, so the complex
forms run where their input lies; the split-real form is kept for
callers that want (Br, Bi).  Host numbers (floats, numpy arrays) become
float64 tensors.  scattering_kernel and add_scattering are the
reference's time-domain forms, kept for cross-checks and simulation.
Reference: pplib.py:1098-1144, 4049-4095.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pulseportraiture_tpu_torch._device import as_tensor
from pulseportraiture_tpu_torch.config import SCATTERING_ALPHA


def _as_tensor(v):
    """Tensors pass through; host numbers become float64 tensors."""
    if torch.is_tensor(v):
        return v if v.dtype.is_floating_point else v.to(torch.float64)
    return torch.as_tensor(np.asarray(v, dtype=np.float64))


def scattering_times(tau, alpha, freqs, nu_tau):
    """tau(nu) = tau * (freqs/nu_tau)**alpha.  Reference: pplib.py:4049-4053."""
    return tau * (freqs / nu_tau) ** alpha


def scattering_profile_FT_ri(tau, nbin):
    """scattering_profile_FT as a split (real, imag) pair:
    Br = 1/(1 + c^2 tau^2), Bi = -c tau/(1 + c^2 tau^2), c = 2 pi k.
    A tensor tau (...,) gives (..., nharm)."""
    nharm = nbin // 2 + 1
    tau = _as_tensor(tau)
    k = torch.arange(nharm, dtype=tau.dtype, device=tau.device)
    ct = 2.0 * math.pi * k * tau[..., None]
    den = 1.0 + ct * ct
    return 1.0 / den, -ct / den


def scattering_profile_FT(tau, nbin):
    """Analytic FT of the one-sided exponential kernel, nharm samples
    (complex); ones when tau == 0.  Reference: pplib.py:4055-4078."""
    return scattering_portrait_FT(tau, nbin)


def scattering_portrait_FT(taus, nbin):
    """Per-channel stack of scattering_profile_FT: (..., nchan, nharm),
    complex, on the device of taus.  Reference: pplib.py:4080-4095."""
    taus = _as_tensor(taus)
    nharm = nbin // 2 + 1
    k = torch.arange(nharm, dtype=taus.dtype, device=taus.device)
    B = 1.0 / torch.complex(torch.ones_like(taus[..., None] * k),
                            2.0 * math.pi * k * taus[..., None])
    return torch.where(taus[..., None] == 0.0, torch.ones_like(B), B)


def scattering_portrait_FT_np(taus, nbin):
    """Host numpy twin of scattering_portrait_FT (complex128) for assembly
    and simulation code that materializes the result on the host."""
    taus = np.asarray(taus, dtype=np.float64)
    nharm = nbin // 2 + 1
    k = np.arange(nharm)
    B = (1.0 + 2.0j * np.pi * k * taus[..., None]) ** -1
    return np.where(taus[..., None] == 0.0, np.ones_like(B), B)


def scattering_kernel(tau, nu_ref, freqs, phases, P, alpha=SCATTERING_ALPHA,
                      device=None):
    """Time-domain one-sided exponential kernel (nchan, nbin), the
    reference's legacy form, for cross-checks: tau in [s] (or [bin] with
    phases in [bin] and P = 1).  Reference: pplib.py:1098-1119."""
    freqs = as_tensor(freqs, device)
    phases = as_tensor(phases, freqs.device, freqs.dtype)
    nchan, nbin = freqs.shape[0], phases.shape[0]
    if tau == 0.0:
        sk = torch.zeros((nchan, nbin), dtype=freqs.dtype,
                         device=freqs.device)
        sk[:, 0] = 1.0
        return sk
    ts = (phases * P).expand(nchan, nbin)
    taus = scattering_times(tau, alpha, freqs, nu_ref)
    return torch.exp(-ts / taus[:, None])


def add_scattering(port, kernel, repeat=3, device=None):
    """port (nchan, nbin) convolved with a kernel, both tiled repeat times
    against edge effects; the middle copy is returned.  Reference:
    pplib.py:1121-1144."""
    port = torch.atleast_2d(as_tensor(port, device))
    kernel = torch.atleast_2d(as_tensor(kernel, port.device, port.dtype))
    nbin = port.shape[-1]
    mid = repeat // 2
    d = port.repeat(1, repeat)
    k = kernel.repeat(1, repeat)
    norm_kernel = k / k.sum(dim=-1, keepdim=True)
    out = torch.fft.irfft(torch.fft.rfft(norm_kernel, dim=-1) *
                          torch.fft.rfft(d, dim=-1), n=nbin * repeat, dim=-1)
    return out[:, mid * nbin:(mid + 1) * nbin]
