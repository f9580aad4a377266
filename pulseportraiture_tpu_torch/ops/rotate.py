"""Rotation and dedispersion: rFFT, phase-ramp multiply, irFFT.

Port of pulseportraiture_tpu.ops.rotate.  Positive phase or DM rotate the
data to earlier phases, i.e. dedisperse for freqs < nu_ref (reference
pplib.py:2433-2434).  The torch functions run on their input's device
(host data: `device`, the card by default) in its dtype; the ramp's
angles are reduced mod 1 turn in float64 before the trig, so a float32
portrait rotated by many turns keeps its phase.  rotate_portrait_np is
the host float64 version the pipeline uses to add the header dispersion
to a template once.  Reference: pplib.py:2338-2575, pptoaslib.py:52-81.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pulseportraiture_tpu_torch._device import as_tensor
from pulseportraiture_tpu_torch.config import DCONST
from pulseportraiture_tpu_torch.ops.transform import _inv2, phase_shifts


def _rotate(x, phis):
    """irfft(rfft(x) e^{+2 pi i k phis}); phis broadcast to x.shape[:-1]."""
    nbin = x.shape[-1]
    X = torch.fft.rfft(x, dim=-1)
    k = torch.arange(X.shape[-1], dtype=torch.float64, device=x.device)
    phis = torch.as_tensor(phis, dtype=torch.float64, device=x.device)
    turns = torch.remainder(phis[..., None] * k, 1.0)
    ramp = torch.polar(torch.ones_like(turns), 2.0 * math.pi * turns)
    return torch.fft.irfft(X * ramp.to(X.dtype), n=nbin, dim=-1)


def rotate_profile(profile, phase=0.0, device=None):
    """Rotate a profile (..., nbin) by phase [rot].  Reference:
    pplib.py:2548-2559."""
    profile = as_tensor(profile, device)
    return _rotate(profile, phase)


def rotate_portrait(port, phase=0.0, DM=None, P=None, freqs=None,
                    nu_ref=math.inf, dconst=DCONST, device=None):
    """Rotate and/or dedisperse a (..., nchan, nbin) portrait.  Reference:
    pplib.py:2428-2460."""
    port = as_tensor(port, device)
    if DM is None or freqs is None:
        phis = torch.as_tensor(phase, dtype=torch.float64,
                               device=port.device).expand(port.shape[:-1])
    else:
        f = as_tensor(freqs, port.device, torch.float64)
        phis = phase + dconst * DM / P * (_inv2(f) - _inv2(nu_ref))
    return _rotate(port, phis)


def rotate_portrait_full(port, phi, DM, GM, freqs, nu_DM=math.inf,
                         nu_GM=math.inf, P=None, dconst=DCONST, device=None):
    """Rotate by phi, DM and GM at once.  Reference: pptoaslib.py:52-81."""
    port = as_tensor(port, device)
    f = as_tensor(freqs, port.device, torch.float64)
    return _rotate(port, phase_shifts(phi, DM, GM, f, nu_DM, nu_GM, P,
                                      mod=False, dconst=dconst))


def rotate_data(data, phase=0.0, DM=0.0, Ps=None, freqs=None,
                nu_ref=math.inf, dconst=DCONST, device=None):
    """Rotate or dedisperse data of 1, 2 or 4 dimensions: (nbin,),
    (nchan, nbin) or (nsub, npol, nchan, nbin).  Ps: a period or (nsub,)
    periods [s]; freqs: a frequency, (nchan,) or (nsub, nchan).
    Reference: pplib.py:2338-2426."""
    data = as_tensor(data, device)
    ndim = data.dim()
    dm_zero = not torch.is_tensor(DM) and not isinstance(DM, bool) and \
        isinstance(DM, (int, float)) and float(DM) == 0.0
    if freqs is None or (dm_zero and Ps is None):
        phis = torch.as_tensor(phase, dtype=torch.float64,
                               device=data.device).expand(data.shape[:-1])
        return _rotate(data, phis)
    x = data
    while x.dim() < 4:
        x = x[None]
    nsub, npol, nchan = x.shape[:3]
    f64 = dict(dtype=torch.float64, device=data.device)
    Ps_arr = torch.as_tensor(np.asarray(Ps, np.float64), **f64).expand(nsub)
    freqs_arr = torch.as_tensor(np.asarray(freqs, np.float64), **f64)
    if freqs_arr.dim() == 0:
        freqs_arr = freqs_arr.expand(nchan)
    if freqs_arr.dim() == 1:
        freqs_arr = freqs_arr.expand(nsub, nchan)
    D = dconst * DM / Ps_arr                                   # (nsub,)
    phis = phase + D[:, None] * (_inv2(freqs_arr) - _inv2(nu_ref))
    out = _rotate(x, phis[:, None, :].expand(nsub, npol, nchan))
    if ndim == 1:
        return out[0, 0, 0]
    if ndim == 2:
        return out[0, 0]
    return out


def fft_rotate(arr, bins, device=None):
    """Rotate left by a (fractional) number of bins.  Reference:
    pplib.py:2561-2575."""
    arr = as_tensor(arr, device)
    return _rotate(arr, float(bins) / arr.shape[-1] if not
                   torch.is_tensor(bins) else bins.double() / arr.shape[-1])


def add_DM_nu(port, phase=0.0, DM=None, P=None, freqs=None, xs=(-2.0,),
              Cs=(1.0,), nu_ref=math.inf, dconst=DCONST, device=None):
    """Rotate a portrait with a power-law dispersion law: the delay is
    sum_j C_j (nu^x_j - nu_ref^x_j) in place of nu^-2 - nu_ref^-2 (to
    simulate a frequency-dependent DM).  Reference: pplib.py:2509-2546."""
    port = as_tensor(port, device)
    if DM is None or freqs is None:
        phis = torch.as_tensor(phase, dtype=torch.float64,
                               device=port.device).expand(port.shape[:-1])
        return _rotate(port, phis)
    f = as_tensor(freqs, port.device, torch.float64)
    xs, Cs = list(xs), list(Cs)
    if len(Cs) < len(xs):
        Cs = Cs + [1.0] * (len(xs) - len(Cs))
    freq_term = torch.zeros_like(f)
    for C, x in zip(Cs, xs):
        if math.isinf(nu_ref):
            ref_term = 0.0 if x < 0 else math.inf
        else:
            ref_term = nu_ref ** x
        freq_term = freq_term + C * (f ** x - ref_term)
    return _rotate(port, phase + dconst * DM / P * freq_term)


def rotate_portrait_np(port, phase=0.0, DM=0.0, P=None, freqs=None,
                       nu_ref=float("inf"), dconst=DCONST):
    """Host float64 rotate_portrait (numpy): the pipeline adds the header
    dispersion to the shared template once, so phases of many turns
    never enter the float32 fit."""
    port = np.asarray(port, dtype=np.float64)
    nbin = port.shape[-1]
    pFFT = np.fft.rfft(port, axis=-1)
    k = np.arange(pFFT.shape[-1])
    if P is not None and freqs is not None:
        D = dconst * DM / P
        f = np.asarray(freqs, np.float64)
        with np.errstate(divide="ignore"):
            inv2 = np.where(np.isinf(f), 0.0, f) ** -2.0
        inv2 = np.where(np.isinf(f), 0.0, inv2)
        ref2 = 0.0 if np.isinf(nu_ref) else float(nu_ref) ** -2.0
        phis = phase + D * (inv2 - ref2)
    else:
        phis = np.full(port.shape[-2], float(phase))
    ramp = np.exp(2.0j * np.pi * np.outer(phis, k))
    return np.fft.irfft(pFFT * ramp, n=nbin, axis=-1)
