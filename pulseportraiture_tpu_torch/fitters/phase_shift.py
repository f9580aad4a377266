"""FFTFIT phase-shift fit between profiles and models (Taylor 1992).

Port of pulseportraiture_tpu.fitters.phase_shift.  The objective is the
negative weighted Fourier cross-correlation

    f(phi) = -Re sum_k d_k m_k* e^{2 pi i k phi} / err**2

(reference pplib.py:1244-1280), minimized by a brute grid (the inclusive
linspace of opt.brute, pplib.py:2085) and a fixed number of clipped Newton
steps on the analytic derivatives.  Per profile these are the phase
moments of the cross-spectrum G = d conj(m): f = -C w2, f' = -Cp w2,
f'' = -Cpp w2.  The JAX package evaluates them as three passes per step;
here the cross-spectrum is written once as one merged stream [cr | ci] of
shape (rows, 2 nharm) and every Newton step is one call of
ops.moments.phase_moments_merged: the CUDA kernel on the card, its plain
twin on the CPU.  The step count is fixed, so the host never waits for the
card inside the loop.

float32: the moments take the double-single phasor (the JAX code forms
2 pi phi k directly, which loses ~1e-4 rad at k ~ 1000 in float32), and
the grid's cos/sin table is built in float64 and cast.  float64 agrees
with the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pulseportraiture_tpu_torch._device import require_f32_matmul
from pulseportraiture_tpu_torch.config import F0_FACT
from pulseportraiture_tpu_torch.ops.moments import phase_moments_merged
from pulseportraiture_tpu_torch.ops.noise import noise_PS_profiles

TWO_PI = 2.0 * math.pi


class PhaseShiftResult(NamedTuple):
    phase: torch.Tensor
    phase_err: torch.Tensor
    scale: torch.Tensor
    scale_err: torch.Tensor
    snr: torch.Tensor
    red_chi2: torch.Tensor


def _cross_spectrum(data, model, noise=None, f0_fact=F0_FACT):
    """Split-real cross spectrum (cr, ci), data power d0, model power p0,
    the Fourier noise err, and the split spectra (dr, di, mr, mi), for
    tensors (..., nbin) on one device.  DC is zeroed unless f0_fact;
    noise=None estimates it per profile from the data's power spectrum."""
    nbin = data.shape[-1]
    D = torch.fft.rfft(data, dim=-1)
    M = torch.fft.rfft(model, dim=-1)
    dr, di, mr, mi = D.real, D.imag, M.real, M.imag
    if not f0_fact:
        dr, di, mr, mi = (t.clone() for t in (dr, di, mr, mi))
        for t in (dr, di, mr, mi):
            t[..., 0] = 0.0
    if noise is None:
        noise = noise_PS_profiles(data)
    err = torch.as_tensor(noise, dtype=data.dtype,
                          device=data.device) * math.sqrt(nbin / 2.0)
    # c = dFFT * conj(mFFT)
    cr = dr * mr + di * mi
    ci = di * mr - dr * mi
    d0 = torch.sum(dr * dr + di * di, dim=-1)
    p0 = torch.sum(mr * mr + mi * mi, dim=-1)
    return cr, ci, d0, p0, err, (dr, di, mr, mi)


def merged_stream(cr, ci):
    """[cr | ci] as one contiguous (..., 2 nharm) buffer."""
    return torch.cat([cr, ci], dim=-1).contiguous()


def grid_table(grid, nharm, dtype, device):
    """cos/sin(2 pi grid k), each (Ns, nharm): built in float64 on the
    host from the Python grid values, then cast to the working dtype."""
    g64 = torch.as_tensor(grid, dtype=torch.float64)
    ang = TWO_PI * g64[:, None] * torch.arange(nharm, dtype=torch.float64)
    return (torch.cos(ang).to(dtype=dtype, device=device),
            torch.sin(ang).to(dtype=dtype, device=device))


def _fit_rows(cr, ci, d0, p0, err, lo, hi, Ns, nbin, newton_iter=6):
    """The FFTFIT core on (rows, nharm) cross-spectra."""
    dtype, dev = cr.dtype, cr.device
    nharm = cr.shape[-1]
    w2 = err ** -2.0
    d = d0 * w2
    p = p0 * w2
    g = merged_stream(cr, ci)

    # brute grid (opt.brute's inclusive linspace, pplib.py:2085)
    grid = torch.linspace(lo, hi, Ns, dtype=torch.float64)
    ct, st = grid_table(grid, nharm, dtype, dev)
    vals = -(ct @ cr.T - st @ ci.T) * w2                 # (Ns, rows)
    phase = grid.to(dtype=dtype, device=dev)[torch.argmin(vals, dim=0)]

    # Newton polish with analytic derivatives (a step only if convex)
    inf = torch.full_like(phase, math.inf)
    for _ in range(newton_iter):
        _, Cp, Cpp = phase_moments_merged(phase, g)
        h = -Cpp * w2
        step = (-Cp * w2) / torch.where(h > 0.0, h, inf)
        phase = phase - torch.clamp(step, -0.5 / Ns, 0.5 / Ns)

    C, _, Cpp = phase_moments_merged(phase, g)
    fmin = -C * w2
    scale = -fmin / p
    curvature = scale * (-Cpp * w2)
    pos = curvature > 0.0
    phase_err = torch.where(
        pos, torch.where(pos, curvature, torch.ones_like(curvature)) ** -0.5,
        inf)
    scale_err = p ** -0.5
    red_chi2 = (d - (fmin ** 2) / p) / (nbin - 2)
    snr = torch.sqrt(torch.clamp(scale ** 2 * p, min=0.0))
    return PhaseShiftResult(phase=phase, phase_err=phase_err, scale=scale,
                            scale_err=scale_err, snr=snr, red_chi2=red_chi2)


def fit_phase_shift_batch(data, model, noise=None, bounds=(-0.5, 0.5),
                          Ns=100):
    """fit_phase_shift for every row of (B, nbin) tensors (data and model
    on one device, one floating dtype); noise (B,) or None."""
    if data.dim() != 2 or model.shape != data.shape:
        raise ValueError(f"fit_phase_shift_batch: data {tuple(data.shape)} "
                         f"and model {tuple(model.shape)} must both be "
                         "(B, nbin)")
    require_f32_matmul("fit_phase_shift_batch", data.device)
    model = model.to(dtype=data.dtype, device=data.device)
    cr, ci, d0, p0, err, _ = _cross_spectrum(data, model, noise)
    return _fit_rows(cr, ci, d0, p0, err, float(bounds[0]), float(bounds[1]),
                     int(Ns), int(data.shape[-1]))


def fit_phase_shift(data, model, noise=None, bounds=(-0.5, 0.5), Ns=100):
    """Fit a phase shift (and scale) between a data and a model profile.

    The returned phase is that of the data with respect to the model; the
    rotation functions rotate to earlier phases given a positive phase.
    Reference: pplib.py:2054-2100.
    """
    data = torch.as_tensor(data)
    model = torch.as_tensor(model)
    if noise is not None:
        noise = torch.as_tensor(noise, dtype=data.dtype,
                                device=data.device).reshape(1)
    res = fit_phase_shift_batch(data[None], model[None], noise=noise,
                                bounds=bounds, Ns=Ns)
    return PhaseShiftResult(*[v[0] for v in res])
