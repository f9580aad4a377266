"""Off-pulse noise and SNR estimators.

Port of pulseportraiture_tpu.ops.noise: get_noise_PS, get_SNR and the
'fit' estimator (get_noise_fit, _find_kc) on the host in numpy, as the
JAX package computes concrete inputs; noise_PS_profiles is the
per-profile estimate on tensors, for the fitters that are given no
noise, and get_red_chi2 runs on tensors.  Reference: pplib.py:727-750,
1448-1495, 2206-2308.
"""

from __future__ import annotations

import numpy as np
import torch

from pulseportraiture_tpu_torch._device import as_tensor
from pulseportraiture_tpu_torch.config import SNR_FUDGE


def _float_dtype(dt):
    return dt is not None and np.issubdtype(dt, np.floating)


def get_noise_PS(data, frac=4, chans=False):
    """Noise from the mean of the highest 1/frac of the power spectrum.

    chans=True: per-profile noise along the leading axes; else a scalar
    over the raveled data.  float32 input stays float32.
    """
    d = np.asarray(data)
    if d.dtype not in (np.float32, np.float64):
        d = d.astype(np.float64)
    if chans:
        n = d.shape[-1]
        FFT = np.fft.rfft(d, axis=-1)
        kc = int((1 - 1.0 / frac) * FFT.shape[-1])
        t = FFT[..., kc:]
        out = np.sqrt(np.mean((t.real ** 2 + t.imag ** 2) / n, axis=-1))
    else:
        raveld = d.ravel()
        n = raveld.shape[0]
        FFT = np.fft.rfft(raveld)
        kc = int((1 - 1.0 / frac) * FFT.shape[0])
        t = FFT[kc:]
        out = np.sqrt(np.mean((t.real ** 2 + t.imag ** 2) / n))
    dt = getattr(data, "dtype", None)
    if _float_dtype(dt):
        out = np.asarray(out, dtype=dt)
    return out


def noise_PS_profiles(data, frac=4):
    """get_noise_PS(chans=True) on a tensor (..., nbin), on its device:
    per-profile noise from the highest 1/frac of each power spectrum."""
    n = data.shape[-1]
    FFT = torch.fft.rfft(data, dim=-1)
    kc = int((1 - 1.0 / frac) * FFT.shape[-1])
    t = FFT[..., kc:]
    return torch.sqrt(torch.mean((t.real ** 2 + t.imag ** 2) / n, dim=-1))


def get_SNR(prof, fudge=SNR_FUDGE, noise=None):
    """Equivalent-width SNR estimate (baseline assumed removed).

    noise: optional precomputed global noise scalar (load_data passes the
    RMS of its per-channel estimates)."""
    p = np.asarray(prof)
    if p.dtype not in (np.float32, np.float64):
        p = p.astype(np.float64)
    if noise is None:
        noise = np.asarray(get_noise_PS(p))
    Weq = p.sum(-1) / p.max(-1)
    mask = np.where(Weq <= 0.0, 0.0, 1.0)
    Weq = np.where(Weq <= 0.0, 1.0, Weq)
    SNR = p.sum(-1) / (noise * Weq ** 0.5)
    out = SNR * mask / fudge
    dt = getattr(prof, "dtype", None)
    if _float_dtype(dt):
        out = np.asarray(out, dtype=dt)
    return out


def get_noise_fit(data, fact=1.1, chans=False):
    """Noise above a cutoff harmonic found by fitting the log power
    spectrum (host numpy; a diagnostic).  Reference: pplib.py:2255-2287."""
    data = np.asarray(data)

    def one(prof):
        FFT = np.fft.rfft(prof)
        pows = np.real(FFT * np.conj(FFT)) / len(prof)
        k_crit = fact * _find_kc(pows)
        k_crit = min(int(0.99 * len(pows)), int(k_crit))
        return np.sqrt(np.mean(pows[int(k_crit):]))

    if chans:
        return np.array([one(prof) for prof in data])
    return one(data.ravel())


def _find_kc(pows, fn="exp_dc"):
    """Cutoff index from a brute-grid fit of a decaying exponential to the
    log power spectrum.  Reference: pplib.py:1448-1495."""
    data = np.log10(pows)
    N = len(data)
    a_grid = np.linspace(1.0 / N, 1.0, 20)
    b_grid = np.linspace(0.0, data.max() - data.min(), 20)
    dc_grid = np.linspace(data.min(), data.max(), 20)
    ii = np.arange(N)
    # chi2 over the whole (a, b, dc) grid at once; the first minimum in
    # (a, b, dc) order, as the reference's nested loops find it
    e = np.exp(-np.outer(a_grid, ii))                      # (20, N)
    model = b_grid[None, :, None, None] * e[:, None, None, :] + \
        dc_grid[None, None, :, None]                       # (20, 20, 20, N)
    chi2 = np.sum((data - model) ** 2, axis=-1)
    a = a_grid[np.unravel_index(np.argmin(chi2), chi2.shape)[0]]
    idx = np.where(np.exp(-a * ii) < 0.005)[0]
    return idx.min() if len(idx) else N - 1


def get_noise(data, method="PS", **kwargs):
    """Noise by 'PS' (get_noise_PS) or 'fit' (get_noise_fit).  Reference:
    pplib.py:2206-2225."""
    if method == "PS":
        return get_noise_PS(data, **kwargs)
    if method == "fit":
        return get_noise_fit(data, **kwargs)
    raise ValueError(f"Unknown get_noise method {method!r}")


def get_red_chi2(data, model, errs=None, dof=None, device=None):
    """Reduced chi2 of a profile (nbin,) or portrait (nchan, nbin) against
    a model, on the data's device (host data: `device`, the card by
    default); errs defaults to the PS noise, per channel for a portrait,
    dof to the sum of the data's dimensions.  Reference: pplib.py:727-750.
    """
    data = as_tensor(data, device)
    model = as_tensor(model, data.device, data.dtype)
    resids = data - model
    if errs is None:
        errs = noise_PS_profiles(data) if data.dim() == 2 else \
            noise_PS_profiles(data.reshape(1, -1))[0]
    errs = as_tensor(errs, data.device, data.dtype)
    if dof is None:
        dof = sum(data.shape)
    if data.dim() == 1:
        return torch.sum((resids / errs) ** 2) / dof
    return torch.sum((resids / errs[:, None]) ** 2) / dof
