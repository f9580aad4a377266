"""Off-pulse noise and SNR estimators.

Port of the concrete-input branch of pulseportraiture_tpu.ops.noise
(get_noise_PS, get_SNR), host numpy at load time; noise_PS_profiles is
the per-profile estimate on tensors, for the narrowband fitters that are
given no noise.  Reference: pplib.py:2227-2308.
"""

from __future__ import annotations

import numpy as np
import torch

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
