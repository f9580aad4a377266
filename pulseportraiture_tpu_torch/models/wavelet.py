"""Stationary (undecimated) wavelet transform denoising.

Port of pulseportraiture_tpu.models.wavelet (the reference's PyWavelets
smoothing, pplib.py:1621-1761): per-profile SWT with Daubechies filters,
universal thresholding, and smart_smooth's search over (level, factor)
for the best Fourier S/N.

The SWT is the a-trous algorithm: at level j the analysis filters are
upsampled by 2**j and applied as circular correlations, a sum of rolls
taken in the filters' tap order (the JAX package's order, so float64 sums
round alike).  The inverse is the exact two-channel identity
    a_j = (conv(a_{j+1}, h~) + conv(d_{j+1}, g~)) / 2.
The Daubechies filters come from a spectral factorization on the host.
Everything runs on the tensors' device, batched over profiles; the
median of the thresholds is numpy's (the mean of the two middle values),
not torch.median's lower middle value.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from pulseportraiture_tpu_torch._device import as_tensor
from pulseportraiture_tpu_torch.ops.noise import noise_PS_profiles


@functools.lru_cache(maxsize=None)
def daubechies_dec_lo(N: int) -> tuple:
    """Daubechies-N (2N taps) decomposition low-pass filter.

    Spectral factorization: the roots of P(y) = sum_k C(N-1+k, k) y^k,
    y = (2 - z - 1/z)/4, inside the unit circle give the minimum-phase
    factor of the half-band filter.
    """
    binom = [float(math.comb(N - 1 + k, k)) for k in range(N)]
    y_num = np.array([-0.25, 0.5, -0.25])
    q = np.zeros(2 * N - 1)
    q[N - 1] = binom[0]
    ypow = np.array([1.0])
    for k in range(1, N):
        ypow = np.convolve(ypow, y_num)
        coeff = binom[k] * ypow
        lo = N - 1 - k
        q[lo:lo + len(coeff)] += coeff
    roots = np.roots(q[::-1])
    b = np.array([1.0 + 0j])
    for r in roots[np.abs(roots) < 1.0]:
        b = np.convolve(b, np.array([1.0, -r]))
    h = np.real(b)
    for _ in range(N):
        h = np.convolve(h, [1.0, 1.0])
    h = h * (np.sqrt(2.0) / h.sum())
    return tuple(float(v) for v in h)


def _filters(wavelet: str):
    """(dec_lo, dec_hi) of a 'dbN' wavelet; dec_hi is the QMF
    g[n] = (-1)^n h[L-1-n]."""
    if not wavelet.startswith("db"):
        raise ValueError(f"Only Daubechies wavelets supported, got {wavelet!r}")
    dec_lo = np.asarray(daubechies_dec_lo(int(wavelet[2:])))
    L = len(dec_lo)
    dec_hi = np.array([(-1) ** n * dec_lo[L - 1 - n] for n in range(L)])
    return dec_lo, dec_hi


def _circ(x, taps, step):
    """sum_k taps[k] * roll(x, step*k) along the last axis, in tap order
    (step < 0: correlation, step > 0: convolution)."""
    out = torch.zeros_like(x)
    for k, t in enumerate(taps):
        out = out + float(t) * torch.roll(x, step * k, dims=-1)
    return out


def swt(x, wavelet="db8", level=5):
    """Stationary wavelet transform along the last axis of a tensor.

    Returns (approxs, details), each (level, ..., nbin), index 0 the
    deepest level (pywt.swt's order).
    """
    dec_lo, dec_hi = _filters(wavelet)
    a = x
    approxs, details = [], []
    for j in range(level):
        step = 2 ** j
        d = _circ(a, dec_hi, -step)
        a = _circ(a, dec_lo, -step)
        approxs.append(a)
        details.append(d)
    return torch.stack(approxs[::-1]), torch.stack(details[::-1])


def iswt(approxs, details, wavelet="db8"):
    """Inverse SWT (exact for swt's a-trous analysis)."""
    dec_lo, dec_hi = _filters(wavelet)
    level = approxs.shape[0]
    a = approxs[0]
    for i in range(level):
        step = 2 ** (level - 1 - i)
        a = 0.5 * (_circ(a, dec_lo, step) + _circ(details[i], dec_hi, step))
    return a


def _threshold(c, value, mode="hard"):
    if mode == "hard":
        return torch.where(torch.abs(c) >= value, c, torch.zeros_like(c))
    if mode == "soft":
        return torch.sign(c) * torch.clamp(torch.abs(c) - value, min=0.0)
    raise ValueError(f"Unknown threshold mode {mode!r}")


def _median(x):
    """numpy's median along the last axis: the middle value, or the mean
    of the two middle values of an even length."""
    s = torch.sort(x, dim=-1).values
    n = s.shape[-1]
    if n % 2:
        return s[..., n // 2]
    return (s[..., n // 2 - 1] + s[..., n // 2]) * 0.5


def _deepest_median(approxs, details):
    """median(|deepest (cA, cD)|)/0.6745, per profile."""
    deepest = torch.cat([approxs[0], details[0]], dim=-1)
    return _median(torch.abs(deepest)) / 0.6745


def wavelet_smooth(port, wavelet="db8", nlevel=5, threshtype="hard",
                   fact=1.0, device=None):
    """Wavelet-denoise a profile or portrait (last axis = phase), on its
    device (host data: `device`, the card by default).

    Threshold = fact * (median|deepest coeffs|/0.6745) * sqrt(2 ln nbin),
    per profile, applied to all coefficients including the approximations
    (pplib.py:1621-1666).
    """
    port = as_tensor(port, device)
    approxs, details = swt(port, wavelet, nlevel)
    t = (fact * _deepest_median(approxs, details) *
         math.sqrt(2.0 * math.log(port.shape[-1])))[None, ..., None]
    return iswt(_threshold(approxs, t, threshtype),
                _threshold(details, t, threshtype), wavelet)


def _snr_objective_batch(smooth, profs, rchi2_tol):
    """Fourier S/N of each smoothed profile (C, nbin), 0 where the reduced
    chi2 of the data against it is further than rchi2_tol from 1
    (pplib.py:1737-1761)."""
    nbin = profs.shape[-1]
    S = torch.fft.rfft(smooth, dim=-1)
    signal = torch.sum(S.real[..., 1:] ** 2 + S.imag[..., 1:] ** 2, dim=-1)
    noise = noise_PS_profiles(smooth) * math.sqrt(nbin / 2.0)
    pos = noise > 0.0
    snr = torch.where(pos, signal / torch.where(pos, noise,
                                                torch.ones_like(noise)),
                      torch.where(signal > 0.0,
                                  torch.full_like(signal, math.inf),
                                  torch.zeros_like(signal)))
    resid_err = noise_PS_profiles(profs)
    safe = torch.where(resid_err > 0.0, resid_err,
                       torch.ones_like(resid_err))
    red_chi2 = torch.sum(((profs - smooth) / safe[..., None]) ** 2,
                         dim=-1) / nbin
    return torch.where(torch.abs(red_chi2 - 1.0) > rchi2_tol,
                       torch.zeros_like(snr), snr)


def _best_smooth_for_level(profs, nlevel, wavelet, threshtype, nfact,
                           rchi2_tol):
    """Best (snr, smooth) over the threshold grid linspace(0, 3, nfact) at
    one level, for a (C, nbin) stack; the first maximum wins."""
    approxs, details = swt(profs, wavelet, nlevel)
    base = _deepest_median(approxs, details) * \
        math.sqrt(2.0 * math.log(profs.shape[-1]))
    facts = torch.linspace(0.0, 3.0, nfact, dtype=torch.float64).to(
        dtype=profs.dtype, device=profs.device)
    best_snr = torch.full(profs.shape[:1], -math.inf, dtype=profs.dtype,
                          device=profs.device)
    best_sm = torch.zeros_like(profs)
    for i in range(nfact):
        t = (facts[i] * base)[None, :, None]
        sm = iswt(_threshold(approxs, t, threshtype),
                  _threshold(details, t, threshtype), wavelet)
        snr = _snr_objective_batch(sm, profs, rchi2_tol)
        better = snr > best_snr
        best_snr = torch.where(better, snr, best_snr)
        best_sm = torch.where(better[:, None], sm, best_sm)
    return best_snr, best_sm


def smart_smooth(port, try_nlevels=None, rchi2_tol=0.1, wavelet="db8",
                 threshtype="hard", nfact=30, chan_chunk=None, device=None):
    """Automated wavelet smoothing: the largest Fourier S/N over levels
    1..try_nlevels and threshold factors in [0, 3] (pplib.py:1668-1735),
    batched over the profiles of port (nbin,) or (nchan, nbin), on its
    device (host data: `device`, the card by default).  A profile whose
    best S/N is not positive comes back zeroed; odd nbin, or
    try_nlevels == 0, returns port unchanged.

    chan_chunk bounds the profiles smoothed at once (default: 2**23
    samples a chunk); the result does not depend on it.
    """
    port = as_tensor(port, device)
    one_prof = port.dim() == 1
    port2 = port[None] if one_prof else port
    nchan, nbin = port2.shape
    if try_nlevels == 0 or nbin % 2 != 0:
        return port
    if math.log2(nbin) != int(math.log2(nbin)):
        try_nlevels = 1
    elif try_nlevels is None:
        try_nlevels = int(math.log2(nbin))
    if chan_chunk is None:
        chan_chunk = max(1, (1 << 23) // nbin)
    rtol = torch.as_tensor(rchi2_tol, dtype=port2.dtype, device=port2.device)
    out = torch.empty_like(port2)
    for lo in range(0, nchan, chan_chunk):
        profs = port2[lo:lo + chan_chunk]
        best_snr = torch.full(profs.shape[:1], -math.inf, dtype=profs.dtype,
                              device=profs.device)
        best_sm = torch.zeros_like(profs)
        for ilevel in range(try_nlevels):
            snr_l, sm_l = _best_smooth_for_level(profs, ilevel + 1, wavelet,
                                                 threshtype, nfact, rtol)
            better = snr_l > best_snr      # strict: the first level wins ties
            best_snr = torch.where(better, snr_l, best_snr)
            best_sm = torch.where(better[:, None], sm_l, best_sm)
        out[lo:lo + chan_chunk] = torch.where((best_snr > 0.0)[:, None],
                                              best_sm,
                                              torch.zeros_like(best_sm))
    return out[0] if one_prof else out
