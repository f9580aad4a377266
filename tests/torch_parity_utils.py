"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*).

Inputs are made once with numpy from a seed and handed to both packages:
the JAX package (float64 under tests/conftest.py's x64) and the port.
"""

import numpy as np
import torch

from pulseportraiture_tpu_torch.config import DCONST


def rel_err(got, want):
    """max |got - want| / max |want| (numpy or torch inputs)."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else \
        np.asarray(got)
    want = want.detach().cpu().numpy() if torch.is_tensor(want) else \
        np.asarray(want)
    scale = np.max(np.abs(want))
    return float(np.max(np.abs(got - want)) / (scale if scale else 1.0))


def mjd_diff_s(a, b):
    """a - b [s] for split-precision MJDs of either package."""
    return (a.days - b.days) * 86400.0 + (a.secs - b.secs) + \
        (a.frac - b.frac)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def template(nchan, nbin, freqs=None):
    """bench.py's two-component template (nchan, nbin), float64."""
    if freqs is None:
        freqs = np.linspace(1100.0, 1900.0, nchan)
    x = (np.arange(nbin) + 0.5) / nbin
    prof = np.exp(-0.5 * ((x - 0.4) / 0.02) ** 2) + \
        0.4 * np.exp(-0.5 * ((x - 0.47) / 0.01) ** 2)
    return prof[None, :] * (freqs[:, None] / 1500.0) ** -1.5


def injected_batch(B=3, nchan=32, nbin=256, P=0.003, noise=0.1, seed=0,
                   tau=0.0, alpha=-4.0):
    """bench.py's data recipe at a small size: per-item injected (phi,
    DM) shifts of a shared template plus white noise; with tau > 0 the
    data are also scattered by tau (nu/nu_fit)^alpha [rot] (the template
    is not).  Returns a dict."""
    rng = np.random.default_rng(seed)
    freqs = np.linspace(1100.0, 1900.0, nchan)
    model = template(nchan, nbin, freqs)
    phis = rng.uniform(-0.01, 0.01, B)
    dms = rng.uniform(-2e-4, 2e-4, B)
    nu_fit = freqs.mean()
    k = 2j * np.pi * np.arange(nbin // 2 + 1)
    mft = np.fft.rfft(model, axis=-1)
    if tau:
        taus = tau * (freqs / nu_fit) ** alpha
        mft = mft / (1.0 + k * taus[:, None])     # B = 1/(1 + 2 pi i k tau)
    data = np.empty((B, nchan, nbin))
    for i in range(B):
        shift = phis[i] + DCONST * dms[i] / P * (freqs ** -2 - nu_fit ** -2)
        data[i] = np.fft.irfft(mft * np.exp(-k * shift[:, None]), n=nbin,
                               axis=-1)
    data += rng.normal(0.0, noise, data.shape)
    return dict(model=model, data=data, phis=phis, dms=dms, freqs=freqs,
                P=P, noise=noise, nu_fit=nu_fit, tau=tau, alpha=alpha,
                errs=np.full((B, nchan), noise),
                nu_fits=np.full((B, 3), nu_fit))


def unpermute(a, kvec):
    """CT-permuted harmonic axis (..., NH) -> natural order."""
    return np.asarray(a)[..., np.argsort(np.asarray(kvec))]
