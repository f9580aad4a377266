"""Host float64 portrait rotation (port of ops.rotate.rotate_portrait_np).

The pipeline adds the header dispersion to the shared template once, on
the host in float64, so phases of many turns never enter the f32 fit.
"""

from __future__ import annotations

import numpy as np

from pulseportraiture_tpu_torch.config import DCONST


def rotate_portrait_np(port, phase=0.0, DM=0.0, P=None, freqs=None,
                       nu_ref=float("inf"), dconst=DCONST):
    """Rotate a (nchan, nbin) portrait by phase + dispersive delay [rot]
    (positive values rotate to earlier phase)."""
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
