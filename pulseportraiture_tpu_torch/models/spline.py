"""Spline template evaluation on the host (numpy).

Port of pulseportraiture_tpu.models.spline.splev_np and
gen_spline_portrait_np: the template is consumed on the host (its f64
spectrum and base rotation are computed there), so no device code is
involved.  Reference: pplib.py:932-956.
"""

from __future__ import annotations

import numpy as np


def splev_np(x, tck):
    """Parametric splev by de Boor's recursion: values (ndim, npts).

    Outside the knot span the interval index clamps to the edge span and
    the local polynomial extends (splev's ext=0 extrapolation).
    """
    t, c, k = tck
    t = np.asarray(t, dtype=float)
    c = np.atleast_2d(np.asarray(c, dtype=float))
    x = np.atleast_1d(np.asarray(x, dtype=float))
    k = int(k)
    n = len(t) - k - 1
    i = np.clip(np.searchsorted(t, x, side="right") - 1, k, n - 1)
    idx = i[:, None] - k + np.arange(k + 1)[None, :]   # (npts, k+1)
    d = np.ascontiguousarray(c[:, idx])                # (ndim, npts, k+1)
    for r in range(1, k + 1):
        for j in range(k, r - 1, -1):
            denom = t[idx[:, j] + k - r + 1] - t[idx[:, j]]
            alpha = np.where(denom > 0,
                             (x - t[idx[:, j]]) /
                             np.where(denom > 0, denom, 1.0), 0.0)
            d[:, :, j] = (1.0 - alpha) * d[:, :, j - 1] + \
                alpha * d[:, :, j]
    return d[:, :, k]


def gen_spline_portrait_np(mean_prof, freqs, eigvec, tck, nbin=None):
    """Template portrait (nfreq, nbin) from a spline model: splev ->
    project onto the eigenprofiles -> + mean profile, resampled (with the
    half-bin shift correction) when nbin differs."""
    mean_prof = np.asarray(mean_prof, dtype=float)
    freqs = np.atleast_1d(np.asarray(freqs, dtype=float))
    eigvec = np.asarray(eigvec, dtype=float)
    if eigvec.shape[1] == 0:
        port = np.tile(mean_prof, (freqs.shape[0], 1))
    else:
        proj = splev_np(freqs, tck).T        # (nfreq, ncomp)
        port = proj @ eigvec.T + mean_prof
    if nbin is not None and mean_prof.shape[-1] != nbin:
        from scipy.signal import resample

        from pulseportraiture_tpu_torch.ops.rotate import rotate_portrait_np
        old_nbin = mean_prof.shape[-1]
        port = resample(port, nbin, axis=-1)
        shift = 0.5 * (1.0 / nbin - 1.0 / old_nbin)
        port = rotate_portrait_np(port, shift)
    return port
