"""PCA + B-spline portrait models (the ppspline model family).

Port of pulseportraiture_tpu.models.spline (reference pplib.py:932-956,
1497-1619, ppspline.py:143-155).  The builder: pca (the weighted
covariance as a float64 matmul on the portrait's device, torch.linalg.eigh),
find_significant_eigvec (smart_smooth on the device, the S/N decisions on
the host), and fit_parametric_spline, FITPACK-style knot insertion plus a
ridge bisection onto the smoothing target s: a least-squares problem of
nchan x (a few tens of coefficients), solved on the host in float64 as
the JAX package solves it.  Evaluation: splev_np on the host, the
portrait by gen_spline_portrait on tensors (the pipeline calls it with
device="cpu").
"""

from __future__ import annotations

import numpy as np
import torch

from pulseportraiture_tpu_torch._device import as_tensor


def pca(port, mean_prof=None, weights=None, quiet=True, device=None):
    """Weighted principal components of port (nchan, nbin), on its device
    (host data: `device`, the card by default), in its float type.

    Returns (eigval, eigvec), eigenvalues descending, eigvec's columns
    the components: np.cov(delta_port.T, aweights=weights, ddof=1) then
    eigh (pplib.py:1497-1534).  Eigenvector signs are the solver's.
    """
    port = as_tensor(port, device)
    dt, dev = port.dtype, port.device
    weights = torch.ones(port.shape[0], dtype=dt, device=dev) \
        if weights is None else as_tensor(weights, dev, dt)
    if mean_prof is None:
        mean_prof = (port * weights[:, None]).sum(0) / weights.sum()
    delta = port - as_tensor(mean_prof, dev, dt)
    # np.cov with aweights w and ddof=1: C = X^T W X / (V1 - V2/V1), X
    # centred on its weighted mean, V1 = sum w, V2 = sum w^2
    X = delta - (delta * weights[:, None]).sum(0) / weights.sum()
    V1 = weights.sum()
    V2 = (weights ** 2).sum()
    cov = (X.T * weights) @ X / (V1 - V2 / V1)
    eigval, eigvec = torch.linalg.eigh(cov)
    return eigval.flip(0), eigvec.flip(1)


def reconstruct_portrait(port, mean_prof, eigvec, device=None):
    """Project port into the eigvec basis and reconstruct, on port's
    device.  Reference: pplib.py:1536-1553."""
    port = as_tensor(port, device)
    mean_prof = as_tensor(mean_prof, port.device, port.dtype)
    eigvec = as_tensor(eigvec, port.device, port.dtype)
    return ((port - mean_prof) @ eigvec) @ eigvec.T + mean_prof


def find_significant_eigvec(eigvec, check_max=10, return_max=10,
                            snr_cutoff=150.0, check_crossings=True,
                            check_acorr=True, return_smooth=True,
                            evs_all=None, device=None, **kwargs):
    """Indices of significant eigenvectors by smoothing + Fourier S/N
    (pplib.py:1555-1619).

    The first max(check_max, return_max) columns of eigvec are smoothed
    by one smart_smooth call on the device (kwargs go to it), unless
    evs_all gives them already smoothed; the decisions are made on the
    host.  Returns ieig (numpy ints) and, with return_smooth, the
    smoothed eigenvectors (nbin, ncomp) as a float64 numpy array, zero
    where not significant.
    """
    from pulseportraiture_tpu_torch.models.wavelet import smart_smooth
    from pulseportraiture_tpu_torch.ops.noise import get_noise_PS
    from pulseportraiture_tpu_torch.utils import count_crossings
    ev_t = as_tensor(eigvec, device)
    eigvec = ev_t.detach().cpu().numpy().astype(np.float64)
    nvec = max(check_max, return_max)
    if evs_all is None:
        evs_all = smart_smooth(ev_t.T[:nvec].contiguous(), **kwargs)
    evs_all = (evs_all.detach().cpu().numpy() if torch.is_tensor(evs_all)
               else np.asarray(evs_all))[:nvec].astype(np.float64)
    noises_all = np.asarray(get_noise_PS(eigvec.T[:nvec], chans=True)) * \
        np.sqrt(eigvec.shape[0] / 2.0)
    smooth_eigvec = np.zeros(eigvec.shape)
    ieig = []
    for ivec in range(nvec):
        add = False
        ev = evs_all[ivec]
        ev_noise = float(noises_all[ivec])
        ev_snr = np.sum(np.abs(np.fft.rfft(ev)[1:]) ** 2) / ev_noise \
            if ev_noise > 0 else 0.0
        if ev_snr >= snr_cutoff:
            if check_crossings and ev_snr < 3 * snr_cutoff:
                ncross = count_crossings(np.abs(ev), 0.1 * np.abs(ev).max())
                if ncross < int(0.02 * len(ev)):
                    add = True
            # `and add` makes this branch unreachable, as the reference's
            # own acorr filter is (pplib.py:1598); kept bug for bug
            # (PARITY.md)
            elif check_acorr and ev_snr < 3 * snr_cutoff and add:
                acorr = np.correlate(ev, ev, "same")
                fwhm = acorr.argmax() - \
                    np.where(acorr > acorr.max() / 2.0)[0].min()
                add = fwhm > 5
            else:
                add = True
        if add:
            ieig.append(ivec)
            if return_smooth:
                smooth_eigvec[:, ivec] = ev
        if ivec + 1 == check_max or len(ieig) == return_max:
            break
    ieig = np.array(ieig, dtype=int)
    if return_smooth:
        return ieig, smooth_eigvec
    return ieig


# ----------------------------------------------------------------------
# B-spline fitting (host) and evaluation
# ----------------------------------------------------------------------

def _bspline_basis(x, t, k):
    """All B-spline basis values (len(x), nbasis) at x for knots t, degree
    k (Cox-de Boor; zero outside the knot span)."""
    x = np.asarray(x, dtype=float)
    t = np.asarray(t, dtype=float)
    n = len(t) - k - 1
    B = np.zeros((len(x), n))
    for j in range(n):
        B[:, j] = _deboor_one(x, t, k, j)
    return B


def _deboor_one(x, t, k, j):
    """Basis function B_{j,k} at x (recursive)."""
    if k == 0:
        # half-open [t_j, t_{j+1}); x == t_max belongs to the last
        # non-degenerate interval of the clamped knot vector
        in_interval = (x >= t[j]) & (x < t[j + 1])
        at_end = (x == t[-1]) & (t[j] < t[j + 1]) & (t[j + 1] == t[-1])
        return (in_interval | at_end).astype(float)
    out = np.zeros_like(x, dtype=float)
    d1 = t[j + k] - t[j]
    if d1 > 0:
        out += (x - t[j]) / d1 * _deboor_one(x, t, k - 1, j)
    d2 = t[j + k + 1] - t[j + 1]
    if d2 > 0:
        out += (t[j + k + 1] - x) / d2 * _deboor_one(x, t, k - 1, j + 1)
    return out


def fit_parametric_spline(u, points, weights=None, k=3, s=None,
                          max_nbreak=None, nbreak_step=2, maxiter=30):
    """Weighted smoothing parametric spline through points(u), in the
    manner of scipy's splprep (ppspline.py:143-155).

    Least-squares B-spline fits with interior knots inserted nbreak_step
    at a time (at quantiles of u) until the weighted residual sum of
    squares fp <= s; when that overshoots, a second-difference ridge
    penalty is bisected so fp lands on s.  u (npts,) increasing; points
    (ndim, npts); weights (npts,); s defaults to npts - sqrt(2 npts).
    Returns ((t, c, k), fp), c (ndim, ncoef), as float64 numpy.
    """
    u = np.asarray(u, dtype=float)
    points = np.atleast_2d(np.asarray(points, dtype=float))
    ndim, npts = points.shape
    weights = np.ones(npts) if weights is None else \
        np.asarray(weights, dtype=float)
    if s is None:
        s = npts - np.sqrt(2.0 * npts)
    k = int(k)

    def knots_with_interior(interior):
        return np.concatenate([np.full(k + 1, u[0]), interior,
                               np.full(k + 1, u[-1])])

    def fit(t, lam=None):
        """Weighted LSQ (B^T W^2 B [+ lam D^T D]) c = B^T W^2 y per
        dimension; D the second differences of the coefficients."""
        B = _bspline_basis(u, t, k)
        Bw = B * weights[:, None]
        A = Bw.T @ Bw
        if lam is not None:
            D = np.diff(np.eye(B.shape[1]), n=2, axis=0)
            A = A + lam * (D.T @ D)
        coefs = np.zeros((ndim, B.shape[1]))
        for d in range(ndim):
            rhs = Bw.T @ (weights * points[d])
            coefs[d] = np.linalg.lstsq(A, rhs, rcond=None)[0]
        resid = points - coefs @ B.T
        return coefs, float((weights ** 2 * (resid ** 2).sum(0)).sum())

    interior = np.array([])
    t = knots_with_interior(interior)
    coefs, fp = fit(t)
    it = 0
    while fp > s and it < maxiter:
        it += 1
        n_int = len(interior) + nbreak_step
        if max_nbreak is not None and n_int > max_nbreak:
            break
        if n_int > npts - k - 1:
            break
        interior = np.quantile(u, np.linspace(0, 1, n_int + 2)[1:-1])
        t = knots_with_interior(interior)
        coefs, fp = fit(t)

    if fp < s and len(interior):
        # knot insertion overshot the target: bisect the ridge penalty so
        # the residual lands on s, as FITPACK solves for its smoothing
        # parameter
        lo, hi = 0.0, 1.0
        _, fp_hi = fit(t, hi)
        grow = 0
        while fp_hi < s and grow < 60:
            hi *= 4.0
            _, fp_hi = fit(t, hi)
            grow += 1
        if fp_hi >= s:
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                _, fp_mid = fit(t, mid)
                if fp_mid < s:
                    lo = mid
                else:
                    hi = mid
            coefs, fp = fit(t, lo)
    return (t, coefs, k), fp


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


def gen_spline_portrait(mean_prof, freqs, eigvec, tck, nbin=None,
                        device=None):
    """Template portrait (nfreq, nbin) from a spline model: splev ->
    project onto the eigenprofiles -> + mean profile, Fourier-resampled
    (with the half-bin shift correction) when nbin differs.  The spline
    is evaluated on the host (nfreq x ncomp values), the projection and
    the resample run on mean_prof's device (host data: `device`, the card
    by default).  Reference: pplib.py:932-956."""
    from pulseportraiture_tpu_torch.ops.rotate import rotate_portrait
    mean_prof = as_tensor(mean_prof, device)
    dt, dev = mean_prof.dtype, mean_prof.device
    nfreq = np.atleast_1d(np.asarray(freqs)).shape[0]
    eigvec = as_tensor(eigvec, dev, dt)
    if eigvec.shape[1] == 0:
        port = mean_prof.expand(nfreq, -1).clone()
    else:
        proj = as_tensor(splev_np(freqs, tck).T, dev, dt)
        port = proj @ eigvec.T + mean_prof
    if nbin is not None and mean_prof.shape[-1] != nbin:
        old_nbin = mean_prof.shape[-1]
        port = _fourier_resample(port, nbin)
        port = rotate_portrait(port, 0.5 * (1.0 / nbin - 1.0 / old_nbin))
    return port


def _fourier_resample(port, nbin):
    """scipy.signal.resample along the last axis of a tensor (Fourier
    zero-pad or truncate, scipy's Nyquist handling)."""
    old = port.shape[-1]
    F = torch.fft.rfft(port, dim=-1)
    nharm_new = nbin // 2 + 1
    if nharm_new <= F.shape[-1]:
        Fn = F[..., :nharm_new].clone()
        # scipy folds the conjugate half onto the new Nyquist bin when
        # downsampling to an even length: Y[N/2] = 2 Re(X[N/2])
        if nbin % 2 == 0 and nharm_new < F.shape[-1]:
            Fn[..., -1] = 2.0 * Fn[..., -1].real
    else:
        Fn = torch.cat([F, F.new_zeros(F.shape[:-1] +
                                       (nharm_new - F.shape[-1],))], dim=-1)
        if old % 2 == 0:
            # split the old Nyquist bin when upsampling from even length
            Fn[..., old // 2] = Fn[..., old // 2] * 0.5
    return torch.fft.irfft(Fn, n=nbin, dim=-1) * (nbin / old)
