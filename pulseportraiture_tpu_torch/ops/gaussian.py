"""Gaussian profile evaluators (time domain and analytic Fourier domain).

Port of the evaluator half of pulseportraiture_tpu.ops.gaussian, on the
host in float64 numpy (templates are evaluated once per frequency grid and
consumed on the host, as the spline evaluator is).  The Fourier evaluator
reproduces the reference's sinc-windowed Gaussian FT (pptoaslib.py:14-50),
which needs Re[erf(a + ib)]: it is evaluated as exp(-b^2) Re[erf(a + ib)]
through Weideman's rational approximation of the Faddeeva function, in a
form that cannot overflow for large b (high harmonics, narrow pulses).
The instrumental response (a channel's smearing and the extra response
widths) is applied to a template on the host as well.
"""

from __future__ import annotations

import numpy as np

from pulseportraiture_tpu_torch.ops.scattering import \
    scattering_portrait_FT_np

_FWHM = 2.0 * np.sqrt(2.0 * np.log(2.0))  # FWHM = _FWHM * sigma


def _weideman_coeffs(N=64):
    """Taylor coefficients of Weideman's (1994) rational approximation of
    the Faddeeva function w(z) in the upper half-plane."""
    M = 2 * N
    M2 = 2 * M
    k = np.arange(-M + 1, M)
    L = np.sqrt(N / np.sqrt(2.0))
    theta = k * np.pi / M
    t = L * np.tan(theta / 2.0)
    f = np.exp(-t ** 2) * (L ** 2 + t ** 2)
    f = np.concatenate([[0.0], f])
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / M2
    a = np.flipud(a[1:N + 1])
    return float(L), a


_WEIDEMAN_L, _WEIDEMAN_A = _weideman_coeffs(64)


def _wofz_upper(zr, zi):
    """Faddeeva w(z) = e^{-z^2} erfc(-iz) for Im(z) >= 0, as (Re w, Im w);
    ~1e-14 accurate over the upper half-plane."""
    L = _WEIDEMAN_L
    # iz = -zi + i zr ; L - iz = L + zi - i zr
    dr = L + zi
    di = -zr
    den = dr * dr + di * di
    # Z = (L + iz)/(L - iz)
    nr = L - zi
    ni = zr
    Zr = (nr * dr + ni * di) / den
    Zi = (ni * dr - nr * di) / den
    # Horner evaluation of the polynomial in Z with real coefficients
    pr = np.zeros_like(Zr)
    pi = np.zeros_like(Zi)
    for c in _WEIDEMAN_A:
        pr, pi = pr * Zr - pi * Zi + c, pr * Zi + pi * Zr
    # w = 2 p / (L - iz)^2 + (1/sqrt(pi)) / (L - iz)
    d2r = dr * dr - di * di
    d2i = 2.0 * dr * di
    den2 = d2r * d2r + d2i * d2i
    wr = 2.0 * (pr * d2r + pi * d2i) / den2
    wi = 2.0 * (pi * d2r - pr * d2i) / den2
    inv_sqrt_pi = 0.5641895835477563
    wr = wr + inv_sqrt_pi * dr / den
    wi = wi + inv_sqrt_pi * (-di) / den
    return wr, wi


def _exp_erf_re(a, b):
    """exp(-b^2) * Re[erf(a + i b)] for real a > 0, real b (broadcasting).

    erf(a+ib) = 1 - e^{-(a+ib)^2} w(i(a+ib)), so
    e^{-b^2} Re erf(a+ib) = e^{-b^2} - e^{-a^2} Re[e^{-2iab} w(-b + ia)]:
    free of overflow for arbitrarily large b.
    """
    a, b = np.broadcast_arrays(np.asarray(a, np.float64),
                               np.asarray(b, np.float64))
    wr, wi = _wofz_upper(-b, a)
    cos2ab = np.cos(2.0 * a * b)
    sin2ab = np.sin(2.0 * a * b)
    return np.exp(-b * b) - np.exp(-a * a) * (cos2ab * wr + sin2ab * wi)


def gaussian_function(xs, loc, wid, norm=False):
    """Gaussian with FWHM wid evaluated at xs.  Reference: pplib.py:752-768."""
    sigma = wid / _FWHM
    zs = (np.asarray(xs, np.float64) - loc) / sigma
    ys = np.exp(-0.5 * zs ** 2)
    if norm:
        ys = ys * (sigma ** 2 * 2.0 * np.pi) ** -0.5
    return ys


def gaussian_profile(nbin, loc, wid, norm=False, abs_wid=False, zeroout=True):
    """Wraparound-aware Gaussian pulse profile with peak amplitude ~1.

    As the reference (pplib.py:770-825): phase wrapped about loc, |z| < 20
    support cutoff, zero profile for wid <= 0 (if zeroout), and peak
    renormalization to exactly 1 at the profile maximum when norm=False.
    """
    loc, wid = float(loc), float(wid)
    if abs_wid:
        wid = abs(wid)
    if (wid <= 0.0) if zeroout else (wid == 0.0):
        return np.zeros(nbin)
    mean = loc % 1.0
    locval = (np.arange(nbin, dtype=np.float64) + 0.5) / nbin
    if mean < 0.5:
        locval = np.where(locval > mean + 0.5, locval - 1.0, locval)
    else:
        locval = np.where(locval < mean - 0.5, locval + 1.0, locval)
    sigma = wid / _FWHM
    zs = (locval - mean) / sigma
    vals = np.where(np.abs(zs) < 20.0,
                    np.exp(-0.5 * zs ** 2) / (sigma * np.sqrt(2 * np.pi)),
                    0.0)
    if not norm:
        imax = np.argmax(vals)
        z = (locval[imax] - loc) / sigma
        peak = vals[imax]
        fact = np.exp(-0.5 * z ** 2) / peak if peak > 0.0 else 0.0
        vals = fact * vals
    return vals


def gaussian_profile_FT(nbin, loc, wid, amp):
    """Analytic FT of a Gaussian profile at nbin//2 + 1 harmonics
    (complex128): the Fourier shift theorem plus the analytic
    Gaussian*sinc windowing convolution.  Reference: pptoaslib.py:14-50.
    """
    nharm = nbin // 2 + 1
    loc, wid, amp = float(loc), float(wid), float(amp)
    if wid <= 0.0:
        return np.zeros(nharm, dtype=np.complex128)
    sigma_t = wid / _FWHM
    amp_eff = amp * (2.0 * np.pi * sigma_t ** 2) ** 0.5
    sigma_f = 1.0 / (2.0 * np.pi * sigma_t)
    k = np.arange(nharm, dtype=np.float64)
    snc = 1.0 / np.pi  # half the distance between first sinc zero crossings
    a = sigma_f / (snc * 2.0 ** 0.5)
    b = k / (sigma_f * 2.0 ** 0.5)
    # exp(-b^2) * (erf(a - ib) + erf(a + ib)) / 2 = exp(-b^2)*Re[erf(a + ib)]
    mags = _exp_erf_re(a, b) * amp_eff * nbin
    ramp = np.exp(-2.0j * np.pi * k * loc)
    return np.nan_to_num(mags * ramp)


def gen_gaussian_profile_FT(params, nbin, applied_scattering=True):
    """FT of a DC + ngauss-Gaussian (+ optional scattering) profile.

    params as the reference (pplib.py:827-851): [dc, tau_bin,
    (loc, wid, amp) * ngauss], tau in [bin].
    """
    params = np.asarray(params, np.float64)
    ngauss = (len(params) - 2) // 3
    out = np.zeros(nbin // 2 + 1, dtype=np.complex128)
    out[0] += params[0] * nbin
    for ig in range(ngauss):
        loc, wid, amp = params[2 + 3 * ig: 5 + 3 * ig]
        out = out + gaussian_profile_FT(nbin, loc, wid, amp)
    if applied_scattering:
        out = out * scattering_portrait_FT_np(params[1] / nbin, nbin)
    return out


def instrumental_response_FT(nbin, wid=0.0, irf_type="rect"):
    """FT of the instrumental response at nbin//2 + 1 harmonics: a
    rectangle of width wid [rot] (a sinc) or a unit-area Gaussian of
    FWHM wid; ones when wid == 0.  Reference: pptoaslib.py:112-143."""
    nharm = nbin // 2 + 1
    if irf_type == "rect":
        out = np.sinc(np.arange(nharm) * wid).astype(np.complex128)
    elif irf_type == "gauss":
        gp = gaussian_profile_FT(nbin, 0.0, wid, 1.0)
        out = gp / gp[0] if wid != 0.0 else gp
    else:
        raise ValueError(f"Unrecognized instrumental response type "
                         f"{irf_type!r}")
    return np.ones(nharm, dtype=np.complex128) if wid == 0.0 else out


def instrumental_response_port_FT(nbin, freqs, DM=0.0, P=1.0, wids=(),
                                  irf_types=()):
    """The combined instrumental response (nchan, nharm), complex128: the
    product of the responses of wids/irf_types and, when DM != 0, each
    channel's dispersive smearing, a rectangle 8.3e-6 chan_bw /
    (nu/1e3)^3 / P wide.  Reference: pptoaslib.py:145-179."""
    freqs = np.asarray(freqs, np.float64)
    nharm = nbin // 2 + 1
    out = np.ones((len(freqs), nharm), dtype=np.complex128)
    for wid, irf_type in zip(wids, irf_types):
        out = out * instrumental_response_FT(nbin, wid, irf_type)[None, :]
    if DM:
        chan_bw = abs(freqs[1] - freqs[0])
        smear_wids = 8.3e-6 * chan_bw / (freqs / 1e3) ** 3 / P
        out = out * np.sinc(np.arange(nharm)[None, :] * smear_wids[:, None])
    return out
