"""Narrowband shift estimators in the style of PSRCHIVE's ArrivalTime.

Port of pulseportraiture_tpu.fitters.arrival_time (the reference shells
into PSRCHIVE's `pat -A <code>`, pptoas.py:1133-1206).  Every algorithm is
a distinct measurement, batched over channels:

  PGS  Phase Gradient Shift: weighted Fourier-domain FFTFIT; shift from
       the Newton-polished cross-spectrum maximum, error from the
       analytic curvature.
  FDM  Fourier Domain "Monte-Carlo": the PGS shift, with the error the
       standard deviation of the scale-marginalized posterior
       p(phi) ~ exp(-chi2(phi)/2) by quadrature on a grid around the
       maximum.
  SIS  Sinc Interpolation Shift: unweighted band-limited circular CCF
       peak by grid + Newton; the caller's noise is ignored, the error
       propagates a noise level self-estimated from the data spectrum.
  PIS  Parabolic Interpolation Shift: discrete circular CCF at native
       resolution, 3-point parabola through the peak.
  GIS  Gaussian Interpolation Shift: 3-point parabola on ln CCF.
  COF  Center Of Flux: first-harmonic phase of data minus model.

The band-limited CCF and its two derivatives are, per channel, the phase
moments (C, Cp, Cpp) of the cross-spectrum: _ccf_max writes it once as a
merged stream [cr | ci] and each of its 8 Newton steps, and the final
evaluation, is one call of ops.moments.phase_moments_merged (the CUDA
kernel on the card, its plain twin on the CPU).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from pulseportraiture_tpu_torch._device import require_f32_matmul
from pulseportraiture_tpu_torch.config import F0_FACT
from pulseportraiture_tpu_torch.fitters.phase_shift import (_cross_spectrum,
                                                            grid_table,
                                                            merged_stream)
from pulseportraiture_tpu_torch.fitters.stats import _phase_trig
from pulseportraiture_tpu_torch.ops.moments import phase_moments_merged
from pulseportraiture_tpu_torch.ops.noise import noise_PS_profiles

TWO_PI = 2.0 * math.pi

ALGORITHMS = ("PGS", "FDM", "SIS", "PIS", "GIS", "COF")

# bytes of one (channels, npts, nharm) quadrature table of shift_FDM; the
# channels are walked in chunks of this size
_FDM_TABLE_BYTES = 1 << 26


class ShiftResult(NamedTuple):
    shift: torch.Tensor       # (nchan,) [rot], data relative to model
    shift_err: torch.Tensor   # (nchan,) [rot]
    scale: torch.Tensor       # (nchan,)
    snr: torch.Tensor         # (nchan,)


def _prep(data, model, noise, f0_fact=F0_FACT):
    """Split-real spectra, cross spectrum and powers for (C, nbin)."""
    data = torch.atleast_2d(torch.as_tensor(data))
    model = torch.atleast_2d(torch.as_tensor(model)).to(
        dtype=data.dtype, device=data.device)
    require_f32_matmul("arrival_time_shifts", data.device)
    return _cross_spectrum(data, model, noise, f0_fact)


def _inv_sqrt_pos(v):
    """v**-0.5 where v > 0, inf elsewhere."""
    pos = v > 0.0
    return torch.where(pos, torch.where(pos, v, torch.ones_like(v)) ** -0.5,
                       torch.full_like(v, math.inf))


def _ccf_max(cr, ci, Ns=256, newton_iter=8):
    """Band-limited CCF maximum per channel: brute grid + Newton.

    ccf(phi) = sum_k cr cos(2 pi k phi) - ci sin(2 pi k phi).
    Returns (phi, ccf(phi), ccf''(phi)).
    """
    dtype, dev = cr.dtype, cr.device
    g = merged_stream(cr, ci)
    grid = torch.linspace(-0.5, 0.5, Ns, dtype=torch.float64)
    ct, st = grid_table(grid, cr.shape[-1], dtype, dev)
    vals = ct @ cr.T - st @ ci.T                          # (Ns, C)
    phi = grid.to(dtype=dtype, device=dev)[torch.argmax(vals, dim=0)]
    ninf = torch.full_like(phi, -math.inf)
    for _ in range(newton_iter):
        _, Cp, Cpp = phase_moments_merged(phi, g)
        step = Cp / torch.where(Cpp < 0.0, Cpp, ninf)
        phi = phi - torch.clamp(step, -0.5 / Ns, 0.5 / Ns)
    C, _, Cpp = phase_moments_merged(phi, g)
    return phi, C, Cpp


def _pgs(cr, ci, p0, err):
    w2 = err ** -2.0
    phi, cmax, curv = _ccf_max(cr, ci)
    p = p0 * w2
    scale = cmax * w2 / p
    shift_err = _inv_sqrt_pos(scale * (-curv) * w2)   # curvature of chi2/2
    snr = torch.sqrt(torch.clamp(scale ** 2 * p, min=0.0))
    return phi, shift_err, scale, snr, cmax, p, w2


def shift_PGS(data, model, noise=None):
    cr, ci, _, p0, err, _ = _prep(data, model, noise)
    phi, shift_err, scale, snr, _, _, _ = _pgs(cr, ci, p0, err)
    return ShiftResult(phi, shift_err, scale, snr)


def shift_FDM(data, model, noise=None, npts=257, width_sigmas=8.0,
              chunk=None):
    """MAP shift with a posterior-quadrature error bar.

    chi2(phi)/2 marginalized over the scale is -C(phi)^2/(2 p) + const;
    the error is the SD of exp(C(phi)^2/(2p) - C(phi_map)^2/(2p)) on a
    grid of +-width_sigmas PGS-sigmas (clamped to a full turn).  The
    (channels, npts, nharm) cos and sin tables are formed `chunk` channels
    at a time (default: _FDM_TABLE_BYTES each); each channel's result is
    independent of the chunking.
    """
    cr, ci, _, p0, err, _ = _prep(data, model, noise)
    phi, sig_pgs, scale, snr, cmax, p, w2 = _pgs(cr, ci, p0, err)
    nchan, nharm = cr.shape
    k = torch.arange(nharm, dtype=cr.dtype, device=cr.device)
    ok = torch.isfinite(sig_pgs) & (sig_pgs > 0.0)
    half = torch.where(ok, torch.clamp(width_sigmas * sig_pgs, max=0.5),
                       torch.full_like(sig_pgs, 0.5))
    offs = torch.linspace(-1.0, 1.0, npts, dtype=cr.dtype, device=cr.device)
    phis = phi[:, None] + half[:, None] * offs[None, :]      # (C, npts)
    if chunk is None:
        chunk = _FDM_TABLE_BYTES // (npts * nharm * cr.element_size())
    chunk = max(1, int(chunk))
    Cs = []
    for i in range(0, nchan, chunk):
        sl = slice(i, i + chunk)
        cos, sin = _phase_trig(phis[sl], k)                  # (c, npts, K)
        # a plain row-wise sum, not a batched matmul: a library's blocking
        # may depend on how many channels share the call
        Cs.append(torch.sum(cos * cr[sl, None, :] - sin * ci[sl, None, :],
                            dim=-1))
        del cos, sin
    C = torch.cat(Cs) * w2[:, None]
    logw = (C ** 2 - (cmax * w2)[:, None] ** 2) / (2.0 * p[:, None])
    w = torch.exp(torch.clamp(logw, -60.0, 0.0))
    wsum = torch.sum(w, dim=-1)
    mu = torch.sum(w * phis, dim=-1) / wsum
    var = torch.sum(w * (phis - mu[:, None]) ** 2, dim=-1) / wsum
    return ShiftResult(phi, torch.sqrt(var), scale, snr)


def shift_SIS(data, model, noise=None):
    """Unweighted band-limited (sinc-interpolated) CCF peak.

    The `noise` argument is ignored by design: the error propagates a
    noise level self-estimated from the data's own high-harmonic power
    through the CCF peak,
    sigma_phi = sigma_F * 2 pi sqrt(sum_k k^2 |M_k|^2) / |CCF''|.
    With per-channel white noise the PGS and SIS point estimates coincide
    (the scalar weight cancels in the CCF argmax); the errors differ.
    """
    cr, ci, _, p0, _, (_, _, mr, mi) = _prep(data, model, None)
    data = torch.atleast_2d(torch.as_tensor(data))
    nbin = data.shape[-1]
    # self-estimated Fourier-amplitude noise SD (per re/im part)
    sigma_F = noise_PS_profiles(data) * math.sqrt(nbin / 2.0)
    phi, cmax, curv = _ccf_max(cr, ci)
    scale = cmax / p0
    k = torch.arange(cr.shape[-1], dtype=cr.dtype, device=cr.device)
    m2k2 = torch.sum(k * k * (mr * mr + mi * mi), dim=-1)
    shift_err = torch.where(
        curv < 0.0, sigma_F * TWO_PI * torch.sqrt(m2k2) / (-curv),
        torch.full_like(curv, math.inf))
    snr = torch.clamp(scale, min=0.0) * torch.sqrt(p0) / sigma_F
    return ShiftResult(phi, shift_err, scale, snr)


def _discrete_ccf(cr, ci, nbin):
    """ccf(-j/nbin) for j < nbin by an inverse FFT.  irfft halves the DC
    and Nyquist terms against the plain cosine series of _ccf_max; both
    are restored."""
    ccf = torch.fft.irfft(torch.complex(cr, -ci), n=nbin, dim=-1) * \
        (nbin / 2.0)
    corr = 0.5 * cr[..., :1] * torch.ones_like(ccf)
    if nbin % 2 == 0:
        j = torch.arange(nbin, dtype=cr.dtype, device=cr.device)
        corr = corr + 0.5 * cr[..., -1:] * torch.cos(math.pi * j)
    return ccf + corr


def _three_point(y_m, y_0, y_p):
    denom = y_m - 2.0 * y_0 + y_p
    return 0.5 * (y_m - y_p) / torch.where(denom != 0.0, denom,
                                           torch.ones_like(denom)), denom


def _interp_shift(data, model, noise, log_interp):
    cr, ci, _, p0, err, _ = _prep(data, model, noise)
    nbin = torch.as_tensor(data).shape[-1]
    ccf = _discrete_ccf(cr, ci, nbin)                    # (C, nbin)
    imax = torch.argmax(ccf, dim=-1)
    rows = torch.arange(ccf.shape[0], device=ccf.device)
    y0 = ccf[rows, imax]
    ym = ccf[rows, (imax - 1) % nbin]
    yp = ccf[rows, (imax + 1) % nbin]
    if log_interp:   # Gaussian interpolation: parabola on ln y
        floor = 1e-12 * torch.clamp(y0, min=1.0)
        delta, _ = _three_point(torch.log(torch.maximum(ym, floor)),
                                torch.log(torch.maximum(y0, floor)),
                                torch.log(torch.maximum(yp, floor)))
        curv_y = ym - 2.0 * y0 + yp
    else:            # parabolic interpolation
        delta, curv_y = _three_point(ym, y0, yp)
    delta = torch.clamp(delta, -0.5, 0.5)
    # the inverse FFT evaluates the series at phi = -j/nbin, so the argmax
    # bin maps to a shift of -(j + delta)/nbin in _ccf_max's convention
    phi = -(imax + delta) / nbin
    phi = (phi + 0.5) % 1.0 - 0.5
    w2 = err ** -2.0
    scale = y0 / p0
    shift_err = _inv_sqrt_pos(scale * (-curv_y * nbin ** 2) * w2)
    snr = torch.sqrt(torch.clamp(scale ** 2 * p0 * w2, min=0.0))
    return ShiftResult(phi, shift_err, scale, snr)


def shift_PIS(data, model, noise=None):
    return _interp_shift(data, model, noise, log_interp=False)


def shift_GIS(data, model, noise=None):
    return _interp_shift(data, model, noise, log_interp=True)


def shift_COF(data, model, noise=None):
    """Circular center-of-flux: first-harmonic phase of data - model."""
    cr, ci, _, p0, err, (dr, di, _, _) = _prep(data, model, noise)
    # arg(D1) - arg(M1) = arg(D1 conj(M1)) = arg(c1)
    phi = torch.atan2(-ci[..., 1], cr[..., 1]) / TWO_PI
    a1 = torch.sqrt(dr[..., 1] ** 2 + di[..., 1] ** 2)
    pos = a1 > 0.0
    shift_err = torch.where(
        pos, err / torch.where(pos, a1, torch.ones_like(a1)) / TWO_PI,
        torch.full_like(a1, math.inf))
    w2 = err ** -2.0
    k = torch.arange(cr.shape[-1], dtype=cr.dtype, device=cr.device)
    cos, sin = _phase_trig(phi, k)
    scale = torch.sum(cr * cos - ci * sin, dim=-1) / p0
    snr = torch.sqrt(torch.clamp(scale ** 2 * p0 * w2, min=0.0))
    return ShiftResult(phi, shift_err, scale, snr)


_DISPATCH = {"PGS": shift_PGS, "FDM": shift_FDM, "SIS": shift_SIS,
             "PIS": shift_PIS, "GIS": shift_GIS, "COF": shift_COF}


def arrival_time_shifts(data, model, noise=None, algorithm="PGS"):
    """Dispatch on the PSRCHIVE `pat -A` style algorithm code."""
    try:
        fn = _DISPATCH[algorithm]
    except KeyError:
        raise ValueError(
            f"algorithm {algorithm!r} not supported; one of {ALGORITHMS}")
    return fn(data, model, noise=noise)
