"""Evolving Gaussian-component portrait models (.gmodel templates).

Port of the generator half of pulseportraiture_tpu.models.gaussian, on
the host in float64 numpy (a template is evaluated once per frequency
grid; the Levenberg-Marquardt model fitters are not ported yet).
Parameter layout as the reference's .gmodel convention
(pplib.py:853-930): params = [dc, tau_bin, (loc, m_loc, wid, m_wid, amp,
m_amp) * ngauss (+ 2*njoin join params)], with per-channel evolution of
(loc, wid, amp) controlled by a three-digit model code ('0' power-law,
'1' linear).
"""

from __future__ import annotations

import numpy as np

from pulseportraiture_tpu_torch.ops.rotate import rotate_portrait_np
from pulseportraiture_tpu_torch.ops.scattering import (
    scattering_portrait_FT_np, scattering_times)

_FWHM = 2.0 * np.sqrt(2.0 * np.log(2.0))


def power_law_evolution(freqs, nu_ref, parameter, index):
    """F(nu) = parameter * (nu/nu_ref)**index, (nchan, nparam).
    Reference: pplib.py:996-1011."""
    freqs = np.asarray(freqs, np.float64)
    parameter = np.atleast_1d(np.asarray(parameter, np.float64))
    index = np.atleast_1d(np.asarray(index, np.float64))
    log_ratio = np.log(freqs) - np.log(nu_ref)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.exp(np.outer(log_ratio, index) +
                      np.log(parameter)[None, :])


def linear_evolution(freqs, nu_ref, parameter, slope):
    """F(nu) = parameter + slope*(nu - nu_ref), (nchan, nparam).
    Reference: pplib.py:1013-1028."""
    freqs = np.asarray(freqs, np.float64)
    parameter = np.atleast_1d(np.asarray(parameter, np.float64))
    slope = np.atleast_1d(np.asarray(slope, np.float64))
    return np.outer(freqs - nu_ref, slope) + parameter[None, :]


_EVOLUTION_FUNCTIONS = {"0": power_law_evolution, "1": linear_evolution}


def evolve_parameter(freqs, nu_ref, parameter, evol_parameter, code):
    """Dispatch on the single-digit evolution code.
    Reference: pplib.py:1030-1046."""
    return _EVOLUTION_FUNCTIONS[code](freqs, nu_ref, parameter,
                                      evol_parameter)


def _gaussian_profiles_vec(nbin, locs, wids, amps):
    """Sum of peak-normalized Gaussians for stacked (..., ngauss)
    parameters, (..., nbin): the reference's per-channel gaussian_profile
    (pplib.py:770-825) with its wraparound, |z| < 20 cutoff and
    nearest-bin-center peak normalization."""
    locval = (np.arange(nbin, dtype=np.float64) + 0.5) / nbin
    mean = locs[..., None] % 1.0                           # (..., ngauss, 1)
    lv = np.broadcast_to(locval, mean.shape[:-1] + (nbin,))
    lv = np.where(mean < 0.5,
                  np.where(lv > mean + 0.5, lv - 1.0, lv),
                  np.where(lv < mean - 0.5, lv + 1.0, lv))
    safe_wid = np.where(wids > 0.0, wids, 1.0)
    sigma = (safe_wid / _FWHM)[..., None]
    zs = (lv - mean) / sigma
    vals = np.where(np.abs(zs) < 20.0, np.exp(-0.5 * zs ** 2), 0.0)
    # divide by the largest sample, multiply by exp(-z_peak^2/2) with
    # z_peak measured from the true loc
    peak = np.max(vals, axis=-1, keepdims=True)
    imax = np.argmax(vals, axis=-1)[..., None]
    lv_peak = np.take_along_axis(lv, imax, axis=-1)
    z_peak = (lv_peak - locs[..., None]) / sigma
    fact = np.where(peak > 0.0, np.exp(-0.5 * z_peak ** 2) /
                    np.where(peak > 0.0, peak, 1.0), 0.0)
    vals = np.where((wids > 0.0)[..., None], vals * fact, 0.0)
    return np.sum(vals * amps[..., None], axis=-2)         # over ngauss


def _scatter(port, taus, nbin):
    """Convolve (..., nbin) rows with one-sided exponentials of taus
    [rot] through the analytic FT."""
    return np.fft.irfft(np.fft.rfft(port, axis=-1) *
                        scattering_portrait_FT_np(taus, nbin), n=nbin,
                        axis=-1)


def gen_gaussian_profile(params, nbin):
    """DC + ngauss Gaussians (+ scattering via the analytic FT), (nbin,).

    params = [dc, tau_bin, (loc, wid, amp) * ngauss].
    Reference: pplib.py:827-851.
    """
    params = np.asarray(params, np.float64)
    ngauss = (params.shape[0] - 2) // 3
    locs = params[2::3][:ngauss]
    wids = params[3::3][:ngauss]
    amps = params[4::3][:ngauss]
    model = params[0] + _gaussian_profiles_vec(nbin, locs, wids, amps)
    tau_bin = params[1]
    if tau_bin != 0.0:
        model = _scatter(model, np.asarray(tau_bin / nbin), nbin)
    return model


def gen_gaussian_portrait(model_code, params, scattering_index, phases,
                          freqs, nu_ref, join_ichans=(), P=None):
    """Evolving Gaussian-component model portrait (nchan, nbin), float64.

    Scattering (tau in [bin] at nu_ref, pplib.py:915-922) is applied
    portrait-wide through the analytic FT; the join rotations are applied
    to the listed channel groups.  Reference: pplib.py:853-930.
    """
    params = np.asarray(params, np.float64)
    freqs = np.asarray(freqs, np.float64)
    nbin = len(phases)
    njoin = len(join_ichans)
    if njoin:
        join_params = params[-njoin * 2:]
        params = params[:-njoin * 2]
    dc, tau = params[0], params[1]
    refparams = params[2::2]        # (loc, wid, amp) per gauss at nu_ref
    evolparams = params[3::2]       # (m_loc, m_wid, m_amp) per gauss
    locs = evolve_parameter(freqs, nu_ref, refparams[0::3], evolparams[0::3],
                            model_code[0])
    wids = evolve_parameter(freqs, nu_ref, refparams[1::3], evolparams[1::3],
                            model_code[1])
    amps = evolve_parameter(freqs, nu_ref, refparams[2::3], evolparams[2::3],
                            model_code[2])
    gport = dc + _gaussian_profiles_vec(nbin, locs, wids, amps)
    if tau != 0.0:
        taus = scattering_times(tau / nbin, scattering_index, freqs, nu_ref)
        gport = _scatter(gport, taus, nbin)
    for ij in range(njoin):
        ichans = np.asarray(join_ichans[ij])
        gport[ichans] = rotate_portrait_np(
            gport[ichans], join_params[0::2][ij], join_params[1::2][ij], P,
            freqs[ichans], nu_ref)
    return gport
