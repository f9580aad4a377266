"""Evolving Gaussian-component portrait models and their fitters.

Port of pulseportraiture_tpu.models.gaussian.  Parameter layout as the
reference's .gmodel convention (pplib.py:853-930): params = [dc, tau_bin,
(loc, m_loc, wid, m_wid, amp, m_amp) * ngauss (+ 2*njoin join params)],
with per-channel evolution of (loc, wid, amp) controlled by a three-digit
model code ('0' power-law, '1' linear).

The generators run on tensors, batched over channels and differentiable
(the scattering through torch.fft, the join rotations through
ops.rotate), so the lmfit Levenberg-Marquardt fits of the reference
(pplib.py:1842-2052) become one bounded LM loop on the data's device with
exact forward-mode Jacobians (torch.func.jvp over the parameter basis)
and lmfit/MINUIT-style bound transforms.  The loop syncs with the host
once per iteration, on its stop flag; only the (p, p) curvature and the
parameters leave the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from pulseportraiture_tpu_torch.config import WID_MAX
from pulseportraiture_tpu_torch.ops.scattering import scattering_portrait_FT
from pulseportraiture_tpu_torch.utils import DataBunch

_FWHM = 2.0 * math.sqrt(2.0 * math.log(2.0))


def _t(x, like=None):
    """x as a floating tensor: tensors keep their device and dtype (a
    non-float one becomes float64); host data go to like's device and
    dtype, else float64 on the CPU: a template is evaluated on the host
    unless a tensor puts it elsewhere."""
    if torch.is_tensor(x):
        return x if x.dtype.is_floating_point else x.to(torch.float64)
    if like is None:
        return torch.as_tensor(np.asarray(x, dtype=np.float64))
    return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=like.dtype,
                           device=like.device)


def _evolution_args(freqs, parameter, evol):
    parameter = torch.atleast_1d(_t(parameter))
    return (_t(freqs, like=parameter), parameter,
            torch.atleast_1d(_t(evol, like=parameter)))


def power_law_evolution(freqs, nu_ref, parameter, index):
    """F(nu) = parameter * (nu/nu_ref)**index, (nchan, nparam).
    Reference: pplib.py:996-1011."""
    freqs, parameter, index = _evolution_args(freqs, parameter, index)
    log_ratio = torch.log(freqs) - math.log(nu_ref)
    return torch.exp(torch.outer(log_ratio, index) +
                     torch.log(parameter)[None, :])


def linear_evolution(freqs, nu_ref, parameter, slope):
    """F(nu) = parameter + slope*(nu - nu_ref), (nchan, nparam).
    Reference: pplib.py:1013-1028."""
    freqs, parameter, slope = _evolution_args(freqs, parameter, slope)
    return torch.outer(freqs - nu_ref, slope) + parameter[None, :]


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
    locval = (torch.arange(nbin, dtype=locs.dtype, device=locs.device) +
              0.5) / nbin
    mean = torch.remainder(locs[..., None], 1.0)       # (..., ngauss, 1)
    lv = locval.expand(mean.shape[:-1] + (nbin,))
    lv = torch.where(mean < 0.5,
                     torch.where(lv > mean + 0.5, lv - 1.0, lv),
                     torch.where(lv < mean - 0.5, lv + 1.0, lv))
    safe_wid = torch.where(wids > 0.0, wids, torch.ones_like(wids))
    sigma = (safe_wid / _FWHM)[..., None]
    zs = (lv - mean) / sigma
    vals = torch.where(torch.abs(zs) < 20.0, torch.exp(-0.5 * zs ** 2),
                       torch.zeros_like(zs))
    # divide by the largest sample, multiply by exp(-z_peak^2/2) with
    # z_peak measured from the true loc
    peak = torch.amax(vals, dim=-1, keepdim=True)
    imax = torch.argmax(vals, dim=-1, keepdim=True)
    z_peak = (torch.take_along_dim(lv, imax, dim=-1) - locs[..., None]) / \
        sigma
    fact = torch.where(peak > 0.0, torch.exp(-0.5 * z_peak ** 2) /
                       torch.where(peak > 0.0, peak, torch.ones_like(peak)),
                       torch.zeros_like(peak))
    vals = torch.where((wids > 0.0)[..., None], vals * fact,
                       torch.zeros_like(vals))
    return torch.sum(vals * amps[..., None], dim=-2)       # over ngauss


def _scatter(port, taus, tau):
    """port (..., nbin) convolved with one-sided exponentials of taus
    [rot] through the analytic FT, where tau != 0."""
    nbin = port.shape[-1]
    scattered = torch.fft.irfft(torch.fft.rfft(port, dim=-1) *
                                scattering_portrait_FT(taus, nbin), n=nbin,
                                dim=-1)
    return torch.where(tau != 0.0, scattered, port)


def gen_gaussian_profile(params, nbin):
    """DC + ngauss Gaussians (+ scattering via the analytic FT), (nbin,),
    on params' device (host data: the CPU), differentiable.

    params = [dc, tau_bin, (loc, wid, amp) * ngauss].
    Reference: pplib.py:827-851.
    """
    params = _t(params)
    ngauss = (params.shape[0] - 2) // 3
    model = params[0] + _gaussian_profiles_vec(
        nbin, params[2::3][:ngauss], params[3::3][:ngauss],
        params[4::3][:ngauss])
    return _scatter(model, params[1] / nbin, params[1])


def gen_gaussian_portrait(model_code, params, scattering_index, phases,
                          freqs, nu_ref, join_ichans=(), P=None):
    """Evolving Gaussian-component model portrait (nchan, nbin) on params'
    device (host data: the CPU), in params' dtype,
    batched over channels and differentiable.

    Scattering (tau in [bin] at nu_ref, pplib.py:915-922) is applied
    portrait-wide through the analytic FT; the join rotations to the
    listed channel groups.  Reference: pplib.py:853-930.
    """
    params = _t(params)
    freqs = _t(freqs, like=params)
    scattering_index = _t(scattering_index, like=params)
    nu_ref = float(nu_ref)
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
    taus = tau / nbin * (freqs / nu_ref) ** scattering_index
    gport = _scatter(gport, taus, tau)
    if njoin:
        from pulseportraiture_tpu_torch.ops.rotate import rotate_portrait
        for ij in range(njoin):
            ichans = torch.as_tensor(np.asarray(join_ichans[ij]),
                                     dtype=torch.long, device=gport.device)
            rotated = rotate_portrait(gport[ichans], join_params[2 * ij],
                                      join_params[2 * ij + 1], P,
                                      freqs[ichans], nu_ref)
            gport = gport.index_copy(0, ichans, rotated.to(gport.dtype))
    return gport


# ----------------------------------------------------------------------
# Bounded Levenberg-Marquardt (replaces lmfit; pplib.py:1842-2052)
# ----------------------------------------------------------------------

class LMResult(NamedTuple):
    x: torch.Tensor
    chi2: torch.Tensor
    niter: int
    converged: bool
    njac: int           # Jacobians taken in the loop (accepted steps + 1)
    nrejected: int      # rejected steps (each one residual evaluation)


def _to_internal(x, lo, hi):
    """lmfit/MINUIT bound transform: external -> internal (free)."""
    both = torch.isfinite(lo) & torch.isfinite(hi)
    lo_only = torch.isfinite(lo) & ~torch.isfinite(hi)
    hi_only = ~torch.isfinite(lo) & torch.isfinite(hi)
    x_c = torch.clamp(x, lo + 1e-300, hi - 1e-300)
    arg = 2.0 * (x_c - lo) / torch.where(both, hi - lo,
                                         torch.ones_like(lo)) - 1.0
    i_both = torch.arcsin(torch.clamp(arg, -1.0, 1.0))
    i_lo = torch.sqrt(torch.clamp((x - lo + 1.0) ** 2 - 1.0, min=0.0))
    i_hi = torch.sqrt(torch.clamp((hi - x + 1.0) ** 2 - 1.0, min=0.0))
    return torch.where(both, i_both, torch.where(
        lo_only, i_lo, torch.where(hi_only, i_hi, x)))


def _to_external(u, lo, hi):
    """Internal -> external (the inverse of _to_internal)."""
    both = torch.isfinite(lo) & torch.isfinite(hi)
    lo_only = torch.isfinite(lo) & ~torch.isfinite(hi)
    hi_only = ~torch.isfinite(lo) & torch.isfinite(hi)
    e_both = lo + (torch.sin(u) + 1.0) * torch.where(
        both, hi - lo, torch.ones_like(lo)) / 2.0
    e_lo = lo - 1.0 + torch.sqrt(u ** 2 + 1.0)
    e_hi = hi + 1.0 - torch.sqrt(u ** 2 + 1.0)
    return torch.where(both, e_both, torch.where(
        lo_only, e_lo, torch.where(hi_only, e_hi, u)))


def _jacobian_T(fn, x, m):
    """J^T (p, m) of fn: (p,) -> (m,) at x by forward mode, one jvp per
    parameter, vmapped in chunks that keep a batched residual-sized
    intermediate near 2**26 elements."""
    p = x.shape[0]
    basis = torch.eye(p, dtype=x.dtype, device=x.device)
    chunk = max(1, min(p, (1 << 26) // max(m, 1)))
    return torch.func.vmap(lambda v: torch.func.jvp(fn, (x,), (v,))[1],
                           chunk_size=chunk)(basis)


def levenberg_marquardt(residual_fn, x0, lo, hi, fit_mask, max_iter=200,
                        ftol=1e-12, xtol=1e-12):
    """Bounded LM minimization of sum(residual_fn(x)**2) on x0's device.

    residual_fn: x (p,) -> residuals (m,), differentiable by torch.func.
    Bounds are handled by smooth transforms; frozen parameters
    (fit_mask 0) are held at x0 (identity rows in the normal equations).
    Each iteration solves (JtJ + lam diag JtJ) step = -J^T r; lam is
    divided by 10 on an improvement, else multiplied by 10, within
    [1e-14, 1e14]; the loop stops on an improvement with a relative
    chi2 decrease below ftol or max |step| below xtol, or at max_iter.
    These are the JAX package's rules; two shortcuts leave x and chi2 as
    they are: a rejected step keeps the Jacobian (x did not move), and a
    step rejected at lam = 1e14 ends the loop, whose state is then a
    fixed point (the JAX loop repeats it until max_iter).  The loop syncs
    with the host once per iteration, on its two flags.

    Returns (LMResult, JtJ): the (p, p) Gram matrix of the external
    Jacobian at the solution, non-finite entries set to 0 (host errors
    via _param_errs_from_jtj).  One loop for both of the JAX package's
    levenberg_marquardt and levenberg_marquardt_jit.
    """
    lo = _t(lo, like=x0)
    hi = _t(hi, like=x0)
    mask = _t(fit_mask, like=x0)

    def ext(u):
        return torch.where(mask > 0, _to_external(u, lo, hi), x0)

    def r_of(u):
        return residual_fn(ext(u))

    u = _to_internal(x0, lo, hi)
    chi2 = torch.sum(r_of(u) ** 2)
    lam = 1e-3
    frozen = torch.diag(1.0 - mask)
    it, done, Jt, njac, nrej = 0, False, None, 0, 0
    while not done and it < max_iter:
        if Jt is None:                      # x moved: a new Jacobian
            njac += 1
            r = r_of(u)
            Jt = _jacobian_T(r_of, u, r.numel())    # (p, m)
            JtJ = (Jt @ Jt.T) * torch.outer(mask, mask) + frozen
            Jtr = (Jt @ r) * mask
            damp = torch.diag(torch.clamp(torch.diag(JtJ), min=1e-30))
        step = torch.linalg.solve(JtJ + lam * damp, -Jtr)
        chi2_new = torch.sum(r_of(u + step) ** 2)
        improved = (chi2_new < chi2) & torch.isfinite(chi2_new)
        rel_df = (chi2 - chi2_new) / torch.clamp(chi2, min=1e-300)
        stop = improved & ((rel_df < ftol) |
                           (torch.max(torch.abs(step)) < xtol))
        u = torch.where(improved, u + step, u)
        chi2 = torch.where(improved, chi2_new, chi2)
        it += 1
        improved, done = torch.stack([improved, stop]).tolist()
        if improved:
            lam = max(lam / 10.0, 1e-14)
            Jt = None
            continue
        nrej += 1
        if lam == 1e14:
            break                           # a fixed point
        lam = min(lam * 10.0, 1e14)
    x = ext(u)
    Jt = _jacobian_T(residual_fn, x, residual_fn(x).numel())
    Jt = torch.where(torch.isfinite(Jt), Jt, torch.zeros_like(Jt))
    return LMResult(x=x, chi2=chi2, niter=it, converged=done, njac=njac,
                    nrejected=nrej), Jt @ Jt.T


def _param_errs_from_jtj(JtJ, mask):
    """1-sigma errors (host float64) from the (p, p) curvature at the
    solution: the diagonal of pinv of its fitted block (a singular
    direction, e.g. tau pinned at 0, gets zero error instead of
    poisoning the rest); the inverse diagonal if the SVD fails."""
    if torch.is_tensor(JtJ):
        JtJ = JtJ.detach().cpu().numpy()
    m = np.asarray(mask) > 0
    JtJ = np.asarray(JtJ, dtype=np.float64)
    errs = np.zeros(JtJ.shape[0])
    sub = JtJ[np.ix_(m, m)]
    try:
        diag = np.diag(np.linalg.pinv(sub))
    except np.linalg.LinAlgError:
        d = np.diag(sub)
        diag = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    errs[m] = np.sqrt(np.clip(diag, 0.0, None))
    return errs


def _profile_bounds(nparam, wid_max=WID_MAX):
    """Bounds for [dc, tau, (loc, wid, amp)*n]: tau >= 0, 0 <= wid <=
    wid_max, amp >= 0 (reference pplib.py:1874-1894)."""
    lo = np.full(nparam, -np.inf)
    hi = np.full(nparam, np.inf)
    lo[1] = 0.0
    for i in range(2, nparam, 3):
        lo[i + 1] = 0.0
        hi[i + 1] = wid_max
        lo[i + 2] = 0.0
    return lo, hi


def fit_gaussian_profile(data, init_params, errs, fit_flags=None,
                         fit_scattering=False, quiet=True):
    """Fit DC + ngauss Gaussians (+ scattering) to a profile, on data's
    device (host data: the CPU), in its float type.
    Reference: pplib.py:1842-1922."""
    data = _t(data)
    x0 = _t(init_params, like=data).to(data.dtype)
    nparam, nbin = x0.shape[0], data.shape[0]
    if fit_flags is None:
        mask = np.ones(nparam)
        mask[1] = 1.0 if fit_scattering else 0.0
    else:
        mask = np.array([float(bool(fit_flags[0])),
                         1.0 if fit_scattering else 0.0] +
                        [float(bool(f)) for f in fit_flags[1:nparam - 1]])
    lo, hi = _profile_bounds(nparam)
    err_arr = _t(errs, like=data).to(data.dtype).expand(data.shape)

    def residual(p):
        return (data - gen_gaussian_profile(p, nbin)) / err_arr

    res, JtJ = levenberg_marquardt(residual, x0, lo, hi, mask)
    dof = nbin - int(mask.sum())
    chi2 = float(res.chi2)
    return DataBunch(
        fitted_params=res.x.detach().cpu().numpy(),
        fit_errs=_param_errs_from_jtj(JtJ, mask),
        residuals=(data - gen_gaussian_profile(res.x, nbin)).cpu().numpy(),
        chi2=chi2, dof=dof, red_chi2=chi2 / max(dof, 1), niter=res.niter,
        njac=res.njac, nrejected=res.nrejected)


def fit_gaussian_portrait(model_code, data, init_params, scattering_index,
                          errs, fit_flags, fit_scattering_index, phases,
                          freqs, nu_ref, join_params=(), P=None, quiet=True):
    """Fit evolving Gaussian components to a portrait (nchan, nbin) on
    data's device (host data: the CPU), in its float type.

    init_params = [dc, tau, (loc, m_loc, wid, m_wid, amp, m_amp)*ngauss];
    join_params = (join_ichans, values, fit flags) puts 2 per join
    between the model parameters and the scattering index, which is the
    last fitted parameter.  Bounds: tau >= 0, wid in [0, WID_MAX], amp
    >= 0, the rest free (pplib.py:1924-2052).
    """
    data = _t(data)
    dt = data.dtype
    x_model = _t(init_params, like=data).to(dt)
    nparam = x_model.shape[0]
    lo = np.full(nparam + 1, -np.inf)
    hi = np.full(nparam + 1, np.inf)
    lo[1] = 0.0
    for i in range(2, nparam, 6):
        lo[i + 2] = 0.0
        hi[i + 2] = WID_MAX
        lo[i + 4] = 0.0
    mask = np.array([float(bool(f)) for f in fit_flags] +
                    [1.0 if fit_scattering_index else 0.0])
    alpha0 = torch.tensor([float(scattering_index)], dtype=dt,
                          device=data.device)
    if len(join_params):
        join_ichans = join_params[0]
        join_vals = np.asarray(join_params[1], dtype=float)
        x0 = torch.cat([x_model, _t(join_vals, like=data).to(dt), alpha0])
        lo = np.concatenate([lo[:-1], np.full(len(join_vals), -np.inf),
                             [-np.inf]])
        hi = np.concatenate([hi[:-1], np.full(len(join_vals), np.inf),
                             [np.inf]])
        mask = np.concatenate([mask[:-1],
                               [float(bool(f)) for f in join_params[2]],
                               [1.0 if fit_scattering_index else 0.0]])
    else:
        join_ichans = ()
        x0 = torch.cat([x_model, alpha0])
    err_arr = _t(errs, like=data).to(dt)[:, None].expand(data.shape)
    freqs = _t(freqs, like=data).to(dt)

    def residual(p):
        model = gen_gaussian_portrait(model_code, p[:-1], p[-1], phases,
                                      freqs, nu_ref, join_ichans=join_ichans,
                                      P=P)
        return ((data - model) / err_arr).reshape(-1)

    res, JtJ = levenberg_marquardt(residual, x0, lo, hi, mask)
    dof = data.numel() - int(mask.sum())
    x = res.x.detach().cpu().numpy()
    errs_all = _param_errs_from_jtj(JtJ, mask)
    chi2 = float(res.chi2)
    return DataBunch(fitted_params=x[:-1], fit_errs=errs_all[:-1],
                     scattering_index=float(x[-1]),
                     scattering_index_err=float(errs_all[-1]),
                     chi2=chi2, dof=dof, red_chi2=chi2 / max(dof, 1),
                     niter=res.niter, njac=res.njac,
                     nrejected=res.nrejected)
