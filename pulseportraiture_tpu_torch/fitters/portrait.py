"""Batched wideband portrait fit: (phi, DM) and the scattering fit.

Port of pulseportraiture_tpu.fitters.portrait.fit_portrait_full_batch
(and, through seed_phase=False, nu_outs and scattering=True, of what the
pipeline asks of the per-subint fit_portrait_full) with one route: the
template spectrum (shared or per item, capped or full band), the fused
setup (ops.setup_dft: DFT, cross-spectrum, data power and the two
stacked seed sums in one pass), the joint brute (phi, DM) seed, the
batched trust-region Newton loop over the phase moments (tau and alpha
fixed) or the scattering moments (tau, and alpha, fitted), then
re-referencing to the zero-covariance frequencies and the Woodbury
covariance.  Reference: pptoaslib.py:928-1096.
"""

from __future__ import annotations

import functools
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from pulseportraiture_tpu_torch._device import as_tensor, require_f32_matmul
from pulseportraiture_tpu_torch.config import DCONST, F0_FACT
from pulseportraiture_tpu_torch.fitters import newton, nu_zeros, stats
from pulseportraiture_tpu_torch.ops.launches import tally
from pulseportraiture_tpu_torch.ops.noise import noise_PS_profiles
from pulseportraiture_tpu_torch.ops.scattering import scattering_times
from pulseportraiture_tpu_torch.ops.moments import phase_moments_reference
from pulseportraiture_tpu_torch.ops.setup_dft import (fused_setup,
                                                      fused_setup_reference)
from pulseportraiture_tpu_torch.ops.transform import (_inv2, _inv4,
                                                      mod_pm_half,
                                                      phase_shifts,
                                                      phase_shifts_deriv)
from pulseportraiture_tpu_torch.profiling import annotate
from pulseportraiture_tpu_torch.utils import DataBunch


class PortraitFitResult(NamedTuple):
    """Result of a batched 5-parameter fit (leading batch axis)."""

    params: torch.Tensor        # (B, 5) [phi_out, DM, GM, tau_out, alpha]
    param_errs: torch.Tensor    # (B, 5)
    scales: torch.Tensor        # (B, nchan)
    scale_errs: torch.Tensor    # (B, nchan)
    nu_DM: torch.Tensor
    nu_GM: torch.Tensor
    nu_tau: torch.Tensor
    covariance_matrix: torch.Tensor  # (B, 5, 5) masked to fitted params
    chi2: torch.Tensor
    red_chi2: torch.Tensor
    snr: torch.Tensor
    channel_snrs: torch.Tensor
    niter: torch.Tensor
    nfeval: torch.Tensor
    return_code: torch.Tensor
    channel_red_chi2: torch.Tensor = None  # (B, nchan)

    @property
    def phi(self):
        return self.params[..., 0]

    @property
    def DM(self):
        return self.params[..., 1]

    @property
    def GM(self):
        return self.params[..., 2]

    @property
    def tau(self):
        return self.params[..., 3]

    @property
    def alpha(self):
        return self.params[..., 4]

    @property
    def phi_err(self):
        return self.param_errs[..., 0]

    @property
    def DM_err(self):
        return self.param_errs[..., 1]

    @property
    def GM_err(self):
        return self.param_errs[..., 2]

    @property
    def tau_err(self):
        return self.param_errs[..., 3]

    @property
    def alpha_err(self):
        return self.param_errs[..., 4]


def _brute_phase_seed(gsr, gsi, Ns=512):
    """Per-item brute phase from a band-summed cross-spectrum (B, NH):
    argmax over an Ns-point circular grid of sum_k Re(G_k e^{2 pi i phi
    k}) (one (B, NH) @ (NH, Ns) product), refined by a 3-point parabola.
    """
    dt, dev = gsr.dtype, gsr.device
    grid = torch.arange(Ns, dtype=dt, device=dev) / Ns - 0.5
    k = torch.arange(gsr.shape[-1], dtype=dt, device=dev)
    Ct, St = stats._phase_trig(grid, k)                  # (Ns, NH)
    vals = gsr @ Ct.T - gsi @ St.T
    j = torch.argmax(vals, dim=-1)
    rows = torch.arange(vals.shape[0], device=dev)
    vm = vals[rows, torch.remainder(j - 1, Ns)]
    v0 = vals[rows, j]
    vp = vals[rows, torch.remainder(j + 1, Ns)]
    denom = vm - 2.0 * v0 + vp
    delta = torch.where(denom < 0.0, 0.5 * (vm - vp) / denom,
                        torch.zeros_like(denom))
    return grid[j] + torch.clamp(delta, -0.5, 0.5) / Ns


def _seed_phi_dm(gsr, gsi, wcurv, beta, kdm, Ns=512, max_dphi=0.1):
    """Joint brute (phi, DM) seed from the stacked [full band, upper
    half] seed sums gsr/gsi (B, 2, NH); the lower half is their
    difference.  The wrapped half-band phase difference over
    kdm*(beta_hi - beta_lo) (curvature-weighted effective dispersion
    delays) seeds DM; a difference beyond max_dphi turns falls back to
    (phi_full, 0).  The seed moves only the Newton start.
    """
    B = gsr.shape[0]
    g3r = torch.cat([gsr[:, 0], gsr[:, 1], gsr[:, 0] - gsr[:, 1]], dim=0)
    g3i = torch.cat([gsi[:, 0], gsi[:, 1], gsi[:, 0] - gsi[:, 1]], dim=0)
    ph = _brute_phase_seed(g3r, g3i, Ns=Ns)
    phi_full, phi_hi, phi_lo = ph[:B], ph[B:2 * B], ph[2 * B:]
    nchan = beta.shape[-1]
    hi = torch.arange(nchan, device=beta.device) >= nchan // 2
    w_hi = torch.where(hi[None, :], wcurv, torch.zeros_like(wcurv))
    w_lo = wcurv - w_hi

    def eff(wm):
        s = torch.sum(wm, dim=-1)
        return torch.sum(wm * beta, dim=-1) / torch.where(
            s > 0.0, s, torch.ones_like(s)), s

    b_full, _ = eff(wcurv)
    b_hi, s_hi = eff(w_hi)
    b_lo, s_lo = eff(w_lo)
    dphi = mod_pm_half(phi_hi - phi_lo)
    dbeta = kdm * (b_hi - b_lo)
    ok = (torch.abs(dbeta) > 1e-30) & (s_hi > 0.0) & (s_lo > 0.0) & \
        (torch.abs(dphi) < max_dphi)
    dm0 = torch.where(ok, dphi / torch.where(ok, dbeta,
                                             torch.ones_like(dbeta)),
                      torch.zeros_like(dphi))
    phi0 = mod_pm_half(phi_full - kdm * dm0 * b_full)
    return phi0, dm0


def _rereference(params, setup, nu_out_DM, nu_out_GM, nu_out_tau,
                 log10_tau, dconst=DCONST):
    """Transport fitted (phi, tau) to the output references; log10 tau
    becomes -inf where the transported tau is not positive.
    Reference: pptoaslib.py:1052-1065."""
    phi, DM, GM = params[..., 0], params[..., 1], params[..., 2]
    x_tau, alpha = params[..., 3], params[..., 4]
    P = setup.P
    phi_inf = phase_shifts(phi, DM, GM, math.inf, setup.nu_DM, setup.nu_GM,
                           P, mod=False, dconst=dconst)
    phi_out = phi_inf + (dconst / P) * DM * _inv2(nu_out_DM) + \
        (dconst ** 2 / P) * GM * _inv4(nu_out_GM)
    phi_out = mod_pm_half(phi_out)
    tau = 10.0 ** x_tau if log10_tau else x_tau
    tau_out = scattering_times(tau, alpha, nu_out_tau, setup.nu_tau)
    if log10_tau:
        pos = tau_out > 0.0
        x_tau_out = torch.where(
            pos, torch.log10(torch.where(pos, tau_out,
                                         torch.ones_like(tau_out))),
            torch.full_like(tau_out, -math.inf))
    else:
        x_tau_out = tau_out
    return torch.stack([phi_out, DM, GM, x_tau_out, alpha], dim=-1)


def _finalize(params_out, setup_out, fit_flags, fun, moments, log10_tau):
    """Covariance, scales, SNR and chi2 at the output references, from
    the optimizer's final moments rebased there (no pass over Gr/Gi)."""
    m_out = stats.rebase_moments(moments, setup_out, params_out, log10_tau)
    cov, perrs, scales, scale_errs, S = stats._covariance_core(
        m_out, setup_out, fit_flags)
    channel_snrs = scales * torch.sqrt(torch.clamp(S, min=0.0))
    snr = torch.sqrt(torch.sum(channel_snrs ** 2, dim=-1))
    chi2 = setup_out.Sd + fun
    active = setup_out.w > 0.0
    nbin = setup_out.nbin
    nfit = sum(int(bool(f)) for f in fit_flags)
    nact = torch.sum(active, dim=-1)
    dof = nact * nbin - (nfit + nact)
    red_chi2 = chi2 / dof
    # per-channel reduced chi2 at the fitted amplitudes, floored on live
    # channels (exactly 0 marks a dead channel downstream)
    ch_chi2 = torch.clamp(setup_out.sd_chan - scales * scales * S,
                          min=1e-30)
    channel_red_chi2 = torch.where(active, ch_chi2 / (nbin - 2),
                                   torch.zeros_like(ch_chi2))
    return (cov, perrs, scales, scale_errs, channel_snrs, snr, chi2,
            red_chi2, channel_red_chi2)


def template_spectrum(model_port, f0_fact=F0_FACT):
    """Full-band natural-order split spectrum (mr, mi) of a template
    (nchan, nbin), as a host float64 rfft with DC zeroed unless f0_fact."""
    if torch.is_tensor(model_port):
        model_port = model_port.detach().cpu().numpy()
    mf = np.fft.rfft(np.asarray(model_port, np.float64), axis=-1)
    mr, mi = mf.real.copy(), mf.imag.copy()
    if not f0_fact:
        mr[..., 0] = 0.0
        mi[..., 0] = 0.0
    return mr, mi


def fit_portrait_full_batch(data_ports, model_ft_ri, init_params, Ps, freqs,
                            errs, weights=None, nu_fits=None,
                            fit_flags=(1, 1, 0, 0, 0), log10_tau=True,
                            max_iter=100, scales=None, dtype=None,
                            seed_phase=True, nu_outs=None, scattering=None):
    """Batched fit of every item of data_ports against a template.

    data_ports: (B, nchan, nbin) float, or int16 with `scales` (B, nchan)
    (int16-native ingest; requires config.F0_FACT falsy).
    model_ft_ri: the template's natural-order split spectrum (mr, mi):
    each (nchan, nh), one template shared by every item (M2 then stays one
    (nchan, nh) array for the batch), or each (B, nchan, nh), a template
    per item (the JAX package's model_ports of shape (B, nchan, nbin)).
    nh = nbin/2 + 1 for the full band, or the capped prefix NH = NQ*M' of
    a band_cap_model_ft spectrum (host numpy or tensors; cast to the
    working dtype on the data's device).
    init_params (B, 5); Ps (B,); freqs (B, nchan) or (nchan,); errs
    (B, nchan) time-domain noise; weights optional (B, nchan) mask;
    nu_fits (B, 3) or None (per-item mean frequency).
    fit_flags: (phi, DM, GM, tau, alpha).  With tau or alpha fitted the
    Newton loop runs the scattering moments, tau (params[:, 3]) in log10
    when log10_tau, else linear [rot], referenced at nu_fits[:, 2].
    scattering: None takes tau as identically zero unless tau or alpha is
    fitted (the no-scattering specialization; params[:, 3:] then only
    ride along, linearly); True keeps an unfitted tau in the model, as
    the JAX package's per-subint fitter does for the reduced flag sets of
    a subint with too few channels.
    dtype: working float type (default: the data's, float32 for int16).
    seed_phase: True (what GetTOAs.get_TOAs uses) replaces
    init_params[:, 0] (and [:, 1] when DM is fitted) by the brute seed;
    False keeps the caller's start, as the JAX package's default does
    (required with a template per item).
    nu_outs: optional (nu_DM, nu_GM, nu_tau) output references, each None
    (the zero-covariance frequency), a number or (B,); as in the JAX
    package's fit_portrait_full, nu_GM follows nu_DM when DM is fitted
    (and nu_DM follows nu_GM when only GM is).
    Returns a PortraitFitResult with a leading batch axis.
    """
    return _fit_batch(data_ports, model_ft_ri, init_params, Ps, freqs, errs,
                      weights=weights, nu_fits=nu_fits, fit_flags=fit_flags,
                      log10_tau=log10_tau, max_iter=max_iter, scales=scales,
                      dtype=dtype, seed_phase=seed_phase, nu_outs=nu_outs,
                      scattering=scattering)[0]


def _fit_batch(data_ports, model_ft_ri, init_params, Ps, freqs, errs,
               weights=None, nu_fits=None, fit_flags=(1, 1, 0, 0, 0),
               log10_tau=True, max_iter=100, scales=None, dtype=None,
               seed_phase=True, nu_outs=None, scattering=None, option=0,
               is_toa=True, chan_devices=None, tallies=None):
    """fit_portrait_full_batch's work; also returns the fit's FitSetup and
    the optimizer's NewtonResult (fit_portrait reads its moments).

    chan_devices: the devices of a channel group (parallel.mesh), lead
    first: the channels are cut into as many slabs, each set up and
    reduced on its own device (tallies: a launch tally per slab), and the
    rest of the fit runs on the lead.  model_ft_ri may then also be a dict
    {device: (mr, mi)} holding the template on each device.

    Under a torch profiler the phases are sibling ranges, in order:
    pp:fit.setup, pp:fit.seed, pp:fit.newton (the loop's own ranges
    inside), pp:fit.nu_zeros and pp:fit.finalize.
    """
    with annotate("pp:fit.setup"):
        ff = tuple(int(bool(f)) for f in fit_flags)
        scattering = bool(ff[3] or ff[4]) or bool(scattering)
        log10_tau = bool(log10_tau) and scattering
        devices = [torch.device(d)
                   for d in chan_devices or [data_ports.device]]
        dev = devices[0]
        require_f32_matmul("fit_portrait_full_batch", dev)
        if dtype is None:
            dtype = (torch.float32 if data_ports.dtype == torch.int16
                     else data_ports.dtype)
        if not dtype.is_floating_point:
            raise TypeError(f"fit dtype must be floating, got {dtype}")
        B, nchan, nbin = data_ports.shape

        def as_t(v, d=dev):
            return torch.as_tensor(v, dtype=dtype, device=d)

        if scales is not None:
            if F0_FACT:
                raise ValueError("int16 ingest requires F0_FACT zeroing")
            scales = as_t(scales).expand(B, nchan).contiguous()
        freqs = as_t(freqs)
        if freqs.dim() == 1:
            freqs = freqs.expand(B, nchan)
        freqs = freqs.contiguous()
        Ps = as_t(Ps)
        errs = as_t(errs)
        weights = torch.ones_like(errs) if weights is None else as_t(weights)
        nu_fits = (freqs.mean(dim=-1)[:, None].expand(B, 3) if nu_fits is None
                   else as_t(nu_fits))
        spectra = {}

        def spectrum(d):
            """The template's (mr, mi) on device d."""
            if d not in spectra:
                pair = model_ft_ri[d] if isinstance(model_ft_ri, dict) \
                    else model_ft_ri
                spectra[d] = tuple(as_t(v, d).contiguous() for v in pair)
            return spectra[d]

        mr, mi = spectrum(dev)
        nh = mr.shape[-1]
        per_item = mr.dim() == 3
        if mr.shape != mi.shape or mr.shape[:-1] != ((B, nchan) if per_item
                                                     else (nchan,)):
            raise ValueError(f"model_ft_ri must be (nchan, nh) or (B, nchan, "
                             f"nh) pairs; got {tuple(mr.shape)}, "
                             f"{tuple(mi.shape)} for data "
                             f"{tuple(data_ports.shape)}")
        if per_item and seed_phase:
            raise ValueError("a template per item needs seed_phase=False: the "
                             "brute seed's sums are taken by the setup kernel "
                             "against one shared template")

        errs_FT = errs * math.sqrt(nbin / 2.0)
        w = torch.where(errs_FT > 0.0, errs_FT ** -2.0,
                        torch.zeros_like(errs_FT)) * (weights > 0.0)
        w_seed = None
        if seed_phase:
            hi_mask = (torch.arange(nchan, device=dev) >=
                       nchan // 2).to(dtype)
            w_seed = torch.stack([w, w * hi_mask[None, :]],
                                 dim=-1).contiguous()

        def setup_slab(d, c):
            """The setup of channels c on device d: (Gr, Gi, sd[, gsr, gsi])
            and the slab's M2."""
            x = data_ports[:, c].to(d)
            if scales is None and x.dtype != dtype:
                x = x.to(dtype)
            x = x.contiguous()
            sc = None if scales is None else scales[:, c].to(d).contiguous()
            mr_s, mi_s = (v[..., c, :].contiguous() for v in spectrum(d))
            n = x.shape[1]
            if per_item:
                # the setup takes one template row per channel row: run it as
                # ONE item of B*n channels (whatever B and n are, e.g. 4096
                # single-channel items); its seed sums would then run over the
                # whole batch, so a template per item comes with the caller's
                # start
                out = tuple(t.view(B, n, *t.shape[2:]) for t in fused_setup(
                    x.view(1, B * n, nbin), mr_s.view(B * n, nh),
                    mi_s.view(B * n, nh), f0_fact=bool(F0_FACT),
                    scale=None if sc is None else sc.view(1, B * n)))
            else:
                out = fused_setup(x, mr_s, mi_s, f0_fact=bool(F0_FACT),
                                  w=None if w_seed is None else
                                  w_seed[:, c].to(d).contiguous(), scale=sc)
            return out, mr_s * mr_s + mi_s * mi_s

        bounds = np.cumsum([0] + [len(c) for c in np.array_split(
            np.arange(nchan), len(devices))])
        slabs = []
        for i, d in enumerate(devices):
            with tally(None if tallies is None else tallies[i]):
                slabs.append(setup_slab(d, slice(bounds[i], bounds[i + 1])))
        outs, M2s = zip(*slabs)

        sd = torch.cat([o[2].to(dev) for o in outs], dim=1)
        if len(devices) == 1 and dev == outs[0][0].device:
            Gr, Gi, M2 = outs[0][0], outs[0][1], M2s[0]
            M2_lead = M2
        else:
            tl = tuple(tallies or [None] * len(devices))
            Gr, Gi, M2 = (stats.ChanSlabs(tuple(p), tl) for p in (
                [o[0] for o in outs], [o[1] for o in outs], M2s))
            # the per-channel sums of M2 on the lead, from its own copy of
            # the template: a card's reduction order depends on the shape, so
            # sums over slabs would not be the single-device fit's bits
            M2_lead = mr * mr + mi * mi
        if seed_phase:
            # the band's seed sums, added over the slabs in channel order
            gsr, gsi = (functools.reduce(torch.add,
                                         [o[j].to(dev) for o in outs])
                        for j in (3, 4))
    with annotate("pp:fit.seed"):
        init = as_t(init_params).clone()
        if seed_phase and ff[1]:
            kvec = torch.arange(nh, dtype=dtype, device=dev)
            wcurv = w * torch.sum(M2_lead * kvec * kvec, dim=-1)
            beta = freqs ** -2.0 - (nu_fits[:, 0] ** -2.0)[:, None]
            kdm = DCONST / Ps
            phi0, dm0 = _seed_phi_dm(gsr, gsi, wcurv, beta, kdm)
            init[:, 0] = phi0
            init[:, 1] = dm0
        elif seed_phase:
            init[:, 0] = _brute_phase_seed(gsr[:, 0], gsi[:, 0])
        setup = stats.FitSetup(
            Gr=Gr, Gi=Gi, M2=M2, w=w, freqs=freqs, P=Ps,
            nu_DM=nu_fits[:, 0], nu_GM=nu_fits[:, 1], nu_tau=nu_fits[:, 2],
            Sd=torch.sum(w * sd, dim=-1), S0=torch.sum(M2_lead, dim=-1),
            nbin=int(nbin), sd_chan=w * sd)

    def fgh(xp):
        return stats.chi2_value_grad_hess(xp, setup, fit_flags=ff,
                                          log10_tau=log10_tau,
                                          scattering=scattering)

    with annotate("pp:fit.newton"):
        res = newton.trust_region_minimize(
            fgh, init, max_iter=max_iter, gtol=1e-11, xtol=1e-14,
            has_aux=True, step_mask=ff)
    x, moments, fun = res.x, res.aux, res.fun
    with annotate("pp:fit.nu_zeros"):
        nu_out_DM, nu_out_GM, nu_out_tau = nu_zeros.get_nu_zeros(
            setup, ff, moments, params=x, log10_tau=log10_tau, option=option)
        if nu_outs is not None:
            nu_out_DM, nu_out_GM, nu_out_tau = (
                zero if user is None else as_t(user).expand(B)
                for user, zero in zip(nu_outs, (nu_out_DM, nu_out_GM,
                                                nu_out_tau)))
        if is_toa and ff[1]:
            nu_out_GM = nu_out_DM
        elif is_toa and ff[2]:
            nu_out_DM = nu_out_GM
    with annotate("pp:fit.finalize"):
        params_out = _rereference(x, setup, nu_out_DM, nu_out_GM,
                                  nu_out_tau, log10_tau)
        setup_out = setup._replace(nu_DM=nu_out_DM, nu_GM=nu_out_GM,
                                   nu_tau=nu_out_tau)
        (cov, perrs, scl, scl_errs, channel_snrs, snr, chi2, red_chi2,
         ch_rchi2) = _finalize(params_out, setup_out, ff, fun, moments,
                               log10_tau)
        result = PortraitFitResult(
            params=params_out, param_errs=perrs, scales=scl,
            scale_errs=scl_errs, nu_DM=nu_out_DM, nu_GM=nu_out_GM,
            nu_tau=nu_out_tau, covariance_matrix=cov, chi2=chi2,
            red_chi2=red_chi2, snr=snr, channel_snrs=channel_snrs,
            niter=res.niter, nfeval=res.nfev, return_code=res.status,
            channel_red_chi2=ch_rchi2)
    return result, setup, res


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def fit_portrait_full(data_port, model_port, init_params, P, freqs,
                      nu_fits=(None, None, None), nu_outs=(None, None, None),
                      errs=None, fit_flags=(1, 1, 1, 1, 1), bounds=None,
                      log10_tau=True, option=0, sub_id=None,
                      method="trust-ncg", is_toa=True, quiet=True,
                      scattering=None, device=None, dtype=None):
    """Fit (phi, DM, GM, tau, alpha) of one data portrait (nchan, nbin)
    against one template portrait; returns (PortraitFitResult, duration
    [s] of the solve).

    A B=1 call of the batched fit with a template of its own and the
    caller's start (seed_phase=False), so both APIs share one optimizer.
    As in the JAX package, errs defaults to the data's per-channel noise,
    each nu_fits entry to the mean frequency, scattering to True (tau is
    kept in the model even when not fitted), and `bounds`, `method`,
    `sub_id` and `quiet` are accepted for API compatibility.  device:
    where host inputs go (default: the card; a tensor keeps its own).
    Reference: pptoaslib.py:928-1096.
    """
    data = as_tensor(data_port, device, dtype)
    dev, dt = data.device, data.dtype
    ff = tuple(int(bool(f)) for f in fit_flags)
    scattering = True if scattering is None else bool(scattering)
    freqs = as_tensor(freqs, dev, dt)
    if errs is None:
        errs = noise_PS_profiles(data)
    nu_fit = [freqs.mean() if nf is None else as_tensor(nf, dev, dt)
              for nf in nu_fits]
    mr, mi = template_spectrum(model_port)
    start = time.time()
    res, _, _ = _fit_batch(
        data[None], (mr[None], mi[None]),
        as_tensor(init_params, dev, dt)[None],
        as_tensor(P, dev, dt).reshape(1), freqs[None],
        as_tensor(errs, dev, dt)[None], nu_fits=torch.stack(nu_fit)[None],
        fit_flags=ff, log10_tau=log10_tau, dtype=dt, seed_phase=False,
        nu_outs=tuple(None if n is None else as_tensor(n, dev, dt).reshape(1)
                      for n in nu_outs),
        scattering=scattering, option=option, is_toa=is_toa)
    _sync(dev)
    duration = time.time() - start
    return PortraitFitResult(*[None if v is None else v[0] for v in res]), \
        duration


def fit_portrait(data, model, init_params, P, freqs, nu_fit=None,
                 nu_out=None, errs=None, bounds=None, id=None, quiet=True,
                 device=None, dtype=None):
    """Fit a phase and a DM of one data portrait against one template.

    The 2-parameter API of the JAX package, with its outputs: a DataBunch
    of phase, phase_err, DM, DM_err, scales (at the fit), scale_errs =
    S^-1/2, nu_ref, the phase-DM covariance, chi2, red_chi2, snr,
    duration, nfeval and return_code.  Reference: pplib.py:2102-2204.
    """
    data = as_tensor(data, device, dtype)
    dev, dt = data.device, data.dtype
    freqs = as_tensor(freqs, dev, dt)
    if errs is None:
        errs = noise_PS_profiles(data)
    nu_fit = freqs.mean() if nu_fit is None else as_tensor(nu_fit, dev, dt)
    init5 = torch.zeros(1, 5, dtype=dt, device=dev)
    init5[0, :2] = as_tensor(init_params, dev, dt)[:2]
    mr, mi = template_spectrum(model)
    start = time.time()
    res, _, newton_res = _fit_batch(
        data[None], (mr[None], mi[None]), init5,
        as_tensor(P, dev, dt).reshape(1), freqs[None],
        as_tensor(errs, dev, dt)[None],
        nu_fits=nu_fit.reshape(1, 1).expand(1, 3), fit_flags=(1, 1, 0, 0, 0),
        log10_tau=False, dtype=dt, seed_phase=False,
        nu_outs=(None if nu_out is None else
                 as_tensor(nu_out, dev, dt).reshape(1), None, None),
        scattering=False)
    _sync(dev)
    duration = time.time() - start
    S = newton_res.aux["S"][0]
    scale_errs = torch.where(S > 0.0, torch.where(S > 0.0, S,
                                                  torch.ones_like(S)) ** -0.5,
                             torch.zeros_like(S))
    return DataBunch(phase=res.phi[0], phase_err=res.phi_err[0],
                     DM=res.DM[0], DM_err=res.DM_err[0],
                     scales=res.scales[0], scale_errs=scale_errs,
                     nu_ref=res.nu_DM[0],
                     covariance=res.covariance_matrix[0, 0, 1],
                     chi2=res.chi2[0], red_chi2=res.red_chi2[0],
                     snr=res.snr[0], duration=duration,
                     nfeval=res.nfeval[0], return_code=res.return_code[0])


def polish_phi_dm(data_port, model_port, phi, DM, P, freqs, nu_fit, errs,
                  fit_dm=True):
    """(phi, DM, scales) in float64 after up to two Newton steps on
    the full-band (phi[, DM]) objective of fit_portrait_full (phi and DM
    referenced at nu_fit, no scattering), from a float32 fit's solution.

    The kernels take float32 only, and a float32 fit stops where its
    chi2 rounds (a few hundredths of an error at 4096 x 2048); these
    steps reach the float64 fit's optimum.  Plain torch on data_port's
    device: the float64 rfft, the cross-spectrum and the phase moments
    of fused_setup_reference and phase_moments_reference.  A step is
    taken only where the curvature is positive definite and the step is
    finite and within one error of each parameter (near the optimum the
    change of chi2 is below its rounding, so it cannot judge a step).
    scales: the per-channel amplitudes C/S at the result.
    """
    data = data_port.to(torch.float64)
    dev, dt = data.device, torch.float64
    mr, mi = (torch.as_tensor(v, dtype=dt, device=dev)
              for v in template_spectrum(model_port))
    Gr, Gi, _ = fused_setup_reference(data, mr, mi, f0_fact=bool(F0_FACT))
    S0 = torch.sum(mr * mr + mi * mi, dim=-1)
    freqs = as_tensor(freqs, dev, dt)
    errs_FT = as_tensor(errs, dev, dt) * math.sqrt(data.shape[-1] / 2.0)
    w = torch.where(errs_FT > 0.0, errs_FT ** -2.0,
                    torch.zeros_like(errs_FT))
    si = stats._masked_inv(w * S0, w)
    nu = as_tensor(nu_fit, dev, dt)
    d = phase_shifts_deriv(freqs, nu, nu, float(P))[:1 + int(bool(fit_dm))]

    def moments(x):
        C, Cp, Cpp = phase_moments_reference(x @ d, Gr, Gi)
        return w * C, w * Cp, w * Cpp

    x = torch.tensor([float(phi), float(DM) if fit_dm else 0.0][:len(d)],
                     dtype=dt, device=dev)
    C, Cp, Cpp = moments(x)
    for _ in range(2):       # from a float32 optimum: 1e-2 -> 1e-4 -> 1e-8
        r = C * si
        g = -2.0 * (d @ (r * Cp))
        H = -2.0 * ((d * (r * Cpp + Cp * Cp * si)) @ d.T)
        L, info = torch.linalg.cholesky_ex(H)
        if int(info) != 0:
            break
        step = -torch.cholesky_solve(g[:, None], L)[:, 0]
        # chi2's covariance is 2 H^-1
        err = torch.sqrt(2.0 * torch.diagonal(torch.cholesky_inverse(L)))
        if not bool(torch.all(torch.isfinite(step) &
                              (torch.abs(step) <= err))):
            break
        x = x + step
        C, Cp, Cpp = moments(x)
    scales = C * si
    return float(x[0]), float(x[1]) if fit_dm else float(DM), scales


# PortraitFitResult widths for pack/unpack, in field order; the nchan-wide
# fields are None
_PACK_SIZES = (5, 5, None, None, 1, 1, 1, 25, 1, 1, 1, None, 1, 1, 1,
               None)
_PACK_INT = {12, 13, 14}            # niter, nfeval, return_code


def pack_result(res):
    """A batched PortraitFitResult as ONE (B, K) tensor of the fit's
    dtype, so a chunk's result leaves the card in one transfer; the int
    fields are small counts, exact either way.  Inverse: unpack_result."""
    B = res.params.shape[0]
    dt = res.params.dtype
    with annotate("pp:fit.pack"):
        return torch.cat([leaf.reshape(B, -1).to(dt) for leaf in res],
                         dim=1)


def unpack_result(arr, nchan):
    """A host PortraitFitResult (numpy fields, batch leading) from
    pack_result's (B, K) array (a tensor anywhere, or numpy)."""
    with annotate("pp:fit.unpack"):
        if torch.is_tensor(arr):
            arr = arr.detach().cpu().numpy()
        arr = np.asarray(arr)
        B = arr.shape[0]
        leaves, off = [], 0
        for i, sz in enumerate(_PACK_SIZES):
            n = nchan if sz is None else sz
            leaf = arr[:, off:off + n]
            off += n
            if n == 1:
                leaf = leaf[:, 0]
            elif sz == 25:
                leaf = leaf.reshape(B, 5, 5)
            if i in _PACK_INT:
                leaf = leaf.astype(np.int32)
            leaves.append(leaf)
        if off != arr.shape[1]:
            raise ValueError(f"packed width {arr.shape[1]} is not that of "
                             f"{nchan} channels ({off})")
        return PortraitFitResult(*leaves)


def fit_portrait_full_batch_packed(*args, **kwargs):
    """fit_portrait_full_batch with its result packed (pack_result): one
    device-to-host transfer per chunk.  Unpack with unpack_result."""
    return pack_result(fit_portrait_full_batch(*args, **kwargs))
