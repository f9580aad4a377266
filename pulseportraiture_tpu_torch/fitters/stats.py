"""Sufficient statistics of the wideband likelihood.

Port of pulseportraiture_tpu.fitters.stats.  With the scattering FT
B_k(tau_n) = (1 + 2 pi i k tau_n)^-1 and G = d conj(m):

    chi2'(theta) = -sum_n C_n(theta)^2 / S_n(theta)
    C_n = w_n sum_k Re(G_nk conj(B_nk) e^{2 pi i k phi_n})
    S_n = w_n sum_k |B_nk|^2 |m_nk|^2

scattering=False is the JAX package's static specialization for tau
identically zero (the (phi, DM[, GM]) fit): B = 1, S_n = w_n S0_n, and the
harmonic pass is ops.moments.phase_moments (3 reductions).
scattering=True runs the 9 reductions of ops.moments.scattering_moments
and carries the tau/alpha derivatives (dS != 0) through the gradient,
the Hessian and the covariance.

Every function is batched over leading axes: a FitSetup holds per-item
arrays (..., nchan[, nharm]) and per-item scalars (...,); params are
(..., 5) in the order (phi, DM, GM, tau or log10 tau, alpha).  Harmonics
are in natural order (k = 0..nharm-1).  Reference: pptoaslib.py:390-731.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pulseportraiture_tpu_torch.ops.launches import tally
from pulseportraiture_tpu_torch.ops.transform import (phase_shifts,
                                                      phase_shifts_deriv)

TWO_PI = float(2.0 * np.pi)
LN10 = float(np.log(10.0))
# the scattering reductions, in ops.moments.scattering_moments' order
SCAT_NAMES = ("C", "S", "Cp", "Rf", "S1", "Cpp", "If1", "Rg", "S2")


class FitSetup(NamedTuple):
    """Per-fit constants; leading batch axes on every per-item field."""

    # Gr, Gi and M2 may each be a ChanSlabs (channel-sharded fits): only
    # _moments reads them
    Gr: torch.Tensor      # (..., nchan, nharm) Re[dFT conj(mFT)]
    Gi: torch.Tensor      # (..., nchan, nharm) Im[dFT conj(mFT)]
    M2: torch.Tensor      # (nchan, nharm) or (..., nchan, nharm) |mFT|^2
    w: torch.Tensor       # (..., nchan) 1/errs_FT^2, 0 for dead channels
    freqs: torch.Tensor   # (..., nchan) [MHz]
    P: torch.Tensor       # (...,) period [sec]
    nu_DM: torch.Tensor   # (...,)
    nu_GM: torch.Tensor   # (...,)
    nu_tau: torch.Tensor  # (...,)
    Sd: torch.Tensor      # (...,) sum_n w_n sum_k |dFT|^2
    S0: torch.Tensor      # (nchan,) or (..., nchan) sum_k M2
    nbin: int = 0         # time-domain bins (for dof)
    sd_chan: torch.Tensor = None  # (..., nchan) w_n sum_k |dFT|^2


class ChanSlabs(NamedTuple):
    """A (..., nchan, nharm) spectrum held as channel slabs, each on its own
    device, in channel order (the channel-sharded fit, parallel.mesh).
    tallies: one launch tally per slab (ops.launches.tally), or Nones."""

    parts: tuple
    tallies: tuple


def _per_slab(fn, rows, slabs):
    """fn(*rows_i, *slabs_i) on each slab's device: the per-channel rows
    (..., nchan), on the lead device, are cut at the slabs' widths and
    sent to the slabs; the per-channel outputs come back and are joined
    along channels on the lead device.  Only (..., nchan)-sized operands
    cross devices, never a spectrum."""
    lead = rows[0].device
    outs, c0 = [], 0
    for parts, into in zip(zip(*(s.parts for s in slabs)), slabs[0].tallies):
        dev, n = parts[0].device, parts[0].shape[-2]
        with tally(into):
            out = fn(*(r[..., c0:c0 + n].to(dev) for r in rows), *parts)
        outs.append([o.to(lead) for o in out])
        c0 += n
    return tuple(torch.cat(v, dim=-1) for v in zip(*outs))


def setup_from_reference(fields, kvec=None, device="cpu",
                         dtype=torch.float64):
    """The port's FitSetup from a JAX FitSetup given as numpy arrays.

    fields: mapping with the JAX FitSetup field names (Gr, Gi, M2, w,
    freqs, P, nu_DM, nu_GM, nu_tau, Sd, S0, nbin, sd_chan).  kvec: the
    per-position harmonic numbers of a CT-permuted JAX setup (None for
    natural order); the spectra are put back into natural order.
    """
    Gr = np.asarray(fields["Gr"])
    nh = Gr.shape[-1]
    order = np.arange(nh)
    if kvec is not None:
        kv = np.asarray(kvec).astype(np.int64)
        if kv.shape != (nh,) or not np.array_equal(np.sort(kv), order):
            raise ValueError("kvec must be a permutation of 0..nharm-1")
        order = np.argsort(kv)

    def t(name, harm=False):
        v = fields.get(name)
        if v is None:
            return None
        v = np.array(v)      # a writable copy; keeps 0-d scalars 0-d
        if harm:
            v = v[..., order]
        return torch.as_tensor(v, dtype=dtype, device=device)

    return FitSetup(Gr=t("Gr", True), Gi=t("Gi", True), M2=t("M2", True),
                    w=t("w"), freqs=t("freqs"), P=t("P"), nu_DM=t("nu_DM"),
                    nu_GM=t("nu_GM"), nu_tau=t("nu_tau"), Sd=t("Sd"),
                    S0=t("S0"), nbin=int(fields.get("nbin", 0) or 0),
                    sd_chan=t("sd_chan"))


def _masked_inv(S, w):
    """1/S on live (w > 0) channels with nonzero model power; 0 elsewhere."""
    active = (w > 0.0) & (S != 0.0)
    return torch.where(active, 1.0 / torch.where(S != 0.0, S,
                                                 torch.ones_like(S)),
                       torch.zeros_like(S))


def _phase_trig(phis, k):
    """cos/sin(2 pi phis k) with a trailing harmonic axis appended.

    float32 uses the double-single steps of the JAX package, in the same
    order (round is half-to-even in both): wrap phi to [-0.5, 0.5], split
    a 13-bit hi (a multiple n/8192 of 1/8192, |n| <= 4096) plus a small
    lo, reduce hi*k mod 1 exactly and add lo*k.  hi*k is formed with k
    reduced mod 8192 into [-4096, 4096] (k' = k - 8192 round(k/8192), exact
    in f32 for |k| <= 2^24): hi*k - hi*k' = n round(k/8192) is an integer,
    so the fraction is the same, and |n k'| <= 2^24 keeps hi*k' exact at
    any k.  For |k| <= 4096, k' = k: the JAX steps bit for bit.  Naive f32
    loses ~1e-5 turn at k ~ 2000.  float64 uses the plain product.
    csrc/phase_trig.cuh takes the same steps.
    """
    if phis.dtype == torch.float64:
        ang = TWO_PI * phis[..., None] * k
        return torch.cos(ang), torch.sin(ang)
    p = phis - torch.round(phis)
    hi = torch.round(p * 8192.0) / 8192.0
    lo = p - hi
    kr = k - 8192.0 * torch.round(k * (1.0 / 8192.0))
    prod = hi[..., None] * kr
    frac = prod - torch.round(prod)
    ang = TWO_PI * (frac + lo[..., None] * k)
    return torch.cos(ang), torch.sin(ang)


def _scalar(v):
    """Per-item scalar (...,) -> (..., 1) to broadcast against channels."""
    return v[..., None] if torch.is_tensor(v) else v


def _taus_and_derivs(params, setup, log10_tau):
    """tau_n (..., nchan), dtau (..., 2, nchan), d2tau (..., 2, 2, nchan)
    over (tau or log10 tau, alpha).  Linear tau: the tau derivatives are
    exactly zero at tau == 0, as in the reference.
    Reference: pplib.py:4049-4053, pptoaslib.py:246-274."""
    x_tau, alpha = params[..., 3], params[..., 4]
    tau = _scalar(10.0 ** x_tau if log10_tau else x_tau)
    ratio = setup.freqs / _scalar(setup.nu_tau)
    # guard the log for degenerate references (nu_tau = inf)
    safe = torch.where(ratio > 0.0, ratio, torch.ones_like(ratio))
    lr = torch.log(safe)
    pl = safe ** _scalar(alpha)
    taus = tau * pl
    if log10_tau:
        dtau_t = LN10 * taus
        d2tau_tt = LN10 * dtau_t
        d2tau_ta = LN10 * lr * taus
    else:
        # the reference zeroes these when tau == 0 (pptoaslib.py:251-268)
        zero = torch.zeros_like(taus)
        dtau_t = torch.where(tau == 0.0, zero, pl)
        d2tau_tt = zero
        d2tau_ta = torch.where(tau == 0.0, zero, lr * pl)
    dtau_a = lr * taus
    d2tau_aa = lr * dtau_a
    dtau = torch.stack([dtau_t, dtau_a], dim=-2)
    d2tau = torch.stack([torch.stack([d2tau_tt, d2tau_ta], dim=-2),
                         torch.stack([d2tau_ta, d2tau_aa], dim=-2)], dim=-3)
    return taus, dtau, d2tau


def _moments(params, setup, scattering=False, log10_tau=True):
    """Per-channel harmonic reductions at params (one pass over Gr/Gi).

    scattering=False: C = w sum Re(G P), Cp = -2 pi w sum k Im(G P),
    Cpp = -4 pi^2 w sum k^2 Re(G P) through ops.moments.phase_moments;
    S = w S0.  scattering=True: the 9 reductions C, S, Cp, Rf, S1, Cpp,
    If1, Rg, S2 through ops.moments.scattering_moments (S = w sum
    |B|^2 M2, no S0 shortcut), with taus and their derivatives.  Each
    reduction is the CUDA kernel on the card, its plain twin on the CPU;
    with channel slabs (ChanSlabs) each slab's on its own device.
    """
    from pulseportraiture_tpu_torch.ops.moments import (phase_moments,
                                                        scattering_moments)

    P = _scalar(setup.P)
    phis = phase_shifts(params[..., 0:1], params[..., 1:2],
                        params[..., 2:3], setup.freqs, _scalar(setup.nu_DM),
                        _scalar(setup.nu_GM), P, mod=False)
    w = setup.w
    phis_d = phase_shifts_deriv(setup.freqs, _scalar(setup.nu_DM),
                                _scalar(setup.nu_GM), P)
    sharded = isinstance(setup.Gr, ChanSlabs)
    if not scattering:
        C, Cp, Cpp = (_per_slab(phase_moments, (phis,), (setup.Gr, setup.Gi))
                      if sharded else phase_moments(phis, setup.Gr, setup.Gi))
        return {"phis": phis, "C": w * C, "Cp": w * Cp, "Cpp": w * Cpp,
                "S": w * setup.S0, "phis_d": phis_d}
    taus, dtau, d2tau = _taus_and_derivs(params, setup, log10_tau)
    red = (_per_slab(scattering_moments, (phis, taus),
                     (setup.Gr, setup.Gi, setup.M2)) if sharded else
           scattering_moments(phis, taus, setup.Gr, setup.Gi, setup.M2))
    m = {"phis": phis, "taus": taus, "dtau": dtau, "d2tau": d2tau,
         "phis_d": phis_d}
    for name, v in zip(SCAT_NAMES, red):
        m[name] = w * v
    return m


def _grad_stack(m):
    """(dC, dS) as (..., 5, nchan); dS is None without scattering (it is
    identically zero there).  Reference: pptoaslib.py:399-409, 463-480."""
    dC = m["Cp"][..., None, :] * m["phis_d"]                # (..., 3, n)
    if "dtau" not in m:
        return torch.cat([dC, torch.zeros_like(dC[..., :2, :])],
                         dim=-2), None
    dtau = m["dtau"]
    dS = torch.cat([torch.zeros_like(dC), m["S1"][..., None, :] * dtau],
                   dim=-2)
    dC = torch.cat([dC, m["Rf"][..., None, :] * dtau], dim=-2)
    return dC, dS


def _hess_stacks(m):
    """(d2C, d2S) as (..., 5, 5, nchan): Cpp phis_d_i phis_d_j on the phase
    block (phase second derivatives are zero); with scattering also
    Rg dtau_i dtau_j + Rf d2tau_ij on the (tau, alpha) block, the cross
    block phis_d_i If1 dtau_j, and d2S = S2 dtau_i dtau_j + S1 d2tau_ij.
    d2S is None without scattering.  Reference: pptoaslib.py:411-422,
    482-523."""
    pd = m["phis_d"]
    pp = pd[..., :, None, :] * pd[..., None, :, :]          # (..., 3, 3, n)
    d2C = pp.new_zeros(pp.shape[:-3] + (5, 5, pp.shape[-1]))
    d2C[..., :3, :3, :] = m["Cpp"][..., None, None, :] * pp
    if "dtau" not in m:
        return d2C, None
    dtau, d2tau = m["dtau"], m["d2tau"]
    tt = dtau[..., :, None, :] * dtau[..., None, :, :]      # (..., 2, 2, n)
    d2C[..., 3:, 3:, :] = (m["Rg"][..., None, None, :] * tt +
                           m["Rf"][..., None, None, :] * d2tau)
    cross = pd[..., :, None, :] * \
        (m["If1"][..., None, :] * dtau)[..., None, :, :]   # (..., 3, 2, n)
    d2C[..., :3, 3:, :] = cross
    d2C[..., 3:, :3, :] = cross.transpose(-3, -2)
    d2S = torch.zeros_like(d2C)
    d2S[..., 3:, 3:, :] = (m["S2"][..., None, None, :] * tt +
                           m["S1"][..., None, None, :] * d2tau)
    return d2C, d2S


def _flags(fit_flags, like):
    return torch.as_tensor(fit_flags, dtype=like.dtype, device=like.device)


def _per_channel_hess(m, setup, dC, dS):
    """Amplitude-profiled per-channel Hessian (..., 5, 5, nchan):
    -2 [r d2C - r^2 d2S / 2 + dC_i dC_j / S + r^2 dS_i dS_j / S
    - r (dC_i dS_j + dS_i dC_j) / S], r = C/S (dS terms only with
    scattering).  Reference: pptoaslib.py:576-643."""
    C, S = m["C"], m["S"]
    si = _masked_inv(S, setup.w)
    r = (C * si)[..., None, None, :]
    si = si[..., None, None, :]
    d2C, d2S = _hess_stacks(m)
    dCi_dCj = dC[..., :, None, :] * dC[..., None, :, :]
    if dS is None:
        return -2.0 * (r * d2C + dCi_dCj * si)
    dSi_dSj = dS[..., :, None, :] * dS[..., None, :, :]
    dC_dS = dC[..., :, None, :] * dS[..., None, :, :] + \
        dS[..., :, None, :] * dC[..., None, :, :]
    return -2.0 * (r * d2C - 0.5 * r * r * d2S + dCi_dCj * si
                   + r * r * dSi_dSj * si - r * dC_dS * si)


def chi2_value_grad_hess(params, setup, fit_flags=(1, 1, 1, 1, 1),
                         log10_tau=True, scattering=False):
    """(chi2', gradient (..., 5), Hessian (..., 5, 5), moments).

    Rows/cols of non-fitted parameters are masked to zero (gradient) /
    identity (Hessian).  Reference: pptoaslib.py:544-643.
    """
    m = _moments(params, setup, scattering=scattering, log10_tau=log10_tau)
    C, S = m["C"], m["S"]
    si = _masked_inv(S, setup.w)
    r = C * si
    f = -torch.sum(C * r, dim=-1)
    dC, dS = _grad_stack(m)
    flags = _flags(fit_flags, C)
    gn = 2.0 * r[..., None, :] * dC
    if dS is not None:
        gn = gn - (r * r)[..., None, :] * dS
    g = -torch.sum(gn, dim=-1) * flags
    H = torch.sum(_per_channel_hess(m, setup, dC, dS), dim=-1)
    fo = flags[:, None] * flags[None, :]
    H = H * fo + torch.diag(1.0 - flags)
    return f, g, H, m


def hess_per_channel_from_moments(m, setup, fit_flags=(1, 1, 1, 1, 1)):
    """Per-channel amplitude-profiled Hessian (..., 5, 5, nchan) from a
    moments dict (no pass over the spectra)."""
    Hn = _per_channel_hess(m, setup, *_grad_stack(m))
    flags = _flags(fit_flags, Hn)
    return Hn * (flags[:, None] * flags[None, :])[..., None]


def rebase_moments(m, setup_out, params_out=None, log10_tau=True):
    """Moments re-parameterized at the output references.

    Re-referencing keeps every physical per-channel phase and tau, so the
    harmonic reductions stay valid; only the chain-rule factors change:
    phis_d, and with scattering taus/dtau/d2tau at params_out (whose tau
    is the one transported to setup_out.nu_tau).  pptoaslib.py:1052-1065.
    """
    out = dict(m)
    out["phis_d"] = phase_shifts_deriv(setup_out.freqs,
                                       _scalar(setup_out.nu_DM),
                                       _scalar(setup_out.nu_GM),
                                       _scalar(setup_out.P))
    if "dtau" in m:
        taus, dtau, d2tau = _taus_and_derivs(params_out, setup_out,
                                             log10_tau)
        out.update(taus=taus, dtau=dtau, d2tau=d2tau)
    return out


def get_scales(params, setup, log10_tau=True, scattering=False):
    """ML per-channel amplitudes a_n = C_n/S_n, and S_n (pptoaslib.py:908)."""
    m = _moments(params, setup, scattering=scattering, log10_tau=log10_tau)
    si = _masked_inv(m["S"], setup.w)
    return m["C"] * si, m["S"]


def _covariance_core(m, setup, fit_flags):
    """(param_cov, param_errs, scales, scale_errs, S) by the Woodbury/LDU
    identity: the amplitude block is diagonal (2 S_n), so only a 5x5
    solve per item.  Reference: pptoaslib.py:645-731."""
    C, S = m["C"], m["S"]
    si = _masked_inv(S, setup.w)
    r = C * si
    dC, dS = _grad_stack(m)
    d2C, d2S = _hess_stacks(m)
    flags = _flags(fit_flags, C)
    fo = flags[:, None] * flags[None, :]
    # unprofiled fit-parameter block, amplitudes explicit
    An = r[..., None, None, :] * d2C
    if d2S is not None:
        An = An - 0.5 * (r * r)[..., None, None, :] * d2S
    A = torch.sum(-2.0 * An, dim=-1) * fo
    A = A + torch.diag(1.0 - flags)
    # cross block U_{j,n} = -2 (dC_j - a_n dS_j), masked
    Ud = dC if dS is None else dC - r[..., None, :] * dS
    U = -2.0 * Ud * flags[:, None]                        # (..., 5, n)
    c_inv = si / 2.0
    X = A - (U * c_inv[..., None, :]) @ U.transpose(-1, -2)
    # a singular X (e.g. linear tau fitted at tau == 0, where the tau
    # derivatives vanish) gives a NaN covariance for that item, as the
    # JAX package's inverse gives non-finite values, instead of raising
    X_inv, info = torch.linalg.inv_ex(X)
    X_inv = torch.where((info == 0)[..., None, None], X_inv,
                        torch.full_like(X_inv, float("nan")))
    param_cov = 2.0 * X_inv * fo
    param_errs = torch.sqrt(torch.clamp(
        torch.diagonal(param_cov, dim1=-2, dim2=-1), min=0.0))
    UXU = torch.einsum("...in,...ij,...jn->...n", U, X_inv, U)
    scale_vars = 2.0 * (c_inv + c_inv * c_inv * UXU)
    scale_errs = torch.sqrt(torch.clamp(scale_vars, min=0.0))
    return param_cov, param_errs, r, scale_errs, S
