"""Sufficient statistics of the wideband likelihood, no-scattering subset.

Port of pulseportraiture_tpu.fitters.stats for the (phi, DM[, GM]) fit
with tau identically zero (the JAX `scattering=False` specialization):

    chi2'(theta) = -sum_n C_n(theta)^2 / S_n,   S_n = w_n sum_k |m_nk|^2
    C_n = w_n sum_k Re(G_nk e^{2 pi i k phi_n}),  G = d conj(m)

Every function is batched over leading axes: a FitSetup holds per-item
arrays (..., nchan[, nharm]) and per-item scalars (...,); params are
(..., 5) in the order (phi, DM, GM, tau, alpha).  Harmonics are in
natural order (k = 0..nharm-1).  Reference: pptoaslib.py:390-731.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pulseportraiture_tpu_torch.ops.transform import (phase_shifts,
                                                      phase_shifts_deriv)

TWO_PI = float(2.0 * np.pi)


class FitSetup(NamedTuple):
    """Per-fit constants; leading batch axes on every per-item field."""

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
    a 13-bit hi (hi*k exact in f32 while k <= 2^12) plus a small lo,
    reduce hi*k mod 1 exactly and add lo*k.  Naive f32 loses ~1e-5 turn
    at k ~ 2000.  float64 uses the plain product.
    """
    if phis.dtype == torch.float64:
        ang = TWO_PI * phis[..., None] * k
        return torch.cos(ang), torch.sin(ang)
    p = phis - torch.round(phis)
    hi = torch.round(p * 8192.0) / 8192.0
    lo = p - hi
    prod = hi[..., None] * k
    frac = prod - torch.round(prod)
    ang = TWO_PI * (frac + lo[..., None] * k)
    return torch.cos(ang), torch.sin(ang)


def _scalar(v):
    """Per-item scalar (...,) -> (..., 1) to broadcast against channels."""
    return v[..., None] if torch.is_tensor(v) else v


def _moments(params, setup):
    """Per-channel harmonic reductions at params (one pass over Gr/Gi).

    C = w sum Re(G P), Cp = -2 pi w sum k Im(G P), Cpp = -4 pi^2 w sum
    k^2 Re(G P) through ops.moments.phase_moments (the CUDA kernel on
    the card, its plain twin on the CPU); S = w S0.
    """
    from pulseportraiture_tpu_torch.ops.moments import phase_moments

    P = _scalar(setup.P)
    phis = phase_shifts(params[..., 0:1], params[..., 1:2],
                        params[..., 2:3], setup.freqs, _scalar(setup.nu_DM),
                        _scalar(setup.nu_GM), P, mod=False)
    C, Cp, Cpp = phase_moments(phis, setup.Gr, setup.Gi)
    w = setup.w
    phis_d = phase_shifts_deriv(setup.freqs, _scalar(setup.nu_DM),
                                _scalar(setup.nu_GM), P)
    return {"phis": phis, "C": w * C, "Cp": w * Cp, "Cpp": w * Cpp,
            "S": w * setup.S0, "phis_d": phis_d}


def _grad_stack(m):
    """dC as (..., 5, nchan); dS is identically zero without scattering."""
    dC = m["Cp"][..., None, :] * m["phis_d"]                # (..., 3, n)
    return torch.cat([dC, torch.zeros_like(dC[..., :2, :])], dim=-2)


def _hess_stack(m):
    """d2C as (..., 5, 5, nchan): Cpp phis_d_i phis_d_j on the phase
    block (phase second derivatives are zero), zero elsewhere."""
    pd = m["phis_d"]
    pp = pd[..., :, None, :] * pd[..., None, :, :]          # (..., 3, 3, n)
    d2C = pp.new_zeros(pp.shape[:-3] + (5, 5, pp.shape[-1]))
    d2C[..., :3, :3, :] = m["Cpp"][..., None, None, :] * pp
    return d2C


def _flags(fit_flags, like):
    return torch.as_tensor(fit_flags, dtype=like.dtype, device=like.device)


def _per_channel_hess(m, setup, dC):
    """Amplitude-profiled per-channel Hessian (..., 5, 5, nchan)."""
    C, S = m["C"], m["S"]
    si = _masked_inv(S, setup.w)
    r = C * si
    d2C = _hess_stack(m)
    dCi_dCj = dC[..., :, None, :] * dC[..., None, :, :]
    return -2.0 * (r[..., None, None, :] * d2C +
                   dCi_dCj * si[..., None, None, :])


def chi2_value_grad_hess(params, setup, fit_flags=(1, 1, 1, 1, 1)):
    """(chi2', gradient (..., 5), Hessian (..., 5, 5), moments).

    Rows/cols of non-fitted parameters are masked to zero (gradient) /
    identity (Hessian).  Reference: pptoaslib.py:544-643.
    """
    m = _moments(params, setup)
    C, S = m["C"], m["S"]
    si = _masked_inv(S, setup.w)
    r = C * si
    f = -torch.sum(C * r, dim=-1)
    dC = _grad_stack(m)
    flags = _flags(fit_flags, C)
    g = -torch.sum(2.0 * r[..., None, :] * dC, dim=-1) * flags
    H = torch.sum(_per_channel_hess(m, setup, dC), dim=-1)
    fo = flags[:, None] * flags[None, :]
    H = H * fo + torch.diag(1.0 - flags)
    return f, g, H, m


def hess_per_channel_from_moments(m, setup, fit_flags=(1, 1, 1, 1, 1)):
    """Per-channel amplitude-profiled Hessian (..., 5, 5, nchan) from a
    moments dict (no pass over the spectra)."""
    Hn = _per_channel_hess(m, setup, _grad_stack(m))
    flags = _flags(fit_flags, Hn)
    return Hn * (flags[:, None] * flags[None, :])[..., None]


def rebase_moments(m, setup_out):
    """Moments re-parameterized at the output references.

    Re-referencing keeps every physical per-channel phase, so the
    harmonic reductions stay valid; only the chain-rule factors phis_d
    change (pptoaslib.py:1052-1065)."""
    out = dict(m)
    out["phis_d"] = phase_shifts_deriv(setup_out.freqs,
                                       _scalar(setup_out.nu_DM),
                                       _scalar(setup_out.nu_GM),
                                       _scalar(setup_out.P))
    return out


def get_scales(params, setup):
    """ML per-channel amplitudes a_n = C_n/S_n, and S_n (pptoaslib.py:908)."""
    m = _moments(params, setup)
    si = _masked_inv(m["S"], setup.w)
    return m["C"] * si, m["S"]


def _covariance_core(m, setup, fit_flags):
    """(param_cov, param_errs, scales, scale_errs, S) by the Woodbury/LDU
    identity: the amplitude block is diagonal (2 S_n), so only a 5x5
    solve per item.  Reference: pptoaslib.py:645-731."""
    C, S = m["C"], m["S"]
    si = _masked_inv(S, setup.w)
    r = C * si
    dC = _grad_stack(m)
    d2C = _hess_stack(m)
    flags = _flags(fit_flags, C)
    fo = flags[:, None] * flags[None, :]
    A = torch.sum(-2.0 * (r[..., None, None, :] * d2C), dim=-1) * fo
    A = A + torch.diag(1.0 - flags)
    U = -2.0 * dC * flags[:, None]                        # (..., 5, n)
    c_inv = si / 2.0
    X = A - (U * c_inv[..., None, :]) @ U.transpose(-1, -2)
    X_inv = torch.linalg.inv(X)
    param_cov = 2.0 * X_inv * fo
    param_errs = torch.sqrt(torch.clamp(
        torch.diagonal(param_cov, dim1=-2, dim2=-1), min=0.0))
    UXU = torch.einsum("...in,...ij,...jn->...n", U, X_inv, U)
    scale_vars = 2.0 * (c_inv + c_inv * c_inv * UXU)
    scale_errs = torch.sqrt(torch.clamp(scale_vars, min=0.0))
    return param_cov, param_errs, r, scale_errs, S
