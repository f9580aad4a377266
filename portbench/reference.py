"""The plain reference of the wideband portrait fit, in plain PyTorch.

It imports nothing of the program and takes nothing the program made:
from the int16 data, their scales, the template spectrum and the fit's
settings it forms the data spectrum by a matrix product with the DFT
matrix, the cross-spectrum G = X conj(m), and the profiled chi2 of
PulsePortraiture (Pennucci, Demorest & Ransom 2014, ApJ 790, 93), with
the per-channel amplitudes solved out:

    chi2(theta) = Sd - sum_n C_n^2 / S_n
    C_n = w_n sum_k Re(G_nk conj(B_nk) e^{2 pi i k phi_n})
    S_n = w_n sum_k |B_nk|^2 |m_nk|^2
    phi_n = phi + (D/P) DM (nu_n^-2 - nu_ref^-2)
    B_nk = (1 + 2 pi i k tau_n)^-1, tau_n = 10^x (nu_n / nu_tau)^alpha

with w_n = 1 / (sigma_n^2 nbin / 2), Sd = sum_n w_n sum_{k>=1} |X_nk|^2
(by Parseval's theorem) and the DC harmonic left out.  Newton steps on the gradient and Hessian
that autograd takes of chi2, from the injected parameters, reach the
minimum; the covariance is twice the inverse Hessian of the profiled
chi2 (the amplitudes marginalized); the outputs move to the frequencies
at which phi and DM (and log10 tau and alpha) do not covary, where the
fit reports them.

precision="float64" is the reference.  precision="tf32" is the control:
the same steps in float32 with the matrix products taken in TF32 (their
inputs rounded to TF32's 10-bit mantissa, products and sums in float32,
as the tensor cores take them), the precision below the configuration's
float32.  precision="float32" (the same steps in plain float32) is a
witness of what float32 arithmetic alone does to each number.
"""

import math

import torch

# rows of the data spectrum's matrix product at a time; Newton steps at
# most; items fitted together
BLOCK_ROWS, MAX_ITERS, CHUNK = 16384, 30, 32


def tf32_round(t):
    """float32 values rounded to TF32's 10-bit mantissa (to nearest)."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def spectrum(x, scales, nh, precision):
    """(Xr, Xi) over k < nh and sd = sum_{k=1}^{nbin/2} |X_k|^2: the data
    spectrum of each row of x (rows, nbin) int16 times its scale, by a
    matrix product with the DFT matrix's first nh columns, and sd by
    Parseval's theorem, (nbin sum x^2 - X_0^2 + X_{nbin/2}^2) / 2."""
    rows, nbin = x.shape
    dt = torch.float64 if precision == "float64" else torch.float32
    j = torch.arange(nbin, dtype=torch.int64, device=x.device)
    k = torch.arange(nh, dtype=torch.int64, device=x.device)
    ang = torch.remainder(j[:, None] * k[None, :], nbin).double() * (
        2 * math.pi / nbin)
    E = torch.cat([torch.cos(ang), -torch.sin(ang)], dim=1).to(dt)
    alt = (1 - 2 * (j % 2)).to(dt)
    if precision == "tf32":
        E = tf32_round(E)
    Xr = torch.empty((rows, nh), dtype=dt, device=x.device)
    Xi = torch.empty_like(Xr)
    sd = torch.empty(rows, dtype=dt, device=x.device)
    for i in range(0, rows, BLOCK_ROWS):
        blk = slice(i, i + BLOCK_ROWS)
        xb = x[blk].to(dt)
        if precision == "tf32":
            xb = tf32_round(xb)
        sc = scales[blk, None].to(dt)
        X = (xb @ E) * sc
        Xr[blk], Xi[blk] = X[:, :nh], X[:, nh:]
        xs = xb * sc
        sd[blk] = 0.5 * (nbin * (xs * xs).sum(-1) -
                                 xs.sum(-1) ** 2 + (xs @ alt) ** 2)
    return Xr, Xi, sd


def _chi2(theta, fixed, fitted, Gr, Gi, M2, w, nu, kdm, nu_ref, nu_tau,
          scattering):
    """-sum_n C_n^2 / S_n (b,) of b items at their fitted parameters
    theta (b, nfit); fixed (b, 5) holds the others; Gr, Gi (b, nchan,
    nh); M2 (nchan, nh); w, nu (nchan,)."""
    cols, j = [], 0
    for i, f in enumerate(fitted):
        cols.append(theta[:, j] if f else fixed[:, i])
        j += int(f)
    phi, dm, x, alpha = (c[:, None] for c in (cols[0], cols[1], cols[3],
                                              cols[4]))
    phin = phi + kdm * dm * (nu ** -2.0 - nu_ref ** -2.0)
    phin = phin - torch.round(phin).detach()
    k = torch.arange(Gr.shape[-1], dtype=Gr.dtype, device=Gr.device)
    ang = (2 * math.pi) * phin[..., None] * k
    c, s = torch.cos(ang), torch.sin(ang)
    if scattering:
        a = (2 * math.pi) * k * (10.0 ** x * (nu / nu_tau) ** alpha)[..., None]
        br = 1.0 / (1.0 + a * a)
        bi = a * br
        hr, hi = Gr * br - Gi * bi, Gr * bi + Gi * br
        C = w * (hr * c - hi * s).sum(-1)
        S = w * (M2 * br).sum(-1)
    else:
        C = w * (Gr * c - Gi * s).sum(-1)
        S = (w * M2.sum(-1)).expand_as(C)
    live = (w > 0) & (S > 0)
    q = C * C / torch.where(live, S, torch.ones_like(S))
    return -torch.where(live, q, torch.zeros_like(q)).sum(-1)


def _fgh(f, theta):
    """f(theta) (b,), its gradient (b, n) and Hessian (b, n, n) by
    autograd; the items are independent, so one backward pass a
    parameter gives a row of every item's Hessian."""
    theta = theta.detach().requires_grad_(True)
    val = f(theta)
    g, = torch.autograd.grad(val.sum(), theta, create_graph=True)
    H = torch.stack([torch.autograd.grad(g[:, p].sum(), theta,
                                         retain_graph=True)[0]
                     for p in range(theta.shape[1])], dim=1)
    return val.detach(), g.detach(), H.detach()


class Fit:
    """Reference results of a batch: params (B, 5) [phi, DM, GM, log10 tau,
    alpha] at the output references, errs (B, 5), cov (B, 5, 5), nu_DM,
    nu_tau, red_chi2 (B,), and the most Newton steps a chunk of items
    took."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def fit(x, scales, mr, mi, nu, errs, P, nu_fit, start, fit_flags, dconst,
        precision="float64"):
    """The reference fit of each item of x (B, nchan, nbin) int16 with
    scales (B, nchan), the template spectrum (mr, mi) (nchan, nh), errs
    (nchan,) the noise a sample, references nu_fit [MHz] for phi, DM and
    tau, started at start (B, 5).  fit_flags: (1,1,0,0,0) or
    (1,1,0,1,1)."""
    ff = tuple(int(bool(f)) for f in fit_flags)
    if ff not in ((1, 1, 0, 0, 0), (1, 1, 0, 1, 1)):
        raise ValueError(f"the reference fits (1,1,0,0,0) or (1,1,0,1,1), "
                         f"not {ff}")
    scattering = ff[3] == 1
    B, nchan, nbin = x.shape
    nh = mr.shape[-1]
    dt = torch.float64 if precision == "float64" else torch.float32
    dev = x.device
    Xr, Xi, sd = spectrum(x.reshape(B * nchan, nbin),
                          scales.reshape(-1), nh, precision)
    Xr, Xi, sd = (t.view(B, nchan, -1).squeeze(-1) for t in (Xr, Xi, sd))
    mr, mi = mr.to(dt), mi.to(dt)
    Gr, Gi = Xr * mr + Xi * mi, Xi * mr - Xr * mi
    Gr[..., 0] = 0.0
    Gi[..., 0] = 0.0
    M2 = (mr * mr + mi * mi)
    M2[:, 0] = 0.0
    nu = nu.to(dt)
    w = (1.0 / (errs.to(dt) ** 2 * (nbin / 2.0))).expand(nchan)
    kdm = dconst / P
    fitted = torch.tensor([bool(f) for f in ff], device=dev)
    nf = int(fitted.sum())
    kdm_t, nu_t = (torch.tensor(v, dtype=dt, device=dev)
                   for v in (kdm, nu_fit))

    def f_items(fixed, gr, gi):
        return lambda theta: _chi2(theta, fixed, ff, gr, gi, M2, w, nu,
                                   kdm_t, nu_t, nu_t, scattering)

    # Newton stops once no item's step is above tol of its sigma
    tol = 1e-6 if precision == "float64" else 1e-3
    out = {n: [] for n in ("params", "cov", "fun")}
    most = 0
    for i in range(0, B, CHUNK):
        sl = slice(i, min(i + CHUNK, B))
        fixed = start[sl].to(dt).clone()
        theta = fixed[:, fitted].clone()
        fn = f_items(fixed, Gr[sl], Gi[sl])
        for it in range(MAX_ITERS):
            f, g, H = _fgh(fn, theta)
            # Newton's step, along |eigenvalues| where H is not positive
            lam_h, V = torch.linalg.eigh(H)
            step = -(V @ ((V.transpose(1, 2) @ g[..., None])[..., 0] /
                          lam_h.abs())[..., None])[..., 0]
            sig = torch.sqrt(2.0 * ((V * V) / lam_h.abs()[:, None, :])
                             .sum(-1))
            moved = (step.abs() / sig).amax(-1)
            if float(moved.max()) < tol:
                break
            # a step of more than half a sigma is halved until chi2
            # falls; a shorter one lies in the quadratic bowl, where
            # chi2's rounding could not tell a better point from a worse
            far = moved > 0.5
            lam = torch.ones_like(f)
            take = torch.ones_like(far)
            if bool(far.any()):
                for _ in range(30):
                    with torch.no_grad():
                        fc = fn(theta + lam[:, None] * step)
                    worse = far & (fc > f)
                    if not bool(worse.any()):
                        break
                    lam = torch.where(worse, 0.5 * lam, lam)
                take = ~worse
            theta = torch.where(take[:, None], theta + lam[:, None] * step,
                                theta)
        most = max(most, it)
        f, g, H = _fgh(fn, theta)
        cov = 2.0 * torch.linalg.inv(H)
        p = fixed
        p[:, fitted] = theta
        full = torch.zeros((p.shape[0], 5, 5), dtype=dt, device=dev)
        idx = torch.nonzero(fitted)[:, 0]
        full[:, idx[:, None], idx[None, :]] = cov
        out["params"].append(p)
        out["cov"].append(full)
        out["fun"].append(f)
    p, cov, fun = (torch.cat(out[n]) for n in ("params", "cov", "fun"))
    # move phi to nu_DM and log10 tau to nu_tau, where they stop covarying
    J = torch.eye(5, dtype=dt, device=dev).repeat(B, 1, 1)
    inv2 = nu_fit ** -2.0 - cov[:, 0, 1] / (kdm * cov[:, 1, 1])
    J[:, 0, 1] = kdm * (inv2 - nu_fit ** -2.0)
    nu_DM = inv2 ** -0.5
    nu_tau = torch.full_like(nu_DM, nu_fit)
    if scattering:
        L = -cov[:, 3, 4] / cov[:, 4, 4]
        J[:, 3, 4] = L
        nu_tau = nu_fit * 10.0 ** L
    params = (J @ p[..., None])[..., 0]
    params[:, 0] = params[:, 0] - torch.round(params[:, 0])
    cov = J @ cov @ J.transpose(1, 2)
    errs_out = torch.sqrt(torch.diagonal(cov, dim1=-2, dim2=-1))
    Sd = (w * sd).sum(-1)
    dof = nchan * nbin - (nf + nchan)
    return Fit(params=params, errs=errs_out, cov=cov, nu_DM=nu_DM,
               nu_tau=nu_tau, red_chi2=(Sd + fun) / dof,
               iters=most)
