"""Batched trust-region Newton minimizer with exact Hessians.

Port of pulseportraiture_tpu.fitters.newton.  The JAX package runs
vmap(lax.while_loop): every item steps while any item is active, and an
item whose loop condition is false keeps its state.  Here that is an
explicit loop over a leading batch axis: fgh is evaluated for the whole
batch each iteration, and finished items are frozen (x, f, g, H, aux, it,
nfev and status stop changing) by masked selects.  The host syncs once
per iteration, on "all done".  Under a torch profiler each iteration is
a "pp:newton.iter" range holding its objective ("pp:newton.fgh") and
its two subproblem solves ("pp:newton.solve"); the first objective is a
"pp:newton.fgh" of its own (profiling.annotate).

The subproblem is solved exactly (Moré–Sorensen on the <=5x5 Hessian,
ops.tr_solve): on the card one hand-written kernel a solve
(csrc/tr_solve.cu: cyclic Jacobi and the secular iteration in float64,
one thread an item), on the CPU its plain twin (batched
torch.linalg.eigh).  Carried over unchanged: the f32 acceptance
floor 8 eps |f|, the radius shrink on a non-finite trial, the speculative
final step bounded by the last verified step length, the step_mask
projection and the status codes.

Additions, which bind in float32 only (float64 runs stop where the JAX
package's stop):
- the subproblem is solved in float64 whatever the working dtype
  (_tr_solve);
- the rounding-level stops (the relative gradient test 100 eps |g0|,
  the sub-floor decrease 8 eps |f| and the speculative step) wait for
  the Newton decrement g H^-1 g at the accepted point to be <= DEC_TOL,
  or for a full (interior) step that failed to halve it at the floor
  that the working precision sets: within FLOOR_K times the decrement
  that rounding of g and x allows (_newton_decrement; float64 keeps
  the rule "failed to halve it" wherever the decrement is).  Those stops are
  set by the resolution of f and by the stiffest parameter, not by the
  parameters' scales: in float32 they end a 4096-channel scattering fit
  several sigma short of the optimum in tau and alpha.  The decrement is
  in f's units, chi2 for the fits, so DEC_TOL bounds the distance to the
  optimum, sqrt(DEC_TOL / 2) = 7e-4 sigma, whatever the scales.  A
  float32 Hessian that misses a weak direction makes Newton converge
  linearly (the decrement falls by a steady 40% a step on a linear-tau
  fit): far above the floor that is not a stall, and halving alone
  stopped it 0.77 sigma short;
- below the resolution of f the ratio rho is noise, so after such a step
  the radius is at least twice the Newton step (the item goes on by full
  Newton steps, not by a radius-limited walk), and where the Hessian is
  indefinite a step to the boundary doubles the radius instead of
  letting rho collapse it to xtol;
- the subproblem takes Moré–Sorensen's hard case: negative curvature
  that g barely sees gets the rest of the radius along the lowest
  eigenvector, so a saddle that is flat to f's rounding is left.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from pulseportraiture_tpu_torch.ops.tr_solve import _mv, tr_solve
from pulseportraiture_tpu_torch.profiling import annotate

DEC_TOL = 1e-6
FLOOR_K = 4.0

RCSTRINGS = {
    0: "Converged (gradient norm below tolerance)",
    1: "Converged (function decrease below ftol)",
    2: "Converged (step size / trust radius below xtol)",
    3: "Maximum number of iterations reached",
}


class NewtonResult(NamedTuple):
    x: torch.Tensor
    fun: torch.Tensor
    grad: torch.Tensor
    hess: torch.Tensor
    niter: torch.Tensor
    nfev: torch.Tensor
    status: torch.Tensor  # 0 grad, 1 fconv, 2 xconv, 3 maxiter
    success: torch.Tensor
    aux: object = None    # fgh aux at x (has_aux=True only)


# the exact trust-region step and whether it is not interior (p, hit)
_tr_solve = tr_solve


def _newton_decrement(g, H, mask, floor_of=None):
    """(g H^-1 g, |H^-1 g|) of the full Newton step, (B,) float64: a
    float64 Cholesky solve, which the parameters' scales do not
    condition; inf where H is not positive definite.  floor_of=(f, x,
    eps): also the decrement that rounding at relative eps leaves, the
    sum over the parameters i of eps^2 |H_ii| (|f| (H^-1)_ii + x_i^2):
    g_i is a sum of residual x derivative terms, whose rounding is of
    the order of eps sqrt(|f| |H_ii|) (Cauchy-Schwarz), and x_i is held to eps
    |x_i|."""
    g64, H64 = g.double(), H.double()
    L, info = torch.linalg.cholesky_ex(H64)
    p = torch.cholesky_solve(g64[..., None], L)[..., 0]
    if mask is not None:
        p = p * mask.double()
    dec = torch.sum(g64 * p, dim=-1)
    ok = (info == 0) & torch.isfinite(dec)
    inf = torch.full_like(dec, math.inf)
    out = (torch.where(ok, dec, inf),
           torch.where(ok, torch.sqrt(torch.sum(p * p, dim=-1)), inf))
    if floor_of is None:
        return out
    f, x, eps = floor_of
    Hinv = torch.cholesky_inverse(L)
    w = torch.abs(torch.diagonal(H64, dim1=-2, dim2=-1)) * (
        torch.abs(f.double())[..., None] *
        torch.diagonal(Hinv, dim1=-2, dim2=-1) + x.double() ** 2)
    if mask is not None:
        w = w * mask.double()
    return out + (torch.where(ok, eps * eps * torch.sum(w, dim=-1), 0.0),)


def _select(mask, a, b):
    """Per-item select broadcasting a (B,) mask over trailing axes."""
    m = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
    return torch.where(m, a, b)


def _select_aux(mask, a, b):
    if isinstance(a, dict):
        return {k: _select_aux(mask, a[k], b[k]) for k in a}
    return _select(mask, a, b)


def trust_region_minimize(fgh: Callable, x0, max_iter: int = 100,
                          gtol: float = 1e-10, xtol: float = 1e-12,
                          ftol: float = 0.0, init_radius: float = 1.0,
                          max_radius: float = 1e3, has_aux: bool = False,
                          step_mask=None):
    """Minimize f for every item of a batch via exact trust-region Newton.

    x0: (B, n).  fgh(x) -> (f (B,), g (B, n), H (B, n, n)[, aux]) with
    analytic derivatives; non-fitted parameters must already be masked
    inside fgh (zero gradient row, identity Hessian row/col).  step_mask:
    optional (n,) 0/1 projection that pins masked coordinates through the
    subproblem solve regardless of eigenvector rounding.  has_aux: aux is
    a (nested) dict of tensors with a leading batch axis, carried for the
    accepted point.
    """
    with annotate("pp:newton.fgh"):
        out = fgh(x0)
    f0, g0, H0 = out[:3]
    aux = out[3] if has_aux else None
    dtype, dev = f0.dtype, f0.device
    B = x0.shape[0]
    feps = torch.finfo(dtype).eps
    g0norm = torch.sqrt(torch.sum(g0 ** 2, dim=-1))
    gtol_rel = 100.0 * feps
    mask = None if step_mask is None else torch.as_tensor(
        step_mask, dtype=dtype, device=dev)

    x, f, g, H = x0, f0, g0, H0
    radius = torch.full((B,), float(init_radius), dtype=dtype, device=dev)
    it = torch.zeros(B, dtype=torch.int64, device=dev)
    nfev = torch.ones(B, dtype=torch.int64, device=dev)
    status = torch.full((B,), 3, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    tiny = torch.full((), 1e-300, dtype=dtype, device=dev)  # 0 in f32
    low = feps > 1e-10      # float32 objective: the rules below bind
    dec = torch.full((B,), math.inf, dtype=torch.float64, device=dev)

    while True:
        active = (~done) & (it < max_iter)
        if not bool(active.any()):
            break
        with annotate("pp:newton.iter"):
            with annotate("pp:newton.solve"):
                p, hit = _tr_solve(g, H, radius, hard_case=low)
            if mask is not None:
                p = p * mask
            x_new = x + p
            with annotate("pp:newton.fgh"):
                out = fgh(x_new)
            f_new, g_new, H_new = out[:3]
            pred = -(torch.sum(g * p, dim=-1) + 0.5 * torch.sum(p * _mv(H, p),
                                                                 dim=-1))
            actual = f - f_new
            rho = actual / torch.where(pred > 0.0, pred, tiny)
            # below the floating-point resolution of f the ratio is rounding
            # noise: accept and declare ftol-convergence
            eps_f = 8.0 * feps * torch.abs(f)
            tiny_pred = (pred <= eps_f) & (actual >= -4.0 * eps_f)
            accept = (pred > 0.0) & ((rho > 0.15) | tiny_pred) & \
                torch.isfinite(f_new)
            pnorm = torch.sqrt(torch.sum(p ** 2, dim=-1))
            # a non-finite trial must shrink the radius, or the same bad step
            # is retried until max_iter
            bad = ~torch.isfinite(rho) | ~torch.isfinite(f_new)
            radius_n = torch.where(
                bad | (rho < 0.25), 0.25 * pnorm,
                torch.where((rho > 0.75) & hit,
                            torch.clamp(2.0 * radius, max=max_radius), radius))
            x_n = _select(accept, x_new, x)
            f_n = torch.where(accept, f_new, f)
            g_n = _select(accept, g_new, g)
            H_n = _select(accept, H_new, H)
            aux_n = _select_aux(accept, out[3], aux) if has_aux else None
            stall = accept & ~hit
            if low:
                # a full Newton step that fails to halve the decrement stalls
                # only at the floor that rounding sets: slow (linear)
                # convergence far above it, as where the float32 Hessian
                # misses a weak direction, goes on
                dec_n, newton_len, floor = _newton_decrement(
                    g_n, H_n, mask, floor_of=(f_n, x_n, feps))
                stall = stall & (dec_n <= FLOOR_K * floor)
            else:
                dec_n, newton_len = _newton_decrement(g_n, H_n, mask)
            stall = stall & (dec_n > 0.5 * dec)
            newton_len = newton_len.to(dtype)
            resolved = (dec_n <= DEC_TOL) | stall
            # below the resolution of f rho cannot steer the radius: let an
            # item that goes on take the full Newton step
            radius_n = torch.where(
                accept & tiny_pred & torch.isfinite(newton_len),
                torch.clamp(torch.maximum(radius_n, 2.0 * newton_len),
                            max=max_radius), radius_n)
            if low:
                # nor, where H is not positive definite, may the radius
                # collapse on a rho that is noise: the model steers, and a
                # step to the boundary doubles it
                radius_n = torch.where(
                    accept & tiny_pred & hit & ~torch.isfinite(newton_len),
                    torch.clamp(2.0 * radius, max=max_radius), radius_n)
            gnorm = torch.sqrt(torch.sum(g_n ** 2, dim=-1))
            gconv = (gnorm < gtol) | ((gnorm < gtol_rel * g0norm) & resolved)
            xconv = accept & (pnorm < xtol)
            # speculative final step on the accepted point: when the next
            # subproblem's predicted decrease is below the resolution of f
            # AND the step is no longer than the one just verified, take it
            # now and stop without paying its fgh evaluation
            with annotate("pp:newton.solve"):
                p2, _ = _tr_solve(g_n, H_n, radius_n, hard_case=low)
            if mask is not None:
                p2 = p2 * mask
            pred2 = -(torch.sum(g_n * p2, dim=-1) +
                      0.5 * torch.sum(p2 * _mv(H_n, p2), dim=-1))
            below2 = (pred2 >= 0.0) & \
                (pred2 <= 8.0 * feps * torch.abs(f_n)) & \
                (torch.sqrt(torch.sum(p2 ** 2, dim=-1)) <= pnorm)
            spec = accept & below2 & resolved
            x_n = _select(spec, x_n + p2, x_n)
            fconv = (accept & (ftol > 0.0) & (actual < ftol * torch.clamp(
                torch.abs(f), min=1.0))) | \
                (accept & tiny_pred & (pred > 0.0) & resolved) | spec
            stalled = (~accept) & (radius_n < xtol)
            done_n = gconv | xconv | fconv | stalled
            status_n = torch.where(gconv, 0, torch.where(
                fconv, 1, torch.where(xconv | stalled, 2, status)))
            # freeze the items whose loop had already ended (vmap semantics)
            x = _select(active, x_n, x)
            f = torch.where(active, f_n, f)
            g = _select(active, g_n, g)
            H = _select(active, H_n, H)
            if has_aux:
                aux = _select_aux(active, aux_n, aux)
            radius = torch.where(active, radius_n, radius)
            dec = torch.where(active, dec_n, dec)
            status = torch.where(active, status_n, status)
            done = torch.where(active, done_n, done)
            it = it + active.to(it.dtype)
            nfev = nfev + active.to(nfev.dtype)
    return NewtonResult(x=x, fun=f, grad=g, hess=H, niter=it, nfev=nfev,
                        status=status, success=status < 3, aux=aux)
