"""The port's float32 fit against its float64 fit, and its assembly of a
run with a fit that is not finite.

On the archives of tests/test_torch_pipeline.py, get_TOAs(fit_scat=True)
in float32 (int16 ingest, the band-capped template) and in float64, for
log10 and linear tau, alpha held and fitted: every TOA (moved to the
float64 TOA's frequency with the float64 DM) and every DM within 0.01
of the float64 errors, and all six TOAs finite.  The float32 trust-region
loop must neither stop on slow convergence far above the rounding floor
(a full Newton step that fails to halve the decrement) nor let its
radius collapse where the Hessian is indefinite and the objective's
changes are below its rounding.  A subint whose fit is not finite is left out with a message.
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from pulseportraiture_tpu_torch.config import DCONST  # noqa: E402
from pulseportraiture_tpu_torch.fitters import newton  # noqa: E402
from pulseportraiture_tpu_torch.pipelines import toas  # noqa: E402

from test_torch_pipeline import ws  # noqa: E402,F401

torch.set_num_threads(2)


@pytest.mark.parametrize("fix_alpha", [True, False])
@pytest.mark.parametrize("log10_tau", [True, False])
def test_float32_scattering_toas_agree_with_float64(ws, log10_tau, fix_alpha):
    kw = dict(fit_scat=True, log10_tau=log10_tau, fix_alpha=fix_alpha,
              bary=False, quiet=True)
    runs = {}
    for dt in (torch.float32, torch.float64):
        gt = toas.GetTOAs(ws["files"], ws["fits"], device="cpu", dtype=dt,
                          quiet=True)
        gt.get_TOAs(**kw)
        runs[dt] = gt
    got, want = runs[torch.float32].TOA_list, runs[torch.float64].TOA_list
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        assert math.isfinite(a.MJD.fracday()) and math.isfinite(a.DM)
        # seconds; the fits share the topocentric DM's frequency law
        dt = (a.MJD - b.MJD) + DCONST * b.DM * (b.frequency ** -2.0 -
                                                a.frequency ** -2.0)
        assert abs(dt) * 1e6 <= 1e-2 * b.TOA_error, (a.frequency,
                                                     b.frequency)
        assert abs(a.DM - b.DM) <= 1e-2 * b.DM_error


def test_a_non_finite_fit_is_left_out(ws, monkeypatch, capsys):
    """One item's fitted phase forced to NaN: that subint is skipped with
    a message naming the archive and subint; the run assembles the
    other five TOAs and the archive's per-subint records."""
    orig = toas.fit_portrait_full_batch_packed
    calls = []

    def broken(*args, **kwargs):
        packed = orig(*args, **kwargs)
        if not calls:
            packed[1, 0] = float("nan")       # params[1, 0]: item 1's phi
        calls.append(1)
        return packed

    monkeypatch.setattr(toas, "fit_portrait_full_batch_packed", broken)
    gt = toas.GetTOAs(ws["files"], ws["fits"], device="cpu",
                      dtype=torch.float64, quiet=True)
    gt.get_TOAs(quiet=True)
    out = capsys.readouterr().out
    assert f"Skipping {ws['files'][0]} subint 1" in out
    assert len(gt.TOA_list) == 5
    assert [t.flags["subint"] for t in gt.TOA_list] == [0, 0, 1, 0, 1]
    assert list(gt.ok_isubs[0]) == [0] and len(gt.DMs[0]) == 1
    assert all(np.isfinite(t.DM) for t in gt.TOA_list)


def test_hard_case_step_reaches_the_boundary():
    """Negative curvature that g does not see: the float32 loop's solve
    puts the rest of the radius along the lowest eigenvector, downhill;
    without the hard case the step stays short of the boundary."""
    g = torch.tensor([[1.0, 0.0]], dtype=torch.float64)
    H = torch.tensor([[[1.0, 0.0], [0.0, -0.1]]], dtype=torch.float64)
    radius = torch.tensor([2.0], dtype=torch.float64)
    p, hit = newton._tr_solve(g, H, radius, hard_case=True)
    assert bool(hit[0])
    assert abs(float(p.norm()) - 2.0) < 1e-9
    assert abs(float(p[0, 1])) > 1.0
    q, _ = newton._tr_solve(g, H, radius)
    assert float(q.norm()) < 1.5


def test_float32_loop_walks_an_indefinite_plateau():
    """A float32 objective (f ~ 3.5e5, rounding 0.03) whose shallow
    direction changes it by at most 1e-3, indefinite at the start: every
    trial's actual decrease rounds to 0, so rho is noise.  The loop steps
    by the model, the radius grows instead of collapsing, and it ends at
    the minimum b = 2."""
    s = 1e-3

    def fgh(x):
        x64 = x.double()
        a, b = x64[..., 0], x64[..., 1]
        f = -3.5e5 + 1e4 * a * a + s * (b * b - 4.0) ** 2 / 16.0
        g = torch.stack([2e4 * a, s * b * (b * b - 4.0) / 4.0], dim=-1)
        H = torch.zeros(x.shape[:-1] + (2, 2), dtype=torch.float64)
        H[..., 0, 0] = 2e4
        H[..., 1, 1] = s * (3.0 * b * b - 4.0) / 4.0
        return f.to(x.dtype), g.to(x.dtype), H.to(x.dtype)

    x0 = torch.tensor([[1e-3, 0.1]], dtype=torch.float32)
    res = newton.trust_region_minimize(fgh, x0, gtol=1e-11, xtol=1e-14,
                                       max_iter=100)
    assert int(res.status[0]) < 3
    assert abs(float(res.x[0, 1]) - 2.0) < 1e-3, res.x


def _linear_fgh(f0, c, noise=0.0):
    """f = f0 + x^2 / 2 in float32, reported with the curvature c (> 1):
    a Hessian that overstates the direction, so Newton converges linearly
    (x falls by 1 - 1/c a step, the decrement by its square).  g carries
    an error of +-noise, its sign alternating from call to call."""
    calls = []

    def fgh(x):
        calls.append(1)
        x64 = x.double()
        f = f0 + 0.5 * x64[..., 0] ** 2
        g = x64 + noise * (-1.0) ** len(calls)
        H = torch.full(x.shape[:-1] + (1, 1), c, dtype=torch.float64)
        return f.to(x.dtype), g.to(x.dtype), H.to(x.dtype)
    return fgh


def test_float32_linear_convergence_runs_to_the_floor():
    """The decrement falls by 36% a step (c = 5), from 0.2 chi2, below
    the resolution of f (8 eps |f| ~ 1): every step fails to halve it,
    yet it is far above the floor rounding sets, so the loop goes on to
    DEC_TOL instead of stopping sqrt(0.2) sigma short."""
    x0 = torch.tensor([[1.0]], dtype=torch.float32)
    res = newton.trust_region_minimize(_linear_fgh(1e6, 5.0), x0,
                                       max_iter=100)
    assert int(res.status[0]) < 3
    dec = float(res.grad[0, 0]) ** 2 / 5.0
    assert dec <= newton.DEC_TOL, (res.x, int(res.niter[0]))
    assert abs(float(res.x[0, 0])) <= math.sqrt(5.0 * newton.DEC_TOL)


def test_float32_stall_resolves_at_the_rounding_floor():
    """At f = 1e9 the floor rounding sets is eps^2 |f| = 1.4e-5 chi2; g's
    error of 3e-3 keeps the decrement near 2e-6, above DEC_TOL, for
    good.  The loop converges linearly down to FLOOR_K times the floor
    and stops there by a stall, long before max_iter."""
    x0 = torch.tensor([[1.0]], dtype=torch.float32)
    res = newton.trust_region_minimize(_linear_fgh(1e9, 5.0, noise=3e-3),
                                       x0, max_iter=100)
    assert int(res.status[0]) < 3 and int(res.niter[0]) < 40
    floor = torch.finfo(torch.float32).eps ** 2 * 1e9
    assert float(res.x[0, 0]) ** 2 / 5.0 <= 2.0 * newton.FLOOR_K * floor
