"""Port parity: the batched trust-region Newton loop against the JAX
package's vmap(trust_region_minimize), on the same fgh (float64).

Items converge after different numbers of iterations, so the batch also
checks that finished items stay frozen: niter, nfev and status must be
equal item by item, and x within 1e-10 (eigh and summation order differ
between LAPACK front ends at the 1e-16 level).
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from pulseportraiture_tpu.fitters import newton as jnewton  # noqa: E402
from pulseportraiture_tpu_torch.fitters import newton  # noqa: E402

torch.set_num_threads(2)


def _problems(B=6, n=3, seed=21):
    """Quadratic + quartic bowls with per-item minimizers and stiffness."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0.0, 1.0, (B, n))
    L = rng.normal(0.0, 1.0, (B, n, n))
    H0 = np.einsum("bij,bkj->bik", L, L) + 0.5 * np.eye(n)
    q = rng.uniform(0.0, 3.0, B)
    q[0] = 0.0                       # an exact quadratic: done first
    x0 = a + rng.normal(0.0, 2.0, (B, n))
    x0[1] += 25.0                    # far away: trust-region boundary steps
    return a, H0, q, x0


def _fgh_jax(a, H0, q, C, m):
    """Non-fitted coordinates (m == 0) get a zero gradient row and an
    identity Hessian row/col, as the fitters' fgh does."""
    m = jnp.asarray(m, float)

    def fgh(x):
        d = x - a
        f = C + 0.5 * d @ H0 @ d + q * jnp.sum(d ** 4)
        g = (H0 @ d + 4.0 * q * d ** 3) * m
        H = (H0 + jnp.diag(12.0 * q * d ** 2)) * jnp.outer(m, m) + \
            jnp.diag(1.0 - m)
        return f, g, H
    return fgh


def _fgh_torch(a, H0, q, C, m):
    m = torch.as_tensor(m, dtype=torch.float64)

    def fgh(x):
        d = x - a
        f = C + 0.5 * torch.einsum("bi,bij,bj->b", d, H0, d) + \
            q * torch.sum(d ** 4, dim=-1)
        g = ((H0 @ d[..., None])[..., 0] + 4.0 * q[:, None] * d ** 3) * m
        H = (H0 + torch.diag_embed(12.0 * q[:, None] * d ** 2)) * \
            torch.outer(m, m) + torch.diag(1.0 - m)
        return f, g, H
    return fgh


@pytest.mark.parametrize("C,mask", [(0.0, None), (3e7, None),
                                    (5.0, (1, 1, 0))])
def test_batched_loop_matches_vmapped_jax(C, mask):
    a, H0, q, x0 = _problems()
    kw = dict(max_iter=40, gtol=1e-10, xtol=1e-14, init_radius=1.0,
              step_mask=mask)

    m = mask or (1, 1, 1)

    def one(a_, H_, q_, x_):
        return jnewton.trust_region_minimize(_fgh_jax(a_, H_, q_, C, m), x_,
                                             **kw)

    want = jax.vmap(one)(*(jnp.asarray(v) for v in (a, H0, q, x0)))
    t = [torch.as_tensor(v) for v in (a, H0, q)]
    got = newton.trust_region_minimize(_fgh_torch(*t, C, m),
                                       torch.as_tensor(x0), **kw)
    niter = np.asarray(want.niter)
    assert len(set(niter.tolist())) > 1      # items finish apart
    assert np.array_equal(got.niter.numpy(), niter)
    assert np.array_equal(got.nfev.numpy(), np.asarray(want.nfev))
    assert np.array_equal(got.status.numpy(), np.asarray(want.status))
    assert np.abs(got.x.numpy() - np.asarray(want.x)).max() < 1e-10
    assert np.abs(got.fun.numpy() - np.asarray(want.fun)).max() <= \
        1e-12 * max(1.0, abs(C))
    if mask is not None:
        assert np.array_equal(got.x.numpy()[:, 2], x0[:, 2])


def test_tr_solve_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(4):
        L = rng.normal(size=(4, 4))
        H = L + L.T                      # indefinite in general
        g = rng.normal(size=4)
        for radius in (1e-3, 0.5, 1e3):
            jp, jhit = jnewton._tr_solve(jnp.asarray(g), jnp.asarray(H),
                                         radius)
            p, hit = newton._tr_solve(torch.as_tensor(g)[None],
                                      torch.as_tensor(H)[None],
                                      torch.tensor([radius],
                                                   dtype=torch.float64))
            assert bool(hit[0]) == bool(jhit)
            assert np.abs(p[0].numpy() - np.asarray(jp)).max() < 1e-10


def _single(fgh):
    """A one-item batch around an unbatched (f, g, H) callable."""
    def batched(x):
        f, g, H = fgh(x[0])
        return f[None], g[None], H[None]
    return batched


def test_speculative_final_step_exact_quadratic():
    """On a pure quadratic with a huge constant offset the optimizer
    takes the exact Newton step, then stops without another fgh
    evaluation (nfev == 2)."""
    a = torch.tensor([0.3, -0.7], dtype=torch.float64)
    H0 = torch.tensor([[4.0, 1.0], [1.0, 3.0]], dtype=torch.float64)
    calls = []

    def fgh(x):
        calls.append(1)
        d = x - a
        return 3e7 + 0.5 * d @ H0 @ d, H0 @ d, H0

    res = newton.trust_region_minimize(
        _single(fgh), torch.zeros((1, 2), dtype=torch.float64), max_iter=30,
        init_radius=100.0)
    assert (res.x[0] - a).abs().max() < 1e-5
    assert int(res.nfev[0]) == 2 and int(res.niter[0]) == 1
    assert len(calls) == 2
    assert int(res.status[0]) in (0, 1) and bool(res.success[0])

    def fgh_small(x):
        d = x - a
        return 0.5 * d @ H0 @ d, H0 @ d, H0

    res2 = newton.trust_region_minimize(
        _single(fgh_small), torch.zeros((1, 2), dtype=torch.float64),
        max_iter=30, init_radius=100.0)
    assert (res2.x[0] - a).abs().max() < 1e-5 and bool(res2.success[0])


def test_speculative_step_respects_mask():
    a = torch.tensor([0.3, -0.7, 0.25], dtype=torch.float64)
    H0 = torch.tensor([[4.0, 1.0, 0.0], [1.0, 3.0, 0.0], [0.0, 0.0, 1.0]],
                      dtype=torch.float64)

    def fgh(x):
        d = x - a
        g = H0 @ d
        g[2] = 0.0                 # masked coordinate: zero gradient row
        return 3e7 + 0.5 * d @ H0 @ d, g, H0

    res = newton.trust_region_minimize(
        _single(fgh), torch.tensor([[0.0, 0.0, 0.125]], dtype=torch.float64),
        max_iter=30, init_radius=100.0, step_mask=(1, 1, 0))
    assert float(res.x[0, 2]) == 0.125
    assert (res.x[0, :2] - a[:2]).abs().max() < 1e-5


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_speculative_step_bounded_on_singular_hessian(dtype):
    """Along a near-singular (quartic) direction the quadratic model may
    predict a sub-floor decrease for a large jump; the |p| <= last
    verified step guard forces real evaluations instead of an
    overshoot."""
    a0, a1 = 0.1, 0.2

    def fgh(x):
        d0, d1 = x[0] - a0, x[1] - a1
        f = 3e7 + 1e6 * d0 ** 2 + d1 ** 4
        g = torch.stack([2e6 * d0, 4.0 * d1 ** 3])
        H = torch.diag(torch.stack([torch.full_like(d1, 2e6),
                                    12.0 * d1 ** 2]))
        return f, g, H

    res = newton.trust_region_minimize(
        _single(fgh), torch.zeros((1, 2), dtype=dtype), max_iter=60,
        init_radius=1.0)
    x = res.x[0].double().numpy()
    assert abs(x[0] - a0) < 1e-4, x
    assert -0.05 < x[1] < a1 + 0.15, x


def test_float32_stops_at_the_optimum():
    """In float32 the relative gradient test 100 eps |g0| is set by the
    stiff coordinate's first gradient (~2e8): the JAX package's loop
    ends the soft coordinate ~28 units (sigma) short.  The port's stops
    wait for g H^-1 g <= DEC_TOL."""
    a = (1.0, 30.0)

    def fgh_jax(x):
        d = x - jnp.asarray(a, x.dtype)
        f = 3e7 + 1e8 * d[0] ** 2 + d[1] ** 2
        return f, jnp.stack([2e8 * d[0], 2.0 * d[1]]), \
            jnp.diag(jnp.asarray([2e8, 2.0], x.dtype))

    def fgh(x):
        d = x - torch.tensor(a, dtype=x.dtype)
        f = 3e7 + 1e8 * d[:, 0] ** 2 + d[:, 1] ** 2
        g = torch.stack([2e8 * d[:, 0], 2.0 * d[:, 1]], dim=-1)
        H = torch.diag_embed(torch.stack([torch.full_like(d[:, 0], 2e8),
                                          torch.full_like(d[:, 1], 2.0)],
                                         dim=-1))
        return f, g, H

    kw = dict(max_iter=60, init_radius=1.0)
    want = jnewton.trust_region_minimize(fgh_jax, jnp.zeros(2, jnp.float32),
                                         **kw)
    assert np.asarray(want.x).dtype == np.float32
    assert abs(float(want.x[1]) - a[1]) > 1.0
    got = newton.trust_region_minimize(fgh, torch.zeros((1, 2)), **kw)
    assert got.x.dtype == torch.float32 and bool(got.success[0])
    assert abs(float(got.x[0, 1]) - a[1]) <= math.sqrt(newton.DEC_TOL)
    assert abs(float(got.x[0, 0]) - a[0]) <= 1e-7


def test_newton_on_the_fit_objective_matches_jax():
    """The same JAX setups through both packages' objective and Newton
    loop: the port's batched loop on the stacked setups (fed through
    setup_from_reference) against the JAX loop item by item."""
    from pulseportraiture_tpu.fitters import stats as jstats
    from pulseportraiture_tpu_torch.fitters import stats

    from torch_parity_utils import injected_batch

    d = injected_batch(B=3, nchan=24, nbin=256, seed=9)
    flags = (1, 1, 0, 0, 0)
    x0 = np.array([[0.004, 0.0, 0, 0, 0], [-0.008, 1e-4, 0, 0, 0],
                   [0.0, 0.0, 0, 0, 0]])
    js_all, ts_all = [], []
    for i in range(3):
        js = jstats.make_setup(
            jnp.asarray(d["data"][i]), jnp.asarray(d["model"]),
            jnp.asarray(d["errs"][i]), d["P"], jnp.asarray(d["freqs"]),
            d["nu_fit"], d["nu_fit"], d["nu_fit"])
        js_all.append(js)
        fields = {n: np.asarray(getattr(js, n)) for n in (
            "Gr", "Gi", "M2", "w", "freqs", "P", "nu_DM", "nu_GM",
            "nu_tau", "Sd", "S0", "sd_chan")}
        fields["nbin"] = js.nbin
        ts_all.append(stats.setup_from_reference(fields))
    ts = stats.FitSetup(*[
        torch.stack([getattr(s, n) for s in ts_all]) if torch.is_tensor(
            getattr(ts_all[0], n)) else getattr(ts_all[0], n)
        for n in stats.FitSetup._fields])
    kw = dict(max_iter=50, gtol=1e-11, xtol=1e-14, step_mask=flags)
    got = newton.trust_region_minimize(
        lambda x: stats.chi2_value_grad_hess(x, ts, flags),
        torch.as_tensor(x0), has_aux=True, **kw)
    for i, js in enumerate(js_all):
        want = jnewton.trust_region_minimize(
            lambda x, js=js: jstats.chi2_value_grad_hess(
                x, js, fit_flags=flags, log10_tau=False, scattering=False),
            jnp.asarray(x0[i]), **kw)
        assert int(got.niter[i]) == int(want.niter)
        assert int(got.status[i]) == int(want.status)
        assert np.abs(got.x[i].numpy() - np.asarray(want.x)).max() < 1e-12
        # the carried moments belong to the accepted point
        assert abs(float(got.fun[i]) - float(want.fun)) <= \
            1e-12 * abs(float(want.fun))
        assert got.aux["C"].shape == (3, 24)
