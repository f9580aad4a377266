"""Port parity: ops.transform and fitters.stats against the JAX package.

float64 on both sides.  Tolerances are PARITY.md's for the JAX package
against the original code: objective 1e-12, gradient 1e-10, Hessian
1e-9, Woodbury covariance 1e-8 (relative to the largest element).
"""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from pulseportraiture_tpu.fitters import stats as jstats  # noqa: E402
from pulseportraiture_tpu.ops import ct_dft as jct  # noqa: E402
from pulseportraiture_tpu.ops import transform as jtr  # noqa: E402
from pulseportraiture_tpu_torch.fitters import stats  # noqa: E402
from pulseportraiture_tpu_torch.ops import transform as ttr  # noqa: E402

from torch_parity_utils import (injected_batch, rel_err, t64,  # noqa: E402
                                unpermute)

torch.set_num_threads(2)


def test_transforms_match_jax():
    rng = np.random.default_rng(1)
    freqs = np.concatenate([rng.uniform(300.0, 3000.0, 31), [np.inf]])
    x = rng.uniform(-3.0, 3.0, 64)
    x[:4] = [0.5, -0.5, 1.5, -1.0]
    assert rel_err(ttr.mod_pm_half(t64(x)), jtr.mod_pm_half(jnp.asarray(x))
                   ) == 0.0
    for v in (0.7, -0.5, 0.25, -2.25):
        assert ttr.mod_pm_half(v) == float(jtr.mod_pm_half(v))
    args = (0.013, 2.5e-3, 1.0e-4)
    for nu_DM, nu_GM, P in ((1400.0, 1500.0, 0.005), (np.inf, np.inf, None)):
        want = jtr.phase_shifts(*args, jnp.asarray(freqs), nu_DM, nu_GM, P)
        got = ttr.phase_shifts(*args, t64(freqs), nu_DM, nu_GM, P)
        assert rel_err(got, want) < 1e-14
        want = jtr.phase_shifts_deriv(jnp.asarray(freqs), nu_DM, nu_GM, P)
        got = ttr.phase_shifts_deriv(t64(freqs), nu_DM, nu_GM, P)
        assert got.shape == (3, len(freqs))
        assert rel_err(got, want) < 1e-14
    got = ttr.phase_shifts(*args, t64(freqs), 1400.0, 1500.0, 0.005,
                           mod=True)
    want = jtr.phase_shifts(*args, jnp.asarray(freqs), 1400.0, 1500.0,
                            0.005, mod=True)
    assert rel_err(got, want) < 1e-13
    for P, mod in ((0.005, True), (None, False)):
        got = ttr.phase_transform(0.4, t64(x[:8]) * 1e-3, 1300.0,
                                  t64(freqs[:8]), P, mod=mod)
        want = jtr.phase_transform(0.4, jnp.asarray(x[:8]) * 1e-3, 1300.0,
                                   jnp.asarray(freqs[:8]), P, mod=mod)
        assert rel_err(got, want) < 1e-13
    got = ttr.DM_delay(12.5, t64(freqs), 1400.0, 0.004)
    want = jtr.DM_delay(12.5, jnp.asarray(freqs), 1400.0, 0.004)
    assert rel_err(got, want) < 1e-14
    assert ttr._inv2(math.inf) == 0.0 and ttr._inv4(2.0) == 2.0 ** -4


def test_phase_trig_float32_is_double_single():
    """The f32 phasor follows the JAX steps (agreement to f32 trig
    rounding) and stays ~1e-6 rad accurate at k ~ 2000, where a naive
    f32 product loses ~1e-4 rad."""
    rng = np.random.default_rng(2)
    phis = rng.uniform(-2.0, 2.0, 257).astype(np.float32)
    k = np.arange(2049, dtype=np.float32)
    c, s = stats._phase_trig(torch.from_numpy(phis), torch.from_numpy(k))
    jc, js = jstats._phase_trig(jnp.asarray(phis), jnp.asarray(k))
    assert np.abs(c.numpy() - np.asarray(jc)).max() < 1e-6
    assert np.abs(s.numpy() - np.asarray(js)).max() < 1e-6
    ang = 2.0 * np.pi * phis.astype(np.float64)[:, None] * k
    assert np.abs(c.numpy() - np.cos(ang)).max() < 3e-6
    naive = np.cos((2.0 * np.pi * phis[:, None] * k).astype(np.float32))
    assert np.abs(naive - np.cos(ang)).max() > 1e-4


def _trig_phases():
    """Phases over [-2, 2] turns, and phases beside every multiple of
    1/8192 (where the 13-bit hi of the split rounds either way)."""
    rng = np.random.default_rng(5)
    grid = np.arange(-4096, 4097, 7) / 8192.0
    return np.concatenate([rng.uniform(-2.0, 2.0, 97),
                           grid + rng.uniform(-6e-5, 6e-5, grid.size)]
                          ).astype(np.float32)


def test_phase_trig_float32_angles_are_the_jax_steps(monkeypatch):
    """At k <= 4096 the port's float32 phase (k reduced mod 8192 is k
    itself there) is the JAX package's double-single angle bit for bit:
    cos and sin replaced by the identity on both sides, the angles are
    equal, and so are the port's phasors before and after the reduction
    (the libms' cos/sin differ in the last bit, so the phasors are held
    to the angle)."""
    phis = _trig_phases()
    k = np.arange(4097, dtype=np.float32)
    ident = (lambda a: a)
    with monkeypatch.context() as m:
        m.setattr(jnp, "cos", ident)
        m.setattr(jnp, "sin", ident)
        m.setattr(torch, "cos", ident)
        m.setattr(torch, "sin", ident)
        got, _ = stats._phase_trig(torch.from_numpy(phis),
                                   torch.from_numpy(k))
        want, _ = jstats._phase_trig(jnp.asarray(phis), jnp.asarray(k))
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(want))
    # the split without the reduction, step for step
    p = torch.from_numpy(phis)
    p = p - torch.round(p)
    hi = torch.round(p * 8192.0) / 8192.0
    prod = hi[..., None] * torch.from_numpy(k)
    ang = stats.TWO_PI * ((prod - torch.round(prod)) +
                          (p - hi)[..., None] * torch.from_numpy(k))
    c, s = stats._phase_trig(torch.from_numpy(phis), torch.from_numpy(k))
    assert torch.equal(c, torch.cos(ang)) and torch.equal(s, torch.sin(ang))


@pytest.mark.parametrize("k0,bound", [(0, 1e-6), (4096, 1e-6),
                                      (8192 - 64, 1.5e-6),
                                      (12288 - 32, 2e-6),
                                      (16384 - 128, 2e-6)])
def test_phase_trig_float32_any_harmonic(k0, bound):
    """Above k = 4096, where the JAX package's f32 hi*k stops being exact
    (an error up to 1/8192 turn), the port reduces k mod 8192 first: the
    float32 phasor stays within `bound` rad of the float64 one through
    k = 16384 (2e-6 rad: the roundings of lo*k, of frac + lo*k and of the
    f32 2 pi times it, 2^-23 turn at k = 16384, plus sincosf's)."""
    phis = _trig_phases()
    k = np.arange(k0, k0 + 129, dtype=np.float32)
    c, s = stats._phase_trig(torch.from_numpy(phis), torch.from_numpy(k))
    ang = 2.0 * np.pi * np.mod(phis.astype(np.float64)[:, None] *
                               k.astype(np.float64), 1.0)
    z = (c.double().numpy() + 1j * s.double().numpy()) * np.exp(-1j * ang)
    assert np.abs(np.angle(z)).max() <= bound
    assert np.abs(np.abs(z) - 1.0).max() <= 3e-7


def _jax_setup(d, item=0):
    return jstats.make_setup(
        jnp.asarray(d["data"][item]), jnp.asarray(d["model"]),
        jnp.asarray(d["errs"][item]), d["P"], jnp.asarray(d["freqs"]),
        d["nu_fit"], d["nu_fit"] + 50.0, d["nu_fit"])


def _fields(js):
    f = {name: np.asarray(getattr(js, name))
         for name in ("Gr", "Gi", "M2", "w", "freqs", "P", "nu_DM",
                      "nu_GM", "nu_tau", "Sd", "S0", "sd_chan")}
    f["nbin"] = js.nbin
    return f


@pytest.mark.parametrize("layout", ["natural", "ct"])
@pytest.mark.parametrize("fit_flags", [(1, 1, 0, 0, 0), (1, 1, 1, 0, 0),
                                       (1, 0, 0, 0, 0)])
def test_value_grad_hess_and_covariance_match_jax(layout, fit_flags):
    d = injected_batch(B=1, nchan=24, nbin=256, seed=3)
    js = _jax_setup(d)
    kvec = None
    if layout == "ct":
        # the TPU layout: harmonics permuted, kvec carries their numbers
        ct = jct.ct_perm_np(256)
        js = js._replace(Gr=js.Gr[..., ct], Gi=js.Gi[..., ct],
                         M2=js.M2[..., ct], kvec=jnp.asarray(ct, float))
        kvec = ct
    fields = _fields(js)
    ts = stats.setup_from_reference(fields, kvec=kvec)
    if kvec is not None:
        assert rel_err(ts.Gr, unpermute(fields["Gr"], kvec)) == 0.0
    p = np.array([0.0061, -1.7e-4, 2e-7, 0.0, 0.0])
    jf, jg, jH, jm = jstats.chi2_value_grad_hess(
        jnp.asarray(p), js, fit_flags=fit_flags, log10_tau=False,
        scattering=False, return_moments=True)
    f, g, H, m = stats.chi2_value_grad_hess(t64(p), ts, fit_flags=fit_flags)
    assert rel_err(f, jf) < 1e-12
    assert rel_err(g, jg) < 1e-10
    assert rel_err(H, jH) < 1e-9
    Hn = stats.hess_per_channel_from_moments(m, ts, fit_flags)
    jHn = jstats.hess_per_channel_from_moments(jm, js, fit_flags)
    assert rel_err(Hn, jHn) < 1e-9
    # Woodbury covariance at output references (rebased moments)
    ts_out = ts._replace(nu_DM=t64(1350.0), nu_GM=t64(1350.0))
    js_out = js._replace(nu_DM=jnp.asarray(1350.0),
                         nu_GM=jnp.asarray(1350.0))
    got = stats._covariance_core(stats.rebase_moments(m, ts_out), ts_out,
                                 fit_flags)
    want = jstats.covariance_with_scales_from_moments(
        jstats.rebase_moments(jm, p, js_out, False, scattering=False),
        js_out, fit_flags)
    for a, b in zip(got, want):
        assert rel_err(a, b) < 1e-8
    sc, S = stats.get_scales(t64(p), ts)
    jsc, jS = jstats.get_scales(jnp.asarray(p), js, log10_tau=False,
                                scattering=False)
    assert rel_err(sc, jsc) < 1e-12 and rel_err(S, jS) < 1e-12


def test_batched_stats_equal_per_item():
    d = injected_batch(B=3, nchan=16, nbin=128, seed=4)
    sets = [stats.setup_from_reference(_fields(_jax_setup(d, i)))
            for i in range(3)]
    batched = stats.FitSetup(*[
        torch.stack([getattr(s, n) for s in sets]) if torch.is_tensor(
            getattr(sets[0], n)) else getattr(sets[0], n)
        for n in stats.FitSetup._fields])
    p = t64(np.array([[0.001, 1e-4, 0, 0, 0], [-0.003, 0, 0, 0, 0],
                      [0.01, -2e-4, 0, 0, 0]]))
    fb, gb, Hb, _ = stats.chi2_value_grad_hess(p, batched, (1, 1, 0, 0, 0))
    for i, s in enumerate(sets):
        f, g, H, _ = stats.chi2_value_grad_hess(p[i], s, (1, 1, 0, 0, 0))
        assert rel_err(fb[i], f) < 1e-14 and rel_err(gb[i], g) < 1e-12
        assert rel_err(Hb[i], H) < 1e-12


def test_setup_from_reference_rejects_a_bad_kvec():
    d = injected_batch(B=1, nchan=4, nbin=64, seed=5)
    fields = _fields(_jax_setup(d))
    with pytest.raises(ValueError):
        stats.setup_from_reference(fields, kvec=np.zeros(33))
