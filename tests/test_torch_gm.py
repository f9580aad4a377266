"""Port parity: the GM (nu^-4) fit against the JAX package, float64.

The zero-covariance frequencies of the three flag sets with GM fitted
(the closed form (1,0,1,0,0) and the polynomials (1,1,1,0,0) and
(1,1,1,1,0), with their grid-plus-bisection root solver) at 1e-9; the
batched fit of those flag sets from one start (seed_phase=False, so the
Newton paths coincide): parameters within 1e-9 of their errors, the rest
within 1e-9 relative; get_TOAs(fit_GM=True), with and without fit_scat,
on the archives of tests/test_torch_pipeline.py: TOAs within 1 ns, DMs
and GMs within 1e-6 of their errors, nu_DM within 1e-9 relative; and
pptoas --fit_dt4's .tim lines.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from pulseportraiture_tpu.fitters import nu_zeros as jnz  # noqa: E402
from pulseportraiture_tpu.fitters import stats as jstats  # noqa: E402
from pulseportraiture_tpu.fitters.portrait import \
    fit_portrait_full_batch as jfit  # noqa: E402
from pulseportraiture_tpu.io.tim import write_TOAs  # noqa: E402
from pulseportraiture_tpu.pipelines.toas import \
    GetTOAs as JGetTOAs  # noqa: E402
from pulseportraiture_tpu_torch.fitters import nu_zeros  # noqa: E402
from pulseportraiture_tpu_torch.fitters import stats  # noqa: E402
from pulseportraiture_tpu_torch.fitters.portrait import (  # noqa: E402
    fit_portrait_full_batch, template_spectrum)
from pulseportraiture_tpu_torch.pipelines import toas  # noqa: E402

from test_torch_pipeline import ws  # noqa: E402,F401
from torch_parity_utils import (injected_batch, mjd_diff_s,  # noqa: E402
                                rel_err, t64)

torch.set_num_threads(2)

GM_FLAGS = [(1, 0, 1, 0, 0), (1, 1, 1, 0, 0), (1, 1, 1, 1, 0)]


@pytest.mark.parametrize("square", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_root_solver_matches_jax(seed, square):
    """Seeded polynomials with roots around the target (and one without
    any bracketed root): the batched solver picks the JAX solver's root."""
    rng = np.random.default_rng(seed)
    target = 1500.0
    polys = []
    for _ in range(6):
        roots = rng.uniform(0.3, 3.0, 4) * (target ** 2 if square else target)
        c = np.poly(roots) * rng.choice([-1.0, 1.0])
        polys.append(c / np.max(np.abs(c)))
    polys.append(np.array([1.0, 0.0, 1.0, 0.0, 1.0]))    # no real root
    coeffs = np.stack(polys)
    got = nu_zeros._nearest_positive_real_root(
        t64(coeffs), t64(np.full(len(coeffs), target)), square=square)
    want = [float(jnz._nearest_positive_real_root(jnp.asarray(c), target,
                                                  square=square))
            for c in coeffs]
    assert rel_err(got, want) < 1e-12
    assert float(got[-1]) == target


def _setups(seed=8, nchan=24, nbin=256):
    d = injected_batch(B=1, nchan=nchan, nbin=nbin, seed=seed, tau=3e-3)
    d["errs"][0, 5] = 0.0                      # a dead channel
    js = jstats.make_setup(
        jnp.asarray(d["data"][0]), jnp.asarray(d["model"]),
        jnp.asarray(d["errs"][0]), d["P"], jnp.asarray(d["freqs"]),
        d["nu_fit"], d["nu_fit"] + 50.0, d["nu_fit"] - 30.0)
    f = {name: np.asarray(getattr(js, name))
         for name in ("Gr", "Gi", "M2", "w", "freqs", "P", "nu_DM",
                      "nu_GM", "nu_tau", "Sd", "S0", "sd_chan")}
    f["nbin"] = js.nbin
    return js, stats.setup_from_reference(f)


@pytest.mark.parametrize("option", [0, 1])
@pytest.mark.parametrize("fit_flags", GM_FLAGS)
def test_gm_nu_zeros_match_jax(fit_flags, option):
    js, ts = _setups()
    p = np.array([0.0061, -1.7e-4, 2e-7, np.log10(3e-3), -3.7])
    _, _, _, jm = jstats.chi2_value_grad_hess(
        jnp.asarray(p), js, log10_tau=True, scattering=True,
        return_moments=True, use_pallas=False)
    _, _, _, m = stats.chi2_value_grad_hess(t64(p), ts, log10_tau=True,
                                            scattering=True)
    want = jnz.get_nu_zeros(jnp.asarray(p), js, fit_flags=fit_flags,
                            log10_tau=True, option=option, moments=jm)
    got = nu_zeros.get_nu_zeros(ts, fit_flags, m, params=t64(p),
                                log10_tau=True, option=option)
    for a, b in zip(got, want):
        assert rel_err(a, b) < 1e-9
    j = 1 if fit_flags == (1, 0, 1, 0, 0) else 0
    assert abs(float(got[j]) - float(ts[6 + j])) > 1e-3   # a root was found


@pytest.mark.parametrize("fit_flags", GM_FLAGS)
def test_gm_fit_matches_jax_float64(fit_flags):
    scat = bool(fit_flags[3])
    d = injected_batch(B=3, nchan=32, nbin=256, seed=7,
                       tau=4e-3 if scat else 0.0)
    d["errs"][1, [3, 17]] = 0.0          # dead (zero-weight) channels
    B = 3
    init = np.zeros((B, 5))
    init[:, 0] = d["phis"] + 2e-4
    if scat:
        init[:, 3], init[:, 4] = np.log10(2e-3), -4.0
    want = jfit(jnp.asarray(d["data"]), jnp.asarray(d["model"]),
                jnp.asarray(init), jnp.full(B, d["P"]),
                jnp.asarray(d["freqs"]), jnp.asarray(d["errs"]),
                nu_fits=jnp.asarray(d["nu_fits"]), fit_flags=fit_flags,
                log10_tau=scat, scattering=scat)
    got = fit_portrait_full_batch(
        torch.from_numpy(d["data"]), template_spectrum(d["model"]),
        t64(init), t64(np.full(B, d["P"])), t64(d["freqs"]),
        t64(d["errs"]), nu_fits=t64(d["nu_fits"]), fit_flags=fit_flags,
        log10_tau=scat, dtype=torch.float64, seed_phase=False)
    errs = np.asarray(want.param_errs)
    for j in range(5):
        if fit_flags[j]:
            d_p = np.abs(got.params[:, j].numpy() -
                         np.asarray(want.params)[:, j])
            assert np.all(d_p <= 1e-9 * errs[:, j]), (j, d_p, errs[:, j])
    for name in ("param_errs", "covariance_matrix", "scales", "nu_DM",
                 "nu_GM", "nu_tau", "red_chi2", "snr", "channel_red_chi2"):
        assert rel_err(getattr(got, name), getattr(want, name)) < 1e-9, \
            name
    assert np.array_equal(got.niter.numpy(), np.asarray(want.niter))
    assert bool((got.return_code < 3).all())


@pytest.mark.parametrize("fit_scat", [False, True])
def test_gm_toas_match_jax(ws, fit_scat):
    kw = dict(fit_GM=True, fit_scat=fit_scat)
    want = JGetTOAs(ws["files"], ws["fits"], quiet=True)
    want.get_TOAs(quiet=True, **kw)
    got = toas.GetTOAs(ws["files"], ws["fits"], device="cpu",
                       dtype=torch.float64, quiet=True)
    got.get_TOAs(quiet=True, **kw)
    assert len(got.TOA_list) == len(want.TOA_list) == 6
    for a, b in zip(got.TOA_list, want.TOA_list):
        assert abs(mjd_diff_s(a.MJD, b.MJD)) < 1e-9     # seconds: 1 ns
        assert abs(a.frequency - b.frequency) < 1e-9 * b.frequency
        assert abs(a.DM - b.DM) <= 1e-6 * b.DM_error
        assert abs(a.flags["gm"] - b.flags["gm"]) <= \
            1e-6 * b.flags["gm_err"]
        assert a.flags["gm_err"] > 0.0
    assert np.allclose(np.concatenate(got.GMs), np.concatenate(want.GMs),
                       rtol=0.0, atol=1e-6 * np.max(np.concatenate(
                           want.GM_errs)))


def test_pptoas_fit_dt4_lines(ws):
    """pptoas --fit_dt4 in float32 on the CPU writes the JAX package's
    TOA lines: the same archives, frequencies to float32 rounding, and
    gm flags within 0.01 of their errors."""
    from pulseportraiture_tpu_torch.cli import pptoas
    tim = str(ws["path"] / "gm.tim")
    if os.path.exists(tim):
        os.remove(tim)
    assert pptoas.main(["-d", ws["files"][0], "-m", ws["fits"], "-o", tim,
                        "--fit_dt4", "--device", "cpu", "--quiet"]) == 0
    want = JGetTOAs([ws["files"][0]], ws["fits"], quiet=True)
    want.get_TOAs(quiet=True, fit_GM=True)
    jlines = write_TOAs(want.TOA_list, outfile=None)
    with open(tim) as f:
        lines = f.read().splitlines()
    assert len(lines) == len(jlines) == 2
    for line, jline in zip(lines, jlines):
        a, b = line.split(), jline.split()
        assert a[0] == b[0]
        assert abs(float(a[1]) - float(b[1])) < 1e-4 * float(b[1])
        fa = dict(zip(a[5::2], a[6::2]))
        fb = dict(zip(b[5::2], b[6::2]))
        assert set(fa) == set(fb) and "-gm" in fa and "-gm_err" in fa
        assert abs(float(fa["-gm"]) - float(fb["-gm"])) <= \
            1e-2 * float(fb["-gm_err"])
