"""Port parity: the Gaussian builder (models.gaussian's torch generators
and bounded Levenberg-Marquardt fits, models.gmodel_io.write_model,
fitters.powlaw, ops.gaussian's instrumental response and
get_TOAs(add_instrumental_response=True)) against the JAX package's,
float64 on the CPU, at 32 channels x 256 bins.

Tolerances: generated portraits 1e-12 of their largest value; fitted
parameters within 1e-6 of their errors, errors 1e-6 relative, chi2 1e-9
relative; the instrumental response 1e-12; TOAs within 1 ns and DMs
within 1e-6 of their errors.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from pulseportraiture_tpu.fitters import powlaw as jpl  # noqa: E402
from pulseportraiture_tpu.io.mjd import MJD  # noqa: E402
from pulseportraiture_tpu.models import gaussian as jg  # noqa: E402
from pulseportraiture_tpu.models import gmodel_io as jio  # noqa: E402
from pulseportraiture_tpu.ops import gaussian as jog  # noqa: E402
from pulseportraiture_tpu.pipelines.toas import \
    GetTOAs as JGetTOAs  # noqa: E402
from pulseportraiture_tpu_torch.fitters import powlaw as tpl  # noqa: E402
from pulseportraiture_tpu_torch.models import gaussian as tg  # noqa: E402
from pulseportraiture_tpu_torch.models import gmodel_io as tio  # noqa: E402
from pulseportraiture_tpu_torch.ops import gaussian as tog  # noqa: E402
from pulseportraiture_tpu_torch.pipelines.toas import GetTOAs  # noqa: E402
from pulseportraiture_tpu_torch.sim.fake import \
    make_fake_pulsar  # noqa: E402

from torch_parity_utils import mjd_diff_s  # noqa: E402

torch.set_num_threads(2)
NCHAN, NBIN, P = 32, 256, 0.003
FREQS = np.linspace(1100.0, 1900.0, NCHAN)
PHASES = (np.arange(NBIN) + 0.5) / NBIN
TRUTH = np.array([0.0, 0.0, 0.4, 0.0, 0.05, -0.4, 5.0, -1.6,
                  0.47, 0.01, 0.02, 0.1, 2.0, -1.0])
JOINS = (np.arange(0, 10), np.arange(10, NCHAN))


def rel(got, want):
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want)) /
                 np.max(np.abs(want)))


def same_fit(got, want, keys=("fitted_params",)):
    """Parameters within 1e-6 of their errors, errors 1e-6 relative,
    chi2 1e-9 relative."""
    e = np.asarray(want.fit_errs)
    m = e > 0
    assert m.sum() >= 3
    for k in keys:
        d = np.abs(np.asarray(got[k]) - np.asarray(want[k]))
        assert np.max(d[m] / e[m]) <= 1e-6, k
    assert np.max(np.abs(np.asarray(got.fit_errs) - e)[m] / e[m]) <= 1e-6
    assert abs(got.chi2 - float(want.chi2)) <= 1e-9 * float(want.chi2)


@pytest.mark.parametrize("case", ["plain", "scattered", "joins",
                                  "scattered_joins", "code111"])
def test_generated_portraits_match_jax(case):
    p = TRUTH.copy()
    code = "111" if case == "code111" else "000"
    if code == "111":
        p[[3, 5, 7, 9, 11, 13]] = [1e-5, 2e-5, -1e-3, 1e-5, 0.0, -2e-3]
    if "scattered" in case:
        p[1] = 3.0
    joins = JOINS if "joins" in case else ()
    if joins:
        p = np.concatenate([p, [0.0, 0.0, 0.01, 2e-4]])
    want = jg.gen_gaussian_portrait(code, jnp.asarray(p), -4.0, PHASES,
                                    FREQS, 1500.0, join_ichans=joins, P=P)
    got = tg.gen_gaussian_portrait(code, p, -4.0, PHASES, FREQS, 1500.0,
                                   join_ichans=joins, P=P)
    assert got.dtype == torch.float64 and rel(got, want) <= 1e-12
    prof = [0.1, p[1], 0.3, 0.05, 1.0, 0.62, 0.01, 0.5]
    assert rel(tg.gen_gaussian_profile(prof, NBIN),
               jg.gen_gaussian_profile(jnp.asarray(prof), NBIN)) <= 1e-12


@pytest.mark.parametrize("fit_scattering", [False, True])
def test_profile_fit_matches_jax(fit_scattering):
    rng = np.random.default_rng(3)
    truth = [0.2, 2.0 if fit_scattering else 0.0, 0.3, 0.05, 1.0,
             0.45, 0.02, 0.5]
    data = tg.gen_gaussian_profile(truth, NBIN).numpy() + \
        rng.normal(0.0, 0.02, NBIN)
    init = np.array(truth) * 1.03
    init[1] = 1.0 if fit_scattering else 0.0
    want = jg.fit_gaussian_profile(jnp.asarray(data), jnp.asarray(init),
                                   0.02, fit_scattering=fit_scattering)
    got = tg.fit_gaussian_profile(torch.as_tensor(data), init, 0.02,
                                  fit_scattering=fit_scattering)
    same_fit(got, want)
    assert rel(got.residuals, want.residuals) <= 1e-9


@pytest.mark.parametrize("case", ["joins", "scattering_alpha"])
def test_portrait_fit_matches_jax(case):
    rng = np.random.default_rng(1)
    truth = TRUTH.copy()
    if case == "joins":
        jp = np.array([0.0, 0.0, 0.01, 1e-4])
        model = tg.gen_gaussian_portrait("000", np.r_[truth, jp], -4.0,
                                         PHASES, FREQS, 1500.0,
                                         join_ichans=JOINS, P=P).numpy()
        join = (JOINS, jp * 0.5, [0, 0, 1, 1])
        flags = np.ones(len(truth))
        flags[1] = 0
        alpha, fit_alpha = -4.0, False
    else:
        truth[1] = 2.0
        model = tg.gen_gaussian_portrait("000", truth, -3.5, PHASES, FREQS,
                                         1500.0).numpy()
        join = ()
        flags = np.ones(len(truth))
        alpha, fit_alpha = -4.0, True
    data = model + rng.normal(0.0, 0.05, model.shape)
    init = truth * 1.02
    init[1] = truth[1] * 0.8
    errs = np.full(NCHAN, 0.05)
    want = jg.fit_gaussian_portrait("000", data, init, alpha, errs, flags,
                                    fit_alpha, PHASES, FREQS, 1500.0,
                                    join_params=join, P=P)
    got = tg.fit_gaussian_portrait("000", torch.as_tensor(data), init,
                                   alpha, errs, flags, fit_alpha, PHASES,
                                   FREQS, 1500.0, join_params=join, P=P)
    same_fit(got, want)
    if fit_alpha:
        e = want.scattering_index_err
        assert abs(got.scattering_index - want.scattering_index) <= 1e-6 * e
        assert abs(got.scattering_index_err - e) <= 1e-6 * e


def test_powlaw_matches_jax():
    rng = np.random.default_rng(8)
    flux = 2.0 * (FREQS / 1500.0) ** -1.7 + rng.normal(0.0, 0.05, NCHAN)
    errs = np.full(NCHAN, 0.05)
    want = jpl.fit_powlaw(flux, [1.0, 0.0], errs, FREQS, 1500.0)
    got = tpl.fit_powlaw(flux, [1.0, 0.0], errs, FREQS, 1500.0)
    for k in ("alpha", "amp"):
        assert abs(got[k] - want[k]) <= 1e-6 * want[k + "_err"]
        assert abs(got[k + "_err"] - want[k + "_err"]) <= \
            1e-6 * want[k + "_err"]
    assert abs(got.chi2 - want.chi2) <= 1e-9 * want.chi2
    resid = 1e-4 * FREQS ** -2 + rng.normal(0.0, 1e-12, NCHAN) - 3e-11
    jd = jpl.fit_DM_to_freq_resids(FREQS, resid, np.full(NCHAN, 1e-12))
    td = tpl.fit_DM_to_freq_resids(FREQS, resid, np.full(NCHAN, 1e-12))
    for k in ("DM", "DM_err", "offset", "nu_ref", "chi2"):
        assert td[k] == pytest.approx(jd[k], rel=1e-12, abs=0.0)
    for alpha in (-1.0, -1.6):
        assert tpl.powlaw_integral(1900.0, 1100.0, 1500.0, 2.0, alpha) == \
            pytest.approx(jpl.powlaw_integral(1900.0, 1100.0, 1500.0, 2.0,
                                              alpha), rel=1e-14)
        for mid in (False, True):
            assert np.allclose(tpl.powlaw_freqs(1100, 1900, 8, alpha, mid),
                               jpl.powlaw_freqs(1100, 1900, 8, alpha, mid),
                               rtol=1e-14, atol=0)
    assert tpl.powlaw(1400.0, 1500.0, 2.0, -1.6) == \
        jpl.powlaw(1400.0, 1500.0, 2.0, -1.6)


@pytest.mark.parametrize("wids,types,DM", [
    ((), (), 30.0), ((0.01,), ("rect",), 0.0),
    ((0.01, 0.004), ("rect", "gauss"), 30.0)])
def test_instrumental_response_matches_jax(wids, types, DM):
    want = np.asarray(jog.instrumental_response_port_FT(
        NBIN, FREQS, DM, P, wids, types))
    got = tog.instrumental_response_port_FT(NBIN, FREQS, DM, P, wids, types)
    assert np.max(np.abs(got - want)) <= 1e-12
    assert np.array_equal(tog.instrumental_response_FT(NBIN, 0.0),
                          np.ones(NBIN // 2 + 1))


def test_write_model_matches_jax(tmp_path):
    a, b = str(tmp_path / "port.gmodel"), str(tmp_path / "jax.gmodel")
    flags = [1] * len(TRUTH)
    tio.write_model(a, "M", "000", 1500.0, TRUTH, flags, -4.0, 0, quiet=True)
    jio.write_model(b, "M", "000", 1500.0, TRUTH, flags, -4.0, 0, quiet=True)
    with open(a) as fa, open(b) as fb:
        assert fa.read() == fb.read()
    assert np.array_equal(jio.read_model(a)[4], TRUTH)


def test_add_instrumental_response_toas_match_jax(tmp_path):
    par = tmp_path / "t.par"
    par.write_text("PSR J1234-5678\nRAJ 01:02:03.4\nDECJ -04:05:06.7\n"
                   "F0 345.6789\nPEPOCH 50000\nDM 34.56789\n")
    gm = str(tmp_path / "t.gmodel")
    tio.write_model(gm, "T", "000", 1500.0, TRUTH, [1] * len(TRUTH), -4.0,
                    0, quiet=True)
    arch = str(tmp_path / "a.fits")
    make_fake_pulsar(gm, str(par), outfile=arch, nsub=2, nchan=NCHAN,
                     nbin=NBIN, tsub=60.0, dDM=2e-4, noise_stds=0.3,
                     start_MJD=MJD(57000.0), quiet=True,
                     rng=np.random.default_rng(4))
    ird = {"DM": 34.56789, "wids": [0.004], "irf_types": ["rect"]}
    want = JGetTOAs([arch], gm, quiet=True)
    want.ird.update(ird)
    want.get_TOAs(quiet=True, add_instrumental_response=True)
    got = GetTOAs([arch], gm, device="cpu", dtype=torch.float64, quiet=True)
    got.ird.update(ird)
    got.get_TOAs(quiet=True, add_instrumental_response=True,
                 method="Newton-CG", bounds=[(None, None)] * 5)
    plain = GetTOAs([arch], gm, device="cpu", dtype=torch.float64,
                    quiet=True)
    plain.get_TOAs(quiet=True)
    assert len(got.TOA_list) == len(want.TOA_list) == 2
    for a, b, c in zip(got.TOA_list, want.TOA_list, plain.TOA_list):
        assert abs(mjd_diff_s(a.MJD, b.MJD)) < 1e-9
        assert abs(a.DM - b.DM) <= 1e-6 * b.DM_error
        # the response moved the TOA (this is not the plain fit)
        assert abs(mjd_diff_s(a.MJD, c.MJD)) > 1e-9
