"""Port parity: the scattering slice against the JAX package.

ops.scattering, ops.moments.scattering_moments (its plain twin on the
CPU), the scattering half of fitters.stats, the scattering nu_zeros
branches, and GetTOAs(fit_scat=True) with the pptoas --fit_scat flags.

Tolerances:
  * scattering moments, float32: the JAX Pallas kernel in interpret mode
    (natural, kvec and CT layouts) factors the phasor while the twin
    evaluates it per harmonic: within 2e-6 of sum_k |summand_k| (f64).
    float64: against the JAX plain reference at 1e-12 relative.
  * stats, float64 (PARITY.md): objective 1e-12, gradient 1e-10,
    Hessian 1e-9, Woodbury covariance 1e-8, nu_zeros 1e-9.
  * GetTOAs(fit_scat=True): both packages fit in float64 but seed
    differently, and the JAX package's epilogue (zero-covariance
    frequencies, covariance) reads the moments of the last verified
    Newton point, which trails the speculative final step: the JAX
    package against itself from two starting taus differs by 1.8e-6
    sigma in log10 tau and 1.5e-7 relative in the covariance.  So TOAs,
    DMs and taus agree within 1e-5 of their errors, errors and
    reference frequencies within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from pulseportraiture_tpu.fitters import nu_zeros as jnz  # noqa: E402
from pulseportraiture_tpu.fitters import stats as jstats  # noqa: E402
from pulseportraiture_tpu.io.mjd import MJD  # noqa: E402
from pulseportraiture_tpu.models.gmodel_io import write_model  # noqa: E402
from pulseportraiture_tpu.ops import ct_dft as jct  # noqa: E402
from pulseportraiture_tpu.ops import pallas_moments as jpm  # noqa: E402
from pulseportraiture_tpu.ops import scattering as jsc  # noqa: E402
from pulseportraiture_tpu.pipelines.toas import \
    GetTOAs as JGetTOAs  # noqa: E402
from pulseportraiture_tpu.sim.fake import make_fake_pulsar  # noqa: E402
from pulseportraiture_tpu_torch.config import DCONST  # noqa: E402
from pulseportraiture_tpu_torch.fitters import nu_zeros, stats  # noqa: E402
from pulseportraiture_tpu_torch.fitters.portrait import (  # noqa: E402
    fit_portrait_full_batch, template_spectrum)
from pulseportraiture_tpu_torch.io.tim import write_TOAs  # noqa: E402
from pulseportraiture_tpu_torch.ops import moments as mom  # noqa: E402
from pulseportraiture_tpu_torch.ops import scattering as sc  # noqa: E402
from pulseportraiture_tpu_torch.ops.setup_dft import (  # noqa: E402
    band_cap_model_ft, cap_nharm)
from pulseportraiture_tpu_torch.ops.transform import \
    phase_transform  # noqa: E402
from pulseportraiture_tpu_torch.pipelines import toas  # noqa: E402

from torch_parity_utils import (injected_batch, mjd_diff_s,  # noqa: E402
                                rel_err, t64)

torch.set_num_threads(2)


def test_scattering_ops_match_jax():
    rng = np.random.default_rng(11)
    freqs = np.linspace(1100.0, 1900.0, 16)
    taus = np.abs(rng.normal(0.0, 0.02, 16))
    taus[3] = 0.0                              # no scattering: B = 1
    got = sc.scattering_times(t64(0.01), t64(-3.9), t64(freqs), 1500.0)
    want = jsc.scattering_times(0.01, -3.9, jnp.asarray(freqs), 1500.0)
    assert rel_err(got, want) < 1e-14
    want = np.asarray(jsc.scattering_portrait_FT(jnp.asarray(taus), 128))
    got = sc.scattering_portrait_FT(t64(taus), 128)
    assert got.dtype == torch.complex128 and got.shape == (16, 65)
    assert rel_err(got.real, want.real) < 1e-14
    assert rel_err(got.imag, want.imag) < 1e-14
    assert rel_err(sc.scattering_portrait_FT_np(taus, 128), want) < 1e-14
    assert bool((got[3] == 1.0).all())
    br, bi = sc.scattering_profile_FT_ri(t64(taus), 128)
    jbr, jbi = jsc.scattering_portrait_FT_ri(jnp.asarray(taus), 128)
    assert rel_err(br, jbr) < 1e-14 and rel_err(bi, jbi) < 1e-14
    p = sc.scattering_profile_FT(0.013, 64)
    # (a float64 array input: the JAX scalar form computes in complex64)
    jp = np.asarray(jsc.scattering_portrait_FT(jnp.asarray([0.013]), 64))[0]
    assert rel_err(p.real, jp.real) < 1e-14
    assert rel_err(p.imag, jp.imag) < 1e-14


def _moment_inputs(nchan, nharm, seed):
    rng = np.random.default_rng(seed)
    freqs = np.linspace(1100.0, 1900.0, nchan)
    phis = rng.uniform(-3.0, 3.0, nchan)
    taus = 8e-3 * (freqs / 1500.0) ** -4.0 * 10.0 ** rng.uniform(-1, 1,
                                                                  nchan)
    Gr = rng.normal(size=(nchan, nharm))
    Gi = rng.normal(size=(nchan, nharm))
    M2 = np.abs(rng.normal(size=(nchan, nharm)))
    return phis, taus, Gr, Gi, M2


@pytest.mark.parametrize("nharm,layout", [(64, "natural"),
                                          (200, "natural"),
                                          (257, "natural"),
                                          (200, "kvec"), (257, "ct")])
def test_scattering_moments_float32_matches_jax_kernel(nharm, layout):
    f64 = _moment_inputs(40, nharm, nharm)
    phis, taus, Gr, Gi, M2 = (a.astype(np.float32) for a in f64)
    n0 = mom.scattering_moments.launches
    got = mom.scattering_moments(*(torch.from_numpy(a)
                                   for a in (phis, taus, Gr, Gi, M2)))
    assert mom.scattering_moments.launches == n0   # CPU: the twin
    kw = {}
    if layout == "kvec":
        perm = np.random.default_rng(3).permutation(nharm)
        kw = dict(kvec=jnp.asarray(perm, jnp.float32))
    elif layout == "ct":
        perm = jct.ct_perm_np(2 * (nharm - 1))
        kw = dict(kvec=jnp.asarray(perm, jnp.float32))
    else:
        perm = np.arange(nharm)
    want = jpm.scattering_moments(
        jnp.asarray(phis), jnp.asarray(taus), jnp.asarray(Gr[:, perm]),
        jnp.asarray(Gi[:, perm]), jnp.asarray(M2[:, perm]),
        interpret=True, **kw)
    bound = mom.scattering_moments_reference(
        *(torch.from_numpy(a.astype(np.float64))
          for a in (phis, taus, Gr, Gi, M2)), absolute=True)
    for name, g, w, b in zip(stats.SCAT_NAMES, got, want, bound):
        assert g.dtype == torch.float32 and g.shape == (40,)
        err = np.abs(g.double().numpy() - np.asarray(w, np.float64))
        assert np.all(err <= 2e-6 * b.numpy()), (name, err.max())


def test_scattering_moments_float64_matches_jax_reference():
    phis, taus, Gr, Gi, M2 = _moment_inputs(3 * 17, 200, 9)
    Gr, Gi = Gr.reshape(3, 17, 200), Gi.reshape(3, 17, 200)
    phis, taus = phis.reshape(3, 17), taus.reshape(3, 17)
    M2 = M2[:17]                               # shared by the 3 items
    got = mom.scattering_moments(*(torch.from_numpy(a)
                                   for a in (phis, taus, Gr, Gi, M2)))
    want = jpm._scat_terms_ref(jnp.asarray(phis), jnp.asarray(taus),
                               jnp.asarray(Gr), jnp.asarray(Gi),
                               jnp.asarray(M2), jnp.arange(200.0))
    for name, g, w in zip(stats.SCAT_NAMES, got, want):
        assert g.shape == (3, 17)
        assert rel_err(g, w) < 1e-12, name


def _setups(nchan=24, nbin=256, seed=3):
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


_TAU_MODES = {"log10": (True, np.log10(3e-3)), "linear": (False, 3e-3),
              "linear_tau0": (False, 0.0)}


@pytest.mark.parametrize("mode", sorted(_TAU_MODES))
@pytest.mark.parametrize("fit_flags", [(1, 1, 0, 1, 0), (1, 1, 0, 1, 1),
                                       (1, 1, 1, 1, 1), (0, 0, 0, 1, 1)])
def test_scattering_value_grad_hess_and_covariance_match_jax(mode,
                                                             fit_flags):
    js, ts = _setups()
    log10_tau, x_tau = _TAU_MODES[mode]
    p = np.array([0.0061, -1.7e-4, 2e-7, x_tau, -3.7])
    jf, jg, jH, jm = jstats.chi2_value_grad_hess(
        jnp.asarray(p), js, fit_flags=fit_flags, log10_tau=log10_tau,
        scattering=True, return_moments=True, use_pallas=False)
    f, g, H, m = stats.chi2_value_grad_hess(
        t64(p), ts, fit_flags=fit_flags, log10_tau=log10_tau,
        scattering=True)
    assert rel_err(f, jf) < 1e-12
    assert rel_err(g, jg) < 1e-10
    assert rel_err(H, jH) < 1e-9
    for name in stats.SCAT_NAMES + ("taus", "dtau", "d2tau"):
        assert rel_err(m[name], jm[name]) < 1e-12, name
    if x_tau == 0.0:
        # linear tau at tau == 0: the tau derivatives are exactly zero
        assert bool((m["dtau"][0] == 0.0).all())
        assert bool((m["d2tau"][0, 1] == 0.0).all())
    Hn = stats.hess_per_channel_from_moments(m, ts, fit_flags)
    jHn = jstats.hess_per_channel_from_moments(jm, js, fit_flags)
    assert rel_err(Hn, jHn) < 1e-9
    # Woodbury covariance at output references, moments rebased there
    p_out = p.copy()
    p_out[3] = x_tau + 0.01 if log10_tau else x_tau * 1.02
    ts_out = ts._replace(nu_DM=t64(1350.0), nu_GM=t64(1350.0),
                         nu_tau=t64(1425.0))
    js_out = js._replace(nu_DM=jnp.asarray(1350.0),
                         nu_GM=jnp.asarray(1350.0),
                         nu_tau=jnp.asarray(1425.0))
    got = stats._covariance_core(
        stats.rebase_moments(m, ts_out, t64(p_out), log10_tau), ts_out,
        fit_flags)
    want = jstats.covariance_with_scales_from_moments(
        jstats.rebase_moments(jm, jnp.asarray(p_out), js_out, log10_tau),
        js_out, fit_flags)
    if x_tau == 0.0 and fit_flags[3]:
        # the tau row vanishes: no covariance (NaN here, non-finite there)
        assert bool(torch.isnan(got[0]).all())
        assert not np.isfinite(np.asarray(want[0])).all()
        got, want = got[2:], want[2:]            # scales, their errors, S
        got, want = (got[0], got[2]), (want[0], want[2])
    for a, b in zip(got, want):
        assert rel_err(a, b) < 1e-8
    s, S = stats.get_scales(t64(p), ts, log10_tau=log10_tau,
                            scattering=True)
    js_, jS = jstats.get_scales(jnp.asarray(p), js, log10_tau=log10_tau)
    assert rel_err(s, js_) < 1e-12 and rel_err(S, jS) < 1e-12


@pytest.mark.parametrize("fit_flags", [(0, 0, 0, 1, 1), (1, 1, 0, 1, 0),
                                       (1, 1, 0, 1, 1), (1, 1, 1, 1, 1)])
@pytest.mark.parametrize("log10_tau", [True, False])
def test_scattering_nu_zeros_match_jax(fit_flags, log10_tau):
    js, ts = _setups(seed=4)
    x_tau = np.log10(3e-3) if log10_tau else 3e-3
    p = np.array([0.0061, -1.7e-4, 0.0, x_tau, -3.7])
    _, _, _, jm = jstats.chi2_value_grad_hess(
        jnp.asarray(p), js, log10_tau=log10_tau, scattering=True,
        return_moments=True, use_pallas=False)
    _, _, _, m = stats.chi2_value_grad_hess(t64(p), ts, log10_tau=log10_tau,
                                            scattering=True)
    want = jnz.get_nu_zeros(jnp.asarray(p), js, fit_flags=fit_flags,
                            log10_tau=log10_tau, moments=jm)
    got = nu_zeros.get_nu_zeros(ts, fit_flags, m, params=t64(p),
                                log10_tau=log10_tau)
    for a, b in zip(got, want):
        assert rel_err(a, b) < 1e-9
    solved = {(0, 0, 0, 1, 1): (2,), (1, 1, 0, 1, 0): (0,)}.get(
        fit_flags, (0, 2))
    for j in solved:                           # a frequency was solved
        assert abs(float(got[j]) - float(ts[6 + j])) > 1e-3


@pytest.mark.parametrize("log10_tau", [True, False])
def test_rereference_transports_tau_as_jax(log10_tau):
    """(phi, tau) moved to other references as the JAX package moves
    them; in log10, a transported tau <= 0 is -inf, not NaN."""
    from pulseportraiture_tpu.fitters.portrait import \
        _rereference as jreref
    from pulseportraiture_tpu_torch.fitters.portrait import _rereference
    js, ts = _setups(seed=5)
    x_taus = ([np.log10(3e-3), -np.inf] if log10_tau else [3e-3, 0.0, -1e-3])
    for x_tau in x_taus:
        p = np.array([0.31, -1.7e-4, 2e-7, x_tau, -3.7])
        want = np.asarray(jreref(jnp.asarray(p), js, 1350.0, 1420.0, 1425.0,
                                 log10_tau))
        got = _rereference(t64(p), ts, t64(1350.0), t64(1420.0),
                           t64(1425.0), log10_tau).numpy()
        assert not np.isnan(got).any()
        assert np.array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        assert rel_err(got[fin], want[fin]) < 1e-14
        if log10_tau and x_tau == -np.inf:
            assert got[3] == -np.inf


@pytest.mark.parametrize("noise", [0.1, 0.01])
def test_float32_capped_scattering_fit_agrees_with_float64(noise):
    """The float32 route (band-capped template spectrum, double-single
    phasor) stays within 1e-2 sigma of the float64 full-band fit in every
    fitted parameter, with tau and alpha fitted, compared at the float64
    fit's references.  At noise 0.01 (the S/N of a 4096 x 2048 portrait
    at noise 0.1) a float32 eigh of the trust-region subproblem and the
    loop's float32 stopping rules ended seed 0 ~5 sigma short in alpha:
    the port solves the subproblem in float64 and gates those stops on
    the Newton decrement (fitters/newton.py, DEC_TOL)."""
    d = injected_batch(B=4, nchan=64, nbin=512, seed=0 if noise < 0.1 else 2,
                       tau=8e-3, noise=noise)
    B = 4
    init = np.zeros((B, 5))
    init[:, 3], init[:, 4] = np.log10(4e-3), -4.0

    def fit(data, mft, dt):
        return fit_portrait_full_batch(
            torch.from_numpy(data), mft, torch.as_tensor(init, dtype=dt),
            t64(np.full(B, d["P"])), t64(d["freqs"]), t64(d["errs"]),
            nu_fits=t64(d["nu_fits"]), fit_flags=(1, 1, 0, 1, 1),
            log10_tau=True, dtype=dt)

    ref = fit(d["data"], template_spectrum(d["model"]), torch.float64)
    mr, mi = template_spectrum(d["model"].astype(np.float32))
    mr_c, mi_c, mh = band_cap_model_ft(mr, mi, 512)
    nh = cap_nharm(512, mh)
    assert nh < 257
    got = fit(d["data"].astype(np.float32), (mr_c[:, :nh], mi_c[:, :nh]),
              torch.float32)
    assert got.params.dtype == torch.float32
    assert bool((got.return_code < 3).all())
    # phi to the float64 fit's nu_DM, log10 tau to its nu_tau
    p = got.params.double().clone()
    p[:, 0] = phase_transform(p[:, 0], p[:, 1], got.nu_DM.double(),
                              ref.nu_DM, t64(np.full(B, d["P"])))
    p[:, 3] = p[:, 3] + p[:, 4] * torch.log10(ref.nu_tau /
                                              got.nu_tau.double())
    for j in (0, 1, 3, 4):
        dp = (p[:, j] - ref.params[:, j]).abs()
        assert bool((dp <= 1e-2 * ref.param_errs[:, j]).all()), (j, dp)
    # the injection (8e-3 rot at nu_fit) recovered: log10 tau transported
    # from nu_tau, where tau and alpha do not covary, to nu_fit
    lr = torch.log10(t64(d["nu_fit"]) / ref.nu_tau)
    x_fit = ref.params[:, 3] + ref.params[:, 4] * lr
    sig = torch.sqrt(ref.param_errs[:, 3] ** 2 +
                     (ref.param_errs[:, 4] * lr) ** 2)
    z = (x_fit - np.log10(8e-3)) / sig
    assert bool((z.abs() < 5.0).all()), z


PAR_LINES = [
    "PSR             J1234-5678",
    "RAJ      01:02:03.45678901  1",
    "DECJ     -04:05:06.7890123  1",
    "F0      345.67890123456789  1",
    "PEPOCH        50000.000000",
    "DM                34.56789",
]
MODEL_PARAMS = [0.0, 0.0,
                0.2193, -0.0052, 0.0482, -2.08, 5.13, -1.66,
                0.2341, -0.0027, 0.0157, 1.615, 9.46, -2.08]
NCHAN, NBIN = 32, 256
T_SCAT = 3e-5                 # [s] at 1500 MHz, about 0.01 rot


@pytest.fixture(scope="module")
def scat_ws(tmp_path_factory):
    ws = tmp_path_factory.mktemp("torch_scattering")
    par = str(ws / "test.par")
    with open(par, "w") as f:
        f.write("\n".join(PAR_LINES) + "\n")
    gmodel = str(ws / "test.gmodel")
    write_model(gmodel, "TEST", "000", 1500.0, MODEL_PARAMS,
                [1] * len(MODEL_PARAMS), -4.0, 0, quiet=True)
    rng = np.random.default_rng(77)
    files = []
    for i, dDM in enumerate((2e-4, -1e-4)):
        path = str(ws / f"scat-{i}.fits")
        make_fake_pulsar(gmodel, par, outfile=path, nsub=2, npol=1,
                         nchan=NCHAN, nbin=NBIN, nu0=1500.0, bw=800.0,
                         tsub=60.0, dDM=dDM, start_MJD=MJD(57300.0 + 10 * i),
                         noise_stds=0.1, dedispersed=False, t_scat=T_SCAT,
                         alpha=-4.0, quiet=True, rng=rng)
        files.append(path)
    tmpl = str(ws / "template.fits")          # unscattered, noiseless
    make_fake_pulsar(gmodel, par, outfile=tmpl, nsub=1, npol=1,
                     nchan=NCHAN, nbin=NBIN, nu0=1500.0, bw=800.0,
                     tsub=60.0, start_MJD=MJD(57300.0), noise_stds=0.0,
                     dedispersed=True, quiet=True, dtype="f4",
                     rng=np.random.default_rng(1))
    return dict(files=files, tmpl=tmpl, path=ws)


_SCAT_FLAGS = ("scat_time", "scat_ref_freq", "scat_ind")


@pytest.mark.parametrize("fix_alpha", [True, False])
def test_fit_scat_toas_match_jax(scat_ws, fix_alpha):
    kw = dict(quiet=True, fit_scat=True, fix_alpha=fix_alpha,
              scat_guess=(2e-5, 1500.0, -4.0))
    want = JGetTOAs(scat_ws["files"], scat_ws["tmpl"], quiet=True)
    want.get_TOAs(**kw)
    got = toas.GetTOAs(scat_ws["files"], scat_ws["tmpl"], device="cpu",
                       dtype=torch.float64, quiet=True)
    got.get_TOAs(**kw)
    assert len(got.TOA_list) == len(want.TOA_list) == 4
    for a, b in zip(got.TOA_list, want.TOA_list):
        # each TOA sits at its own zero-covariance frequency (these agree
        # to ~2e-10 relative): compare them transported to one frequency
        dt = mjd_diff_s(a.MJD, b.MJD) + DCONST * b.DM * (
            b.frequency ** -2.0 - a.frequency ** -2.0)
        assert abs(dt) * 1e6 <= 1e-5 * b.TOA_error                 # us
        assert abs(a.frequency - b.frequency) <= 1e-6 * b.frequency
        assert abs(a.TOA_error - b.TOA_error) <= 1e-6 * b.TOA_error
        assert abs(a.DM - b.DM) <= 1e-5 * b.DM_error
        assert abs(a.DM_error - b.DM_error) <= 1e-6 * b.DM_error
        assert set(a.flags) == set(b.flags)
        err = b.flags["log10_scat_time_err"]
        assert abs(a.flags["log10_scat_time"] -
                   b.flags["log10_scat_time"]) <= 1e-5 * err
        assert abs(a.flags["log10_scat_time_err"] - err) <= 1e-6 * err
        for flag in _SCAT_FLAGS + ("snr", "gof"):
            assert abs(a.flags[flag] - b.flags[flag]) <= \
                1e-6 * abs(b.flags[flag]), flag
        if not fix_alpha:
            assert abs(a.flags["scat_ind_err"] - b.flags["scat_ind_err"]) \
                <= 1e-6 * b.flags["scat_ind_err"]
    for name in ("taus", "tau_errs", "alphas", "alpha_errs"):
        g, w = np.concatenate(getattr(got, name)), \
            np.concatenate(getattr(want, name))
        assert np.allclose(g, w, rtol=1e-5, atol=0.0), name
    # scattering recovered: tau at 1500 MHz within 3 sigma of T_SCAT
    for t in got.TOA_list:
        tau_1500 = t.flags["scat_time"] * 1e-6 * (
            1500.0 / t.flags["scat_ref_freq"]) ** t.flags["scat_ind"]
        lerr = t.flags["log10_scat_time_err"]
        assert abs(np.log10(tau_1500 / T_SCAT)) <= 3 * lerr + 0.01


def test_pptoas_fit_scat_writes_the_flags(scat_ws):
    from pulseportraiture_tpu_torch.cli import pptoas
    tim = str(scat_ws["path"] / "scat.tim")
    pptoas.main(["-d", scat_ws["files"][0], "-m", scat_ws["tmpl"], "-o",
                 tim, "--device", "cpu", "--quiet", "--fit_scat",
                 "--fit_alpha", "--scat_guess", "2e-5,1500,-4"])
    with open(tim) as f:
        lines = f.read().splitlines()
    assert len(lines) == 2
    for flag in ("-scat_time", "-log10_scat_time", "-log10_scat_time_err",
                 "-scat_ref_freq", "-scat_ind", "-scat_ind_err"):
        assert all(f" {flag} " in ln for ln in lines), flag
    # linear tau writes scat_time_err instead of the log10 flags
    got = toas.GetTOAs(scat_ws["files"][:1], scat_ws["tmpl"], device="cpu",
                       dtype=torch.float64, quiet=True)
    got.get_TOAs(quiet=True, fit_scat=True, log10_tau=False,
                 scat_guess=(2e-5, 1500.0, -4.0))
    lines = write_TOAs(got.TOA_list, outfile=None)
    assert all(" -scat_time_err " in ln and "log10" not in ln
               for ln in lines)
